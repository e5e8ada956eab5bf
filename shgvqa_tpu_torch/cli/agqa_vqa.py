"""AGQA video-QA driver: the port of ``shgvqa_tpu/cli/agqa_vqa.py``
(reference: ``src/tasks/agqaVQA.py``), the video model without the
hypergraph.

    python -m shgvqa_tpu_torch.cli.agqa_vqa --taskVQA ... [reference flags]

Accepts the reference flags; --taskVQA is implied if no task flag is
given.  Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import sys

from shgvqa_tpu_torch.cli.common import run_driver


def main(argv=None, device="cuda") -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--task") for a in argv):
        argv.append("--taskVQA")
    return run_driver("agqa", argv, device)


if __name__ == "__main__":
    main()

"""STAR driver: the port of ``shgvqa_tpu/cli/star.py`` (reference:
``src/tasks/star.py``), the 4-way multiple-choice STAR benchmark.

    python -m shgvqa_tpu_torch.cli.star --taskHGQA --useHGMask \
        --qType Interaction --qaArrangeType add_sep_all --batchSize 8 ...

(``README.md``'s STAR command: the capsule encoder; ``--noCaps`` runs the
conv tokenizer.)

Accepts the reference flags; --taskHGQA is implied if no task flag is
given.  Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import sys

from shgvqa_tpu_torch.cli.common import run_driver


def main(argv=None, device="cuda") -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--task") for a in argv):
        argv.append("--taskHGQA")
    return run_driver("star", argv, device)


if __name__ == "__main__":
    main()

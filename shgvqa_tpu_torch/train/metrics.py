"""Structured metrics and profiling: the port of
``shgvqa_tpu/train/metrics.py``.

``MetricWriter`` appends one JSON record per logged step to
``{output}/metrics.jsonl`` and mirrors every log line to stdout and
``{output}/log.log``, in the JAX package's formats.  ``Profiler`` captures
a ``torch.profiler`` trace of ``trace_steps`` steps from ``start_step`` into
``{output}/profile`` (off by default, as in JAX).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl",
                 also_log_file: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self.log_path = os.path.join(output_dir, "log.log")
        self._log = (
            open(self.log_path, "a", buffering=1) if also_log_file else None
        )

    def write(self, step: int, metrics: Dict[str, float], **extra) -> None:
        rec = {"step": step, "time": time.time(), **metrics, **extra}
        self._f.write(json.dumps(rec) + "\n")

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        if self._log is not None:
            self._log.write(msg + "\n")

    def close(self) -> None:
        self._f.close()
        if self._log is not None:
            self._log.close()


class Profiler:
    """Capture a ``torch.profiler`` trace (CPU and, on a card, CUDA
    activity) for ``trace_steps`` steps starting at ``start_step``; writes
    ``{output}/profile/trace.json`` (Chrome trace format)."""

    def __init__(self, output_dir: str, start_step: int = 10,
                 trace_steps: int = 5, enabled: bool = False):
        self.dir = os.path.join(output_dir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + trace_steps
        self.enabled = enabled
        self._prof = None

    def step(self, step: int) -> None:
        if not self.enabled:
            return
        import torch

        if step == self.start_step and self._prof is None:
            os.makedirs(self.dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif step >= self.stop_step and self._prof is not None:
            self.close()
            self.enabled = False

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof.export_chrome_trace(os.path.join(self.dir,
                                                        "trace.json"))
            self._prof = None

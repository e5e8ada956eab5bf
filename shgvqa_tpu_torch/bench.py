"""Benchmark of the port: flagship HGQA inference, uint8 frames -> answer,
in clips/s on one CUDA card, printed as one JSON line.

    python -m shgvqa_tpu_torch.bench

Protocol: the inputs (two batches of 32 clips from different seeds) are
staged on the card once, two forwards warm it up, then ten forwards are
enqueued and timed on the host clock up to ``torch.cuda.synchronize()``.
The line carries the card's name and power limit.  It needs a CUDA card:
with none it raises.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Dict, List

import torch

from shgvqa_tpu_torch.entry import (
    build_model,
    device_batch,
    flagship_cfg,
    resolve_device,
)

BATCH_SIZE = 32


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clips_per_second(model, batches: List[Dict[str, torch.Tensor]],
                     iters: int = 10, warmup: int = 2) -> float:
    """Clips/s of ``model`` over ``batches`` (staged on the card)."""
    with torch.inference_mode():
        for i in range(warmup):
            model(batches[i % len(batches)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            model(batches[i % len(batches)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return batches[0]["frames"].shape[0] * iters / dt


def main() -> None:
    dev = resolve_device("cuda")
    cfg = flagship_cfg()
    model = build_model(cfg, dev)
    batches = [device_batch(cfg, BATCH_SIZE, seed, dev) for seed in (0, 1)]
    cps = clips_per_second(model, batches)
    print(json.dumps({
        "metric": f"clips/s (uint8 frames->answer, HGQA b{BATCH_SIZE}, "
                  "bf16 trunk, fused FFN kernel)",
        "value": cps,
        "unit": "clips/s",
        "card": card_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()

"""Benchmark of the port on one CUDA card, printed as one JSON line: flagship
HGQA inference (uint8 frames -> answer) in clips/s, or with ``--train`` the
flagship train step in clips/s.

    python -m shgvqa_tpu_torch.bench [--train]

Inference protocol: the inputs (two batches of 32 clips from different
seeds) are staged on the card once, two forwards warm it up, then ten
forwards are enqueued and timed on the host clock up to
``torch.cuda.synchronize()``.

Train protocol (``--train``): ``entry.train_entry()`` at B=32 (dropout on,
the fused attention kernels at every training attention site); two steps
warm up, then five steps are timed on the host clock up to
``torch.cuda.synchronize()``.  ``split_ms`` is the device time of each part
of a step (CUDA events around the same calls ``train.step`` makes; the
trunk by hooks on it), mean over five more steps.

The line carries the card's name and power limit.  It needs a CUDA card:
with none it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, List

import torch

from shgvqa_tpu_torch.entry import (
    build_model,
    device_batch,
    flagship_cfg,
    resolve_device,
    train_entry,
)
from shgvqa_tpu_torch.train.step import compute_losses, make_train_step

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


def train_clips_per_second(step: Callable, batch: Dict[str, torch.Tensor],
                           generator: torch.Generator, iters: int = 5,
                           warmup: int = 2) -> float:
    """Clips/s of ``step(batch, generator)`` (a train step)."""
    for _ in range(warmup):
        step(batch, generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch, generator)
    torch.cuda.synchronize()
    return batch["frames"].shape[0] * iters / (time.perf_counter() - t0)


def train_split_ms(model, optimizer, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, iters: int = 5
                   ) -> Dict[str, float]:
    """Device ms of each part of a train step: the frozen trunk, the rest of
    the forward, the losses (matching included), the backward and the
    optimizer update; mean over ``iters`` steps."""
    cfg = model.cfg
    names = ("start", "trunk_in", "trunk_out", "forward", "losses",
             "backward", "optimizer")
    marks = [{n: torch.cuda.Event(enable_timing=True) for n in names}
             for _ in range(iters)]
    cur = {}
    hooks = [model.backbone.register_forward_pre_hook(
                 lambda *_: cur["m"]["trunk_in"].record()),
             model.backbone.register_forward_hook(
                 lambda *_: cur["m"]["trunk_out"].record())]
    try:
        model.train()
        for m in marks:
            cur["m"] = m
            m["start"].record()
            outputs = model(batch, generator)
            m["forward"].record()
            loss, _ = compute_losses(cfg, outputs, batch)
            m["losses"].record()
            optimizer.zero_grad()
            loss.backward()
            m["backward"].record()
            optimizer.step()
            m["optimizer"].record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()

    def ms(start, end):
        return sum(m[start].elapsed_time(m[end]) for m in marks) / iters

    trunk = ms("trunk_in", "trunk_out")
    return {"trunk": trunk, "forward (rest)": ms("start", "forward") - trunk,
            "losses": ms("forward", "losses"),
            "backward": ms("losses", "backward"),
            "optimizer": ms("backward", "optimizer"),
            "step": ms("start", "optimizer")}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="clips/s on one card")
    parser.add_argument("--train", action="store_true",
                        help="time the flagship train step instead")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    if args.train:
        model, optimizer, generator, batch = train_entry(dev, BATCH_SIZE)
        step = make_train_step(model.cfg, model, optimizer)
        cps = train_clips_per_second(step, batch, generator)
        line = {
            "metric": f"clips/s (train step: uint8 frames->losses->BertAdam, "
                      f"HGQA b{BATCH_SIZE}, bf16, frozen trunk, fused "
                      "attention kernels)",
            "value": cps, "unit": "clips/s",
            "split_ms": train_split_ms(model, optimizer, batch, generator)}
    else:
        cfg = flagship_cfg()
        model = build_model(cfg, dev)
        batches = [device_batch(cfg, BATCH_SIZE, seed, dev)
                   for seed in (0, 1)]
        cps = clips_per_second(model, batches)
        line = {
            "metric": f"clips/s (uint8 frames->answer, HGQA b{BATCH_SIZE}, "
                      "bf16 trunk, fused FFN kernel)",
            "value": cps,
            "unit": "clips/s",
        }
    line["card"] = card_name_and_power_limit()
    print(json.dumps(line))


if __name__ == "__main__":
    main()

"""Benchmark of the port on one CUDA card, printed as one JSON line: flagship
HGQA inference (uint8 frames -> answer) in clips/s, or with ``--train`` the
flagship train step in clips/s.

    python -m shgvqa_tpu_torch.bench [--train [--frozen-trunk]
                                      [--steps-per-loop K]]
                                     [--quant-backbone int8]
                                     [--backbone-chunks N]

Inference protocol: the inputs (two batches of 32 clips from different
seeds) are staged on the card once, two forwards warm it up, then ten
forwards are enqueued and timed on the host clock up to
``torch.cuda.synchronize()``.

Train protocol (``--train``): ``entry.train_entry(published=True)`` at
B=32, the published AGQA recipe (the trunk trained, RandAugment on the
device; dropout on, the fused attention kernels at every training
attention site), or with ``--frozen-trunk`` the frozen trunk without
augmentation; two steps warm up, then five steps are timed on the host
clock up to ``torch.cuda.synchronize()``.  ``split_ms`` is the device time
of each part of a step (``train_split_ms``), mean over five more steps;
``peak_gib`` the most device memory allocated during a step
(``torch.cuda.max_memory_allocated``), ``resident_gib`` what was allocated
before it (weights, optimizer state, batch); ``host_syncs`` the
synchronizing calls a step makes (``count_host_syncs``).

With ``--steps-per-loop K`` (K > 1) the steps run as the trainer runs
``--stepsPerLoop K`` (``train/graph.StepChunks``, the augmentation on its
fixed-capacity path): K-step chunks of the same batch, the first eager, the
second captured into a CUDA graph and replayed, then five replays timed on the
host clock; ``host_syncs`` is one replayed chunk's, ``peak_gib`` and
``reserved_gib`` a replayed chunk's peak and the allocator's reserved
memory after it.

``--quant-backbone int8`` runs the int8 frozen trunk (``--quantBackbone
int8``; with ``--train`` only under ``--frozen-trunk``), its scales
calibrated on the first batch; ``--backbone-chunks N`` runs the frozen
frames path in N micro-chunks (``--backboneChunks``).

The line carries the card's name and power limit.  It needs a CUDA card:
with none it raises.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import time
import traceback
import warnings
from typing import Callable, Dict, List, Tuple

import torch

from shgvqa_tpu_torch.models import shgvqa as shgvqa_model

from shgvqa_tpu_torch.entry import (
    build_model,
    device_batch,
    flagship_cfg,
    resolve_device,
    train_entry,
    trunk_cfg,
)
from shgvqa_tpu_torch.train.graph import StepChunks
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


def time_spread(fn, turns: int = 5, iters: int = 20, warmup: int = 3
                ) -> Tuple[float, Tuple[float, float]]:
    """Median and (min, max) over ``turns`` readings of ``time_ms(fn,
    iters)``, the first after ``warmup`` calls."""
    times = [time_ms(fn, iters, warmup if i == 0 else 0)
             for i in range(turns)]
    return statistics.median(times), (min(times), max(times))


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
                           warmup: int = 2, steps: int = 1) -> float:
    """Clips/s of ``step(batch, generator)``: a train step, or a chunk of
    ``steps`` steps on the batch."""
    for _ in range(warmup):
        step(batch, generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch, generator)
    torch.cuda.synchronize()
    return (batch["frames"].shape[0] * steps * iters
            / (time.perf_counter() - t0))


def chunked_step(model, optimizer, generator: torch.Generator, k: int
                 ) -> Callable:
    """A callable ``(batch, generator) -> metrics`` that trains a chunk of
    ``k`` steps on ``batch`` as ``Trainer.train`` does at ``--stepsPerLoop
    k`` (the steps' augmentation on its fixed-capacity path); its
    ``chunks`` is the ``StepChunks``."""
    chunks = StepChunks(model, make_train_step(model.cfg, model, optimizer),
                        optimizer, generator, k)

    def run(batch, _generator=None):
        return chunks.run([batch] * k)

    run.chunks = chunks
    return run


def train_split_ms(model, optimizer, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, iters: int = 5
                   ) -> Dict[str, float]:
    """Device ms of each part of a train step, mean over ``iters`` steps,
    from CUDA events around the calls ``train.step`` makes: the frames'
    augmentation (0 without one), the trunk's forward, the rest of the
    forward, the losses (matching included), the backward and within it
    the trunk's share (from the gradient of the trunk's output to the end
    of the backward: the trunk's own backward, 0 for a frozen trunk), and
    the optimizer update."""
    cfg = model.cfg
    names = ("start", "aug_in", "aug_out", "trunk_in", "trunk_out",
             "forward", "losses", "trunk_bwd", "backward", "optimizer")
    marks = [{n: torch.cuda.Event(enable_timing=True) for n in names}
             for _ in range(iters)]
    cur = {}
    augment = shgvqa_model.augment_clips

    def timed_augment(*args, **kw):
        cur["m"]["aug_in"].record()
        cur["seen"].add("aug")
        out = augment(*args, **kw)
        cur["m"]["aug_out"].record()
        return out

    def trunk_out(_mod, _args, out):
        cur["m"]["trunk_out"].record()
        if out.requires_grad:
            cur["seen"].add("trunk_bwd")
            out.register_hook(lambda g: cur["m"]["trunk_bwd"].record())

    hooks = [model.backbone.register_forward_pre_hook(
                 lambda *_: cur["m"]["trunk_in"].record()),
             model.backbone.register_forward_hook(trunk_out)]
    shgvqa_model.augment_clips = timed_augment
    seen = []
    try:
        model.train()
        for m in marks:
            cur["m"], cur["seen"] = m, set()
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
            seen.append(cur["seen"])
        torch.cuda.synchronize()
    finally:
        shgvqa_model.augment_clips = augment
        for h in hooks:
            h.remove()

    def ms(start, end, part=None):
        return sum(m[start].elapsed_time(m[end])
                   for m, s in zip(marks, seen)
                   if part is None or part in s) / iters

    aug, trunk = ms("aug_in", "aug_out", "aug"), ms("trunk_in", "trunk_out")
    return {"augment": aug, "trunk": trunk,
            "forward (rest)": ms("start", "forward") - trunk - aug,
            "losses": ms("forward", "losses"),
            "backward": ms("losses", "backward"),
            "backward: trunk": ms("trunk_bwd", "backward", "trunk_bwd"),
            "optimizer": ms("backward", "optimizer"),
            "step": ms("start", "optimizer")}


def train_memory_gib(step: Callable, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator) -> Dict[str, float]:
    """The device memory allocated before one train step (``resident``)
    and the most allocated during it (``peak``), in GiB."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(batch, generator)
    torch.cuda.synchronize()
    return {"resident_gib": resident / 2 ** 30,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}


def count_host_syncs(fn: Callable) -> Dict[str, object]:
    """The synchronizing CUDA calls ``fn()`` makes (a copy to the host, a
    blocking copy from pageable memory, a stream synchronize), as
    ``torch.cuda.set_sync_debug_mode`` reports them: their ``count`` and
    the Python lines that made them (``sites``, file:line -> calls; a line
    inside torch followed by the innermost line of this repository that
    led to it)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sites: collections.Counter = collections.Counter()

    def record(message, category, filename, lineno, *rest):
        # torch's own words for a sync; its one-time notice that the debug
        # mode is experimental also says "synchronizing"
        if "called a synchronizing CUDA operation" not in str(message):
            return
        site = f"{os.path.relpath(filename, root)}:{lineno}"
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(root)
                and os.path.abspath(f.filename) != os.path.abspath(__file__)]
        if ours and not filename.startswith(root):
            site += (f" <- {os.path.relpath(ours[-1].filename, root)}:"
                     f"{ours[-1].lineno}")
        sites[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"count": sum(sites.values()), "sites": dict(sites)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="clips/s on one card")
    parser.add_argument("--train", action="store_true",
                        help="time the flagship train step instead")
    parser.add_argument("--frozen-trunk", action="store_true",
                        help="with --train: the frozen trunk and no "
                             "augmentation instead of the published recipe")
    parser.add_argument("--steps-per-loop", type=int, default=1,
                        help="with --train: K steps a launch, as "
                             "--stepsPerLoop K trains (a K-step CUDA graph)")
    parser.add_argument("--quant-backbone", default="", choices=("", "int8"),
                        help="the int8 frozen trunk (--quantBackbone)")
    parser.add_argument("--backbone-chunks", type=int, default=1,
                        help="the frozen frames path in N micro-chunks "
                             "(--backboneChunks)")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    trunk = dict(quant_backbone=args.quant_backbone,
                 backbone_chunks=args.backbone_chunks)
    if args.train and args.quant_backbone and not args.frozen_trunk:
        parser.error("--quant-backbone trains with --frozen-trunk only (the "
                     "int8 trunk is frozen)")
    trunk_text = (f", {args.quant_backbone or 'bf16'} trunk"
                  + (f" in {args.backbone_chunks} chunks"
                     if args.backbone_chunks > 1 else ""))
    if args.train:
        published = not args.frozen_trunk
        model, optimizer, generator, batch = train_entry(
            dev, BATCH_SIZE, published=published, **trunk)
        k = args.steps_per_loop
        recipe = ("trained trunk, rand_aug (the published recipe)"
                  if published else "frozen trunk, no_aug") + trunk_text
        line = {
            "metric": f"clips/s (train step: uint8 frames->losses->BertAdam, "
                      f"HGQA b{BATCH_SIZE}, bf16, {recipe}, fused "
                      "attention kernels"
                      + (f", {k} steps a CUDA graph replay)" if k > 1
                         else ")"),
            "unit": "clips/s"}
        if k > 1:
            step = chunked_step(model, optimizer, generator, k)
            line["value"] = train_clips_per_second(step, batch, generator,
                                                   steps=k)
            line["captures"] = step.chunks.captures
        else:
            step = make_train_step(model.cfg, model, optimizer)
            line["value"] = train_clips_per_second(step, batch, generator)
            line["split_ms"] = train_split_ms(model, optimizer, batch,
                                              generator)
        line.update(
            host_syncs=count_host_syncs(lambda: step(batch, generator)),
            **train_memory_gib(step, batch, generator))
    else:
        cfg = trunk_cfg(flagship_cfg(), **trunk)
        model = build_model(cfg, dev)
        batches = [device_batch(cfg, BATCH_SIZE, seed, dev)
                   for seed in (0, 1)]
        if args.quant_backbone:
            model.calibrate_quant(batches[0]["frames"])
        cps = clips_per_second(model, batches)
        line = {
            "metric": f"clips/s (uint8 frames->answer, HGQA b{BATCH_SIZE}, "
                      f"bf16{trunk_text}, fused FFN kernel)",
            "value": cps,
            "unit": "clips/s",
        }
    line["card"] = card_name_and_power_limit()
    print(json.dumps(line))


if __name__ == "__main__":
    main()

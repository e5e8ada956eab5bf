"""Where the time goes in one flagship forward (uint8 frames -> answer) on
the card.

    python -m shgvqa_tpu_torch.breakdown [--plain-ffn]

runs the flagship at B=32; ``--plain-ffn`` runs its FFN blocks unfused
instead of through the kernel, for the A/B in PERF.md.

Prints one JSON line with:
- ``stages_ms``: device time of each stage of the model, from CUDA events
  recorded by forward hooks around the stage's modules (mean over five
  forwards); ``ffn sites`` sums the FFN blocks inside the other stages;
- ``forward_ms``: host-clock time of one forward up to synchronize;
- ``top_kernels``: the device kernels with the most time in one profiled
  forward (torch.profiler), and ``busy_share``: the summed device time of
  all its kernels over ``forward_ms`` (the profiler's own start-up makes
  the profiled forward's wall time no measure of it);
- the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from shgvqa_tpu_torch.bench import BATCH_SIZE, card_name_and_power_limit
from shgvqa_tpu_torch.entry import build_model, device_batch, flagship_cfg
from shgvqa_tpu_torch.models.layers import FFN


def _stages(model):
    """(stage name, module) pairs; stages may nest (FFN sites)."""
    enc = model.head.lxrt.encoder
    stages = [("trunk", model.backbone),
              ("tokenizer", enc.visual_tokenizer),
              ("embeddings", model.head.lxrt.embeddings),
              ("cross layers", enc.x_tied),
              ("decoders", model.head.rel_decoder),
              ("decoders", model.head.action_decoder),
              ("hg cross encoder", model.head.hgq_encoder)]
    stages += [("language layers", getattr(enc, n)) for n in enc.l_names]
    stages += [("visual layers", getattr(enc, n)) for n in enc.r_names]
    stages += [("ffn sites", m) for m in model.modules() if isinstance(m, FFN)]
    return stages


def stage_times(model, batch, iters: int = 5):
    events = defaultdict(list)

    def hooks(name):
        def pre(_mod, _args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])

        def post(_mod, _args, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev
        return pre, post

    handles = []
    for name, mod in _stages(model):
        pre, post = hooks(name)
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    try:
        with torch.inference_mode():
            model(batch)                       # warm-up, not counted
            events.clear()
            for _ in range(iters):
                model(batch)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: sum(a.elapsed_time(b) for a, b in pairs) / iters
            for name, pairs in events.items()}


def top_kernels(model, batch, top: int = 15):
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(batch)
            torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return [{"kernel": k[:120], "ms": ms, "calls": n}
            for k, ms, n in rows[:top]], busy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plain-ffn", action="store_true",
                    help="run the FFN blocks unfused instead of the kernel")
    args = ap.parse_args(argv)
    cfg = flagship_cfg().replace(use_pallas_ffn=not args.plain_ffn)
    model = build_model(cfg)
    batch = device_batch(cfg, BATCH_SIZE)
    stages = stage_times(model, batch)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = top_kernels(model, batch)
    print(json.dumps({
        "batch_size": BATCH_SIZE, "ffn": "plain" if args.plain_ffn
        else "kernel", "forward_ms": forward_ms, "stages_ms": stages,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / forward_ms,
        "top_kernels": kernels,
        "card": card_name_and_power_limit()}))


if __name__ == "__main__":
    main()

"""Where the time goes in one flagship forward (uint8 frames -> answer), or
with ``--train`` one flagship train step, on the card.

    python -m shgvqa_tpu_torch.breakdown [--plain-ffn | --tok-block |
        --attention | --out-ln-headsliced | --train]

runs the flagship at B=32; ``--plain-ffn`` runs its FFN blocks unfused
instead of through the kernel, for the A/B in PERF.md; ``--tok-block``
also runs the tokenizer's convs and the trunk's 6 stride-1 blocks through
their kernels (``set_tok_kernel``, ``set_block_kernel``); ``--attention``
runs every attention site through the fused attention forward
(``use_pallas_attention``, ``--pallasAttention``); ``--out-ln-headsliced``
runs every AttOutput through ``fused_out_ln`` and every attention site
through the head-sliced kernel (``set_out_ln_kernel``,
``set_headsliced_kernel``).  ``--train`` prints
the train step's time (host clock, after two warm-up steps), its split
(``bench.train_split_ms``), the device kernels with the most time in one
profiled step and the device busy share.

Without ``--train``, the line has:

- ``stages_ms``: device time of each stage of the model, from CUDA events
  recorded by forward hooks around the stage's modules (mean over five
  forwards); ``ffn sites``, ``attention sites`` (the attention cores with
  their q/k/v projections) and ``att output sites`` sum those blocks inside
  the other stages;
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

from shgvqa_tpu_torch.bench import (
    BATCH_SIZE,
    card_name_and_power_limit,
    train_split_ms,
)
from shgvqa_tpu_torch.entry import (
    build_model,
    device_batch,
    flagship_cfg,
    train_entry,
)
from shgvqa_tpu_torch.models.backbone import set_block_kernel
from shgvqa_tpu_torch.models.decoder import TorchMHA
from shgvqa_tpu_torch.models.layers import (
    FFN,
    Attention,
    AttOutput,
    set_headsliced_kernel,
    set_out_ln_kernel,
)
from shgvqa_tpu_torch.models.visual import set_tok_kernel
from shgvqa_tpu_torch.train.step import make_train_step


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
    for name, kinds in (("ffn sites", FFN),
                        ("attention sites", (Attention, TorchMHA)),
                        ("att output sites", AttOutput)):
        stages += [(name, m) for m in model.modules() if isinstance(m, kinds)]
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


def top_kernels(run, top: int = 25):
    """The device kernels with the most time in one ``run()``, and the
    summed device time of all of them."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return [{"kernel": k[:120], "ms": ms, "calls": n}
            for k, ms, n in rows[:top]], busy


def train_breakdown() -> dict:
    model, optimizer, generator, batch = train_entry(batch_size=BATCH_SIZE)
    step = make_train_step(model.cfg, model, optimizer)
    for _ in range(2):
        step(batch, generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch, generator)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = top_kernels(lambda: step(batch, generator))
    return {"batch_size": BATCH_SIZE, "mode": "train", "step_ms": step_ms,
            "split_ms": train_split_ms(model, optimizer, batch, generator),
            "device_busy_ms": busy_ms, "busy_share": busy_ms / step_ms,
            "top_kernels": kernels, "card": card_name_and_power_limit()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--plain-ffn", action="store_true",
                      help="run the FFN blocks unfused instead of the kernel")
    mode.add_argument("--tok-block", action="store_true",
                      help="also run the tokenizer and bottleneck kernels")
    mode.add_argument("--attention", action="store_true",
                      help="also run the attention forward kernel at every "
                           "site (--pallasAttention)")
    mode.add_argument("--out-ln-headsliced", action="store_true",
                      help="also run the out_ln and head-sliced attention "
                           "kernels")
    mode.add_argument("--train", action="store_true",
                      help="break down one train step instead")
    args = ap.parse_args(argv)
    if args.train:
        print(json.dumps(train_breakdown()))
        return
    cfg = flagship_cfg().replace(use_pallas_ffn=not args.plain_ffn,
                                 use_pallas_attention=args.attention)
    model = build_model(cfg)
    set_tok_kernel(model, args.tok_block)
    set_block_kernel(model, args.tok_block)
    set_out_ln_kernel(model, args.out_ln_headsliced)
    set_headsliced_kernel(model, args.out_ln_headsliced)
    batch = device_batch(cfg, BATCH_SIZE)
    stages = stage_times(model, batch)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode():
        kernels, busy_ms = top_kernels(lambda: model(batch))
    print(json.dumps({
        "batch_size": BATCH_SIZE, "ffn": "plain" if args.plain_ffn
        else "kernel", "tok_block": "kernel" if args.tok_block else "plain",
        "attention": "kernel" if args.attention else "plain",
        "out_ln_headsliced": ("kernel" if args.out_ln_headsliced
                              else "plain"),
        "forward_ms": forward_ms, "stages_ms": stages,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / forward_ms,
        "top_kernels": kernels,
        "card": card_name_and_power_limit()}))


if __name__ == "__main__":
    main()

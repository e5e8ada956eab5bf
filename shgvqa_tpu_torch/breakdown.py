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
``set_headsliced_kernel``).  ``--train`` prints, for the published AGQA
recipe (the trunk trained, RandAugment on the device; ``--frozen-trunk``:
the frozen trunk without augmentation), the train step's time (host
clock, after two warm-up steps), its split (``bench.train_split_ms``:
augment, trunk, rest of the forward, losses, backward with the trunk's
share, optimizer), the device kernels with the most time in one profiled
step and the device busy share, the kernels of the trunk's backward alone
(``trunk_backward``), and the tokenizer convs' forward, input gradient and
weight gradient alone (``tok_conv_grads``: device ms and top kernels
each).

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
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from shgvqa_tpu_torch.bench import (
    BATCH_SIZE,
    card_name_and_power_limit,
    time_ms,
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


def trunk_backward(model, frames, top: int = 12) -> dict:
    """The device kernels of the trunk's backward alone (a forward of the
    unaugmented frames, then the gradient of the sum of its features), and
    their summed device time."""
    training = model.training
    model.eval()
    try:
        out = model.backbone(model.normalize_frames(frames))
        torch.cuda.synchronize()
        kernels, busy = top_kernels(lambda: out.float().sum().backward(), top)
    finally:
        model.train(training)
        for p in model.backbone.parameters():
            p.grad = None
    return {"device_ms": busy, "top_kernels": kernels}


def conv_grads(conv, x: torch.Tensor, iters: int = 10) -> dict:
    """A ``Conv3d`` module's forward, input gradient and weight gradient on
    ``x`` (NCDHW), each alone as autograd calls it
    (``aten.convolution_backward`` with one output): device ms by CUDA
    events (mean of ``iters`` calls) and its top device kernels."""
    dt = conv.dtype
    x, w = x.to(dt), conv.weight.detach().to(dt)
    bias = None if conv.bias is None else conv.bias.detach().to(dt)
    args = (list(conv.stride), list(conv.padding))
    with torch.no_grad():
        dy = torch.randn_like(F.conv3d(x, w, bias, *args))

    def grad(mask):
        return lambda: torch.ops.aten.convolution_backward(
            dy, x, w, None if bias is None else [bias.shape[0]], *args,
            [1, 1, 1], False, [0, 0, 0], 1, mask)

    parts = {"forward": lambda: F.conv3d(x, w, bias, *args),
             "input gradient": grad([True, False, False]),
             "weight gradient": grad([False, True, False])}
    out = {}
    with torch.no_grad():
        for name, fn in parts.items():
            ms = time_ms(fn, iters=iters, warmup=2)
            # a profiling session can lose kernels: take one whose top
            # kernels hold most of the two calls' time
            for _ in range(3):
                kernels, busy = top_kernels(lambda: (fn(), fn()), top=3)
                if busy > ms:
                    break
            out[name] = {"ms": ms, "top_kernels": kernels}
    return out


def tok_conv_grads(model, frames) -> dict:
    """``conv_grads`` of the tokenizer's two convs on the inputs one
    eval forward of ``frames`` gives them."""
    tok = model.head.lxrt.encoder.visual_tokenizer
    inputs = {}
    hooks = [conv.register_forward_pre_hook(
                 lambda mod, args, name=name: inputs.setdefault(
                     name, args[0].detach()))
             for name, conv in (("conv1", tok.conv1), ("conv2", tok.conv2))]
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            tok(model.encode_frames(frames))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return {name: dict(conv_grads(getattr(tok, name), x),
                       shape=list(x.shape)) for name, x in inputs.items()}


def train_breakdown(published: bool = True) -> dict:
    model, optimizer, generator, batch = train_entry(
        batch_size=BATCH_SIZE, published=published)
    step = make_train_step(model.cfg, model, optimizer)
    for _ in range(2):
        step(batch, generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch, generator)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = top_kernels(lambda: step(batch, generator))
    return {"batch_size": BATCH_SIZE, "mode": "train",
            "recipe": "published" if published else "frozen trunk",
            "step_ms": step_ms,
            "split_ms": train_split_ms(model, optimizer, batch, generator),
            "device_busy_ms": busy_ms, "busy_share": busy_ms / step_ms,
            "top_kernels": kernels,
            "trunk_backward": trunk_backward(model, batch["frames"]),
            "tok_conv_grads": tok_conv_grads(model, batch["frames"]),
            "card": card_name_and_power_limit()}


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
                      help="break down one train step of the published "
                           "recipe instead")
    ap.add_argument("--frozen-trunk", action="store_true",
                    help="with --train: the frozen trunk and no augmentation")
    args = ap.parse_args(argv)
    if args.train:
        print(json.dumps(train_breakdown(not args.frozen_trunk)))
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

"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a).  Every phase raises on failure and
the script then exits non-zero; without a card, or outside the repository,
it exits non-zero before printing any result.

1. card: its name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every ``shgvqa_tpu_torch/csrc/*.cu``, one nvcc each, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it, with its time, the plain version's
   time and the bound:
   - the FFN forward (and its autograd backward at a small shape), beside
     a composite-of-library-calls yardstick;
   - both attention kernels at every attention site of the train step at
     B=2 and B=32: the forward and dQ, dK, dV at rate 0, and at the site's
     dropout rate with the kernels' own keep mask given to the plain
     version; the realised keep rate; SDPA with the same
     additive mask as the library yardstick (timed only);
4. main path: ``entry.entry()`` -- the flagship uint8 frames -> hg_logit
   forward at B=2 -- with every launch count set to 0 just before and read
   just after, then the same weights with the FFN kernel switched off;
5. throughput: clips/s at B=32 with the kernel and with the plain FFN;
6. train main path: ``entry.train_entry()`` -- three flagship train steps
   at B=32 -- with the launch counts set to 0 before each step and read
   after it (38 attention forwards, 34 backwards, 0 FFN); finite losses;
   the trainable parameters move, the trunk and the disconnected LXRT
   x-layers and pooler stay bit-identical; the eval step at B=2 (18 FFN
   launches, no attention launch); then, with every dropout rate at 0,
   the kernel path against the plain path (loss and gradient norm);
7. train throughput: clips/s at B=32 with the kernel and with the plain
   attention, and the step's split;
8. the plain path, then two plain train steps, on the card against the
   CPU at tiny size in f32;
9. the card line, one ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for f32 matmuls and convolutions (phase 8 compares
f32 results).  ``bound_ms`` is max(operations / 989 TFLOP/s bf16, bytes /
3.35 TB/s): the H100 SXM's published dense peaks, each input read once and
each output written once.  ``--only attention`` runs phases 1-2 and the
attention checks of phase 3, and prints no result lines.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from shgvqa_tpu_torch import entry
from shgvqa_tpu_torch.bench import (
    BATCH_SIZE,
    card_name_and_power_limit,
    clips_per_second,
    time_ms,
    train_clips_per_second,
    train_split_ms,
)
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.data.featurize import situation_causal_mask
from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import (
    attention_reference,
    decompose_mask,
    draw_seed,
    fused_attention,
    keep_mask,
)
from shgvqa_tpu_torch.kernels.ffn import ffn_reference, fused_ffn
from shgvqa_tpu_torch.models.layers import (
    FFN,
    Dropout,
    extend_mask,
    set_attention_kernel,
    set_dropout_rate,
)
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from shgvqa_tpu_torch.train.step import (
    compute_losses,
    make_eval_step,
    make_train_step,
    trainable_mask,
)

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
D, FF = 768, 3072
# FFN sites of one flagship forward, as (rows per clip, sites): language
# (5 layers + 2 cross steps + 2 HG-cross steps), visual (5 + 2), HG (2)
FFN_SITES = ((40, 9), (393, 7), (177, 2))
TOL = 3e-2                     # |y - ref| <= TOL * max(1, |ref|), bf16
H, HEAD_DIM, NUM_SITUATIONS = 12, 64, 16
# attention sites of one flagship train step: (site, Lq, Lk, mask, dropout
# rate, forward launches, backward launches).  The LXRT cross layers feed
# only the unsupervised `logit`, so their backward never runs.
ATTN_SITES = (
    ("language self", 40, 40, "key", 0.1, 5, 5),
    ("visual self", 393, 393, "key", 0.1, 5, 5),
    ("LXRT cross lang<-visn", 40, 393, "key", 0.1, 2, 0),
    ("LXRT cross visn<-lang", 393, 40, "key", 0.1, 2, 0),
    ("HG cross lang<-hg", 40, 177, "none", 0.1, 2, 2),
    ("HG cross hg<-lang", 177, 40, "key", 0.1, 2, 2),
    ("rel decoder self", 128, 128, "pane", 0.15, 5, 5),
    ("rel decoder cross", 128, 393, "none", 0.15, 5, 5),
    ("act decoder self", 48, 48, "pane", 0.15, 5, 5),
    ("act decoder cross", 48, 393, "none", 0.15, 5, 5),
)
# max |kernel - plain| <= tol * max |plain| (bf16 operands; the kernels
# round P and dS to bf16 where the plain version keeps f32)
ATTN_TOL, ATTN_GRAD_TOL = 2e-2, 3e-2
# train step, kernel vs plain attention at dropout 0: relative difference of
# the loss and of the gradients' global norm (bf16 through ~40 layers)
TRAIN_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def ffn_bound(m: int, d: int = D, f: int = FF):
    flops = 4 * m * d * f
    nbytes = 2 * m * d * 2 + 2 * d * f * 2 + (f + 3 * d) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ffn_operands(m: int, d: int = D, f: int = FF, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(m, d).to(torch.bfloat16),
            (0.02 * randn(f, d)).to(torch.bfloat16), 0.02 * randn(f),
            (0.02 * randn(d, f)).to(torch.bfloat16), 0.02 * randn(d),
            1.0 + 0.1 * randn(d), 0.1 * randn(d))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > TOL * want.float().abs().clamp(min=1.0)
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off by more "
                             f"than {TOL} * max(1, |ref|); max |err| "
                             f"{err.max().item()}")
    return err.max().item()


def phase_ffn_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The fused FFN kernel against ffn_reference at the main path's shapes
    (bf16), its backward at a small shape, and its times."""
    rows = {}
    max_err = 0.0
    with torch.inference_mode():
        for bsz in batch_sizes:
            for per_clip, _ in FFN_SITES:
                m = per_clip * bsz
                args = ffn_operands(m, seed=m)
                err = check_close(f"fused_ffn M={m}", fused_ffn(*args),
                                  ffn_reference(*args))
                max_err = max(max_err, err)
                x, w1t, b1, w2t, b2, gamma, beta = args
                yard = (lambda: F.layer_norm(
                    x + F.linear(F.gelu(F.linear(x, w1t, b1.to(x.dtype))),
                                 w2t, b2.to(x.dtype)),
                    (D,), gamma.to(x.dtype), beta.to(x.dtype), 1e-12))
                bound, bound_by = ffn_bound(m)
                rows[m] = dict(
                    M=m, kernel_ms=time_ms(lambda: fused_ffn(*args)),
                    plain_ms=time_ms(lambda: ffn_reference(*args)),
                    yardstick_ms=time_ms(yard), bound_ms=bound,
                    bound_by=bound_by, max_abs_err=err)
                log(f"fused_ffn {json.dumps(rows[m])}")
    # autograd backward at a small shape: recompute through ffn_reference
    ops = [a.detach().requires_grad_(True)
           for a in ffn_operands(64, 128, 256, seed=7)]
    grads = torch.autograd.grad((fused_ffn(*ops).float() ** 2).sum(), ops)
    refs = torch.autograd.grad((ffn_reference(*ops).float() ** 2).sum(), ops)
    for i, (g, r) in enumerate(zip(grads, refs)):
        check_close(f"fused_ffn backward grad {i}", g, r)
    log("fused_ffn backward ok (M=64, D=128, F=256)")
    return rows, max_err


def per_forward(rows, bsz, key):
    return sum(n * rows[per_clip * bsz][key] for per_clip, n in FFN_SITES)


def attention_bound(b, lq, lk, key, pane, backward: bool):
    """(ms, bound_by) of one call: 4 (forward) or 10 (backward) products of
    g*Lq*Lk*64 (the JAX cost estimates, attention.py:247 and :277) over the
    bf16 peak, against its bytes (bf16 operands and results, f32 masks and
    logsumexp, each read or written once) over the memory rate."""
    g, d = b * H, HEAD_DIM
    flops = (10 if backward else 4) * g * lq * lk * d
    operands = (2 * g * lq * d + 2 * g * lk * d) * 2        # q, o, k, v
    masks = (0 if key is None else b * lk * 4) + (0 if pane is None
                                                  else lq * lk * 4)
    nbytes = operands + masks + g * lq * 4                  # + lse
    if backward:
        nbytes += (2 * g * lq * d + 2 * g * lk * d) * 2     # do, dq, dk, dv
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_operands(b, lq, lk, kind, seed):
    """bf16 q, k, v (B, H, L, 64) as views of (B, L, H, 64) buffers (the
    model's layout) and the site's additive mask: a key row with the last
    keys of every other clip masked by -10000, the situation-causal -inf
    pane, or none."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(length):
        return torch.randn(b, length, H, HEAD_DIM, generator=g,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    mask = None
    if kind == "key":
        valid = torch.ones(b, lk, device="cuda")
        valid[1::2, lk - max(1, lk // 5):] = 0.0
        mask = extend_mask(valid, torch.bfloat16)
    elif kind == "pane":
        slots = lq // NUM_SITUATIONS
        mask = torch.as_tensor(situation_causal_mask(NUM_SITUATIONS, slots),
                               device="cuda")
    return rand(lq), rand(lk), rand(lk), mask


def rel_max_err(name, got, want, tol):
    """(max |got - want|, that over max |want|), raising if it exceeds
    tol * max |want| or got is not finite."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-6)
    if not torch.isfinite(got.float()).all() or err > tol * scale:
        raise AssertionError(f"{name}: max |err| {err} > {tol} * max |ref| "
                             f"{scale}")
    return err, err / scale


def grad_errors(name, q, k, v, mask, rate, keep, out, do):
    """dQ, dK, dV of ``out`` (the kernels' output) at cotangent ``do``
    against autograd of the plain version on f32 copies: (max |err|, that
    over max |ref|) of the worst."""
    grads = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    q32, k32, v32 = (t.detach().float().requires_grad_(True)
                     for t in (q, k, v))
    ref = attention_reference(q32, k32, v32, mask, rate, keep)
    refs = torch.autograd.grad(ref, (q32, k32, v32), do.float())
    errs = [rel_max_err(f"{name} d{n}", gr, rr, ATTN_GRAD_TOL)
            for n, gr, rr in zip("qkv", grads, refs)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def rate0_errors(q, k, v, mask, tag):
    """The forward and dQ, dK, dV without dropout against the plain
    version."""
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fused_attention(qg, kg, vg, mask)
    e0, r0 = rel_max_err(f"attention fwd rate 0 {tag}", out,
                         attention_reference(q, k, v, mask), ATTN_TOL)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    e1, r1 = grad_errors(f"attention rate 0 {tag}", qg, kg, vg, mask, 0.0,
                         None, out, do)
    return e0, r0, e1, r1


def phase_attention_kernels(batch_sizes=(2, BATCH_SIZE)):
    """Both attention kernels against the plain version at every main-path
    shape: forward and dQ, dK, dV at rate 0, and at the site's rate with the
    kernels' own keep mask fed to the plain version, the realised keep rate,
    and the times of kernel, plain version and SDPA."""
    rows = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for bsz in batch_sizes:
        for i, (name, lq, lk, kind, rate, _, _) in enumerate(ATTN_SITES):
            q, k, v, mask = attention_operands(bsz, lq, lk, kind, 100 + i)
            key, pane = decompose_mask(mask, bsz, H, lq, lk)
            tag = f"{name} b{bsz} ({lq}, {lk})"
            e0, r0, e3, r3 = rate0_errors(q, k, v, mask, tag)
            # rate > 0: the seed the call draws is read back from a copy of
            # the generator's state, and the kernels' keep mask from it
            g = torch.Generator(device="cuda").manual_seed(7 + i)
            state = g.get_state()
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = fused_attention(qg, kg, vg, mask, rate, g)
            g.set_state(state)
            keep = keep_mask(draw_seed(g, q.device), bsz * H, lq, lk,
                             rate).view(bsz, H, lq, lk)
            kept = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            if abs(kept - (1 - rate)) > 6 * sigma + 1e-9:
                raise AssertionError(f"{tag}: keep rate {kept} vs {1 - rate}"
                                     f" (6 sigma {6 * sigma})")
            do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
            e2, r2 = grad_errors(f"attention rate {rate} {tag}", qg, kg, vg,
                                 mask, rate, keep, out, do)
            e1, r1 = rel_max_err(f"attention fwd rate {rate} {tag}", out,
                                 attention_reference(q, k, v, mask, rate,
                                                     keep), ATTN_TOL)
            max_err["fwd"] = max(max_err["fwd"], e0, e1)
            max_err["bwd"] = max(max_err["bwd"], e2, e3)

            # times: kernel, plain version, SDPA with the same additive mask
            plain_out = attention_reference(qg, kg, vg, mask, rate, keep)
            sdpa_mask = None
            if mask is not None:
                sdpa_mask = torch.zeros(bsz if key is not None else 1, 1, lq,
                                        lk, device="cuda")
                if key is not None:
                    sdpa_mask = sdpa_mask + key[:, None, None, :]
                if pane is not None:
                    sdpa_mask = sdpa_mask + pane
                sdpa_mask = sdpa_mask.to(torch.bfloat16)
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, sdpa_mask)
            timed = dict(
                kernel_ms=time_ms(lambda: fused_attention(q, k, v, mask,
                                                          rate, g)),
                plain_ms=time_ms(lambda: attention_reference(q, k, v, mask,
                                                             rate, keep)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, sdpa_mask)),
                bwd_kernel_ms=time_ms(lambda: torch.autograd.grad(
                    out, (qg, kg, vg), do, retain_graph=True)),
                bwd_plain_ms=time_ms(lambda: torch.autograd.grad(
                    plain_out, (qg, kg, vg), do, retain_graph=True)),
                bwd_library_ms=time_ms(lambda: torch.autograd.grad(
                    sdpa_out, (qg, kg, vg), do, retain_graph=True)),
                fwd_bwd_library_ms=time_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qg, kg, vg, sdpa_mask),
                    (qg, kg, vg), do)))
            bound, bound_by = attention_bound(bsz, lq, lk, key, pane, False)
            bwd_bound, bwd_bound_by = attention_bound(bsz, lq, lk, key, pane,
                                                      True)
            rows[(name, bsz)] = dict(
                site=name, B=bsz, Lq=lq, Lk=lk, mask=kind, rate=rate,
                keep_rate=kept, err_fwd=max(e0, e1), err_grads=max(e2, e3),
                rel_err_fwd=max(r0, r1), rel_err_grads=max(r2, r3),
                bound_ms=bound, bound_by=bound_by, bwd_bound_ms=bwd_bound,
                bwd_bound_by=bwd_bound_by, **timed)
            log(f"fused_attention {json.dumps(rows[(name, bsz)])}")
    return rows, max_err


def per_step(rows, bsz, key, backward=False):
    """Sum over the attention sites of one train step of ``key``."""
    return sum((nb if backward else nf) * rows[(name, bsz)][key]
               for name, _, _, _, _, nf, nb in ATTN_SITES)


def set_ffn_kernel(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, FFN):
            m.use_kernel = on


def phase_main_path():
    """entry.entry() at B=2 with launch counts from 0, then the same
    weights with the FFN kernel off."""
    t0 = time.perf_counter()
    fn, args = entry.entry()
    log(f"main path: flagship model built in {time.perf_counter() - t0:.1f} s")
    model, batch = args
    fused_ffn.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    launches = fused_ffn.launches
    if launches != 18:
        raise AssertionError(f"fused_ffn launched {launches} times in one "
                             "forward, expected 18")
    set_ffn_kernel(model, False)
    plain = fn(*args)
    set_ffn_kernel(model, True)
    cfg = model.cfg
    want_shape = (batch["frames"].shape[0], cfg.num_answers)
    for name, y in (("kernel", out), ("plain", plain)):
        if tuple(y.shape) != want_shape or not torch.isfinite(y).all():
            raise AssertionError(f"hg_logit ({name}) shape {tuple(y.shape)} "
                                 f"or non-finite values")
    rel = ((out.float() - plain.float()).norm() / plain.float().norm()).item()
    agree = (out.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"main path: hg_logit {want_shape}, rel Frobenius vs plain FFN "
        f"{rel:.3e}, argmax agreement {agree:.3f}, fused_ffn launches "
        f"{launches}")
    if rel > 5e-2:
        raise AssertionError(f"hg_logit differs from the plain path by {rel}")
    return model, launches


def phase_throughput(model):
    """clips/s at B=32, kernel and plain FFN in turns on the same weights."""
    batches = [entry.device_batch(model.cfg, BATCH_SIZE, seed)
               for seed in (0, 1)]
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        set_ffn_kernel(model, name == "kernel")
        runs[name].append(clips_per_second(model, batches))
    set_ffn_kernel(model, True)
    log(f"throughput b{BATCH_SIZE} clips/s: {json.dumps(runs)}")
    return {k: sum(v) / len(v) for k, v in runs.items()}


def reset_counts():
    fused_ffn.launches = 0
    fused_attention.launches = 0
    fused_attention.bwd_launches = 0


def counts():
    return (fused_attention.launches, fused_attention.bwd_launches,
            fused_ffn.launches)


def grad_norm(params):
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.float().norm() if p.grad is not None
         else torch.zeros((), device="cuda") for p in params])).item()


def phase_train_main_path():
    """entry.train_entry() at B=32: three train steps with every launch
    count set to 0 just before each and read just after; the frozen and
    disconnected parameters stay bit-identical, the trainable ones move;
    the eval step at B=2; then the kernel path against the plain path on
    the same weights and batch with every dropout rate at 0."""
    t0 = time.perf_counter()
    model, optimizer, generator, batch = entry.train_entry()
    cfg = model.cfg
    log(f"train main path: flagship model and optimizer built in "
        f"{time.perf_counter() - t0:.1f} s")
    step = make_train_step(cfg, model, optimizer)
    trainable = {id(p) for p in optimizer.params}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step_counts = []
    for i in range(3):
        reset_counts()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        step_counts.append(counts())
        values = {k: v.item() for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step {i}: non-finite {values}")
        log(f"train step {i}: launches (attention fwd, bwd, ffn) "
            f"{step_counts[-1]}; {json.dumps(values)}")
    if any(c != (38, 34, 0) for c in step_counts):
        raise AssertionError(f"train step launches {step_counts}, expected "
                             "38 attention forward, 34 backward, 0 FFN")
    # A trainable tensor must move unless its last update is below f32
    # resolution everywhere: with random weights the gradients' global norm
    # is ~5e6, so the clip scales them by ~1e-6 and, with Adam's eps, the
    # early updates of small-gradient tensors (lr_t ~1e-6) vanish in f32.
    moved, frozen, tiny = 0, 0, []
    lr_t = optimizer.lr_at(optimizer.step_count - 1)
    state = {id(p): (m, v) for p, m, v in zip(
        optimizer.params, optimizer.m, optimizer.v)}
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if id(p) not in trainable:
            if not same:
                raise AssertionError(f"frozen or disconnected parameter "
                                     f"{name} changed")
            frozen += 1
            continue
        if not same:
            moved += 1
            continue
        m, v = state[id(p)]
        update = lr_t * (m / (v.sqrt() + optimizer.eps)
                         + optimizer.weight_decay * p.detach())
        if (update.abs() > 0.5 * torch.finfo(torch.float32).eps
                * p.detach().abs()).any():
            raise AssertionError(f"trainable parameter {name} did not move")
        tiny.append(name)
    log(f"train main path: {moved} trainable tensors moved, {len(tiny)} "
        f"with updates below f32 resolution {tiny}; {frozen} frozen (trunk) "
        "or disconnected (LXRT x-layers, pooler) tensors bit-identical")
    del before

    reset_counts()
    eval_batch = entry.device_batch(cfg, 2, 1, with_labels=True)
    preds = make_eval_step(cfg, model, with_hg_metrics=True)(eval_batch)
    torch.cuda.synchronize()
    eval_counts = counts()
    if eval_counts != (0, 0, 18):
        raise AssertionError(f"eval step launches {eval_counts}, expected 0 "
                             "attention and 18 FFN")
    log(f"eval step b2: launches {eval_counts}; rel/act class acc "
        f"{preds['rel_class_acc'].item():.2f} / "
        f"{preds['act_class_acc'].item():.2f}")

    # kernel path vs plain path with every dropout rate 0, same weights
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    set_dropout_rate(model, 0.0)
    results = {}
    model.train()
    for on in (True, False):
        set_attention_kernel(model, on)
        optimizer.zero_grad()
        loss, _ = compute_losses(cfg, model(batch, generator), batch)
        loss.backward()
        results["kernel" if on else "plain"] = (loss.item(),
                                                grad_norm(optimizer.params))
    optimizer.zero_grad()
    set_attention_kernel(model, True)
    for m, rate in rates.items():
        m.rate = rate
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    rel_loss, rel_grad = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    log(f"train kernel vs plain attention (dropout 0, b{BATCH_SIZE}): loss "
        f"{lk:.6f} vs {lp:.6f} (rel {rel_loss:.2e}), grad norm {gk:.6f} vs "
        f"{gp:.6f} (rel {rel_grad:.2e})")
    if rel_loss > TRAIN_TOL or rel_grad > TRAIN_TOL:
        raise AssertionError(f"kernel and plain train paths differ: loss rel "
                             f"{rel_loss}, grad norm rel {rel_grad}")
    return model, optimizer, generator, batch, step_counts[-1]


def phase_train_throughput(model, optimizer, generator, batch):
    """Train clips/s at B=32, kernel and plain attention in turns, and the
    kernel path's step split."""
    step = make_train_step(model.cfg, model, optimizer)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        set_attention_kernel(model, name == "kernel")
        runs[name].append(train_clips_per_second(step, batch, generator))
    set_attention_kernel(model, True)
    split = train_split_ms(model, optimizer, batch, generator)
    log(f"train throughput b{BATCH_SIZE} clips/s: {json.dumps(runs)}; "
        f"kernel step split ms {json.dumps(split)}")
    return {k: sum(v) / len(v) for k, v in runs.items()}


def phase_plain_train_step_card_vs_cpu(device="cuda"):
    """Two plain train steps of the tiny f32 model (dropout 0) on the card
    against the CPU: the metrics of each step, and the parameters after
    (the first step's lr is 0, the second's is not)."""
    cfg = tiny_test_config(task="hgqa", use_pallas_ffn=False,
                           use_pallas_attention_train=False)
    cpu = entry.build_model(cfg, "cpu", seed=2).train()
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.RandomState(3)
    d, e = cfg.data, cfg.encoder
    batch = entry.example_batch(cfg, 2, 3, with_labels=True)
    batch.pop("visual_mask")
    batch["frames"] = rng.randint(0, 255, (2, e.visual_t + 8, d.image_size,
                                           d.image_size, 3)).astype(np.uint8)
    o = cfg.optim
    runs = {}
    for dev, model in (("cpu", cpu), (device, gpu)):
        set_dropout_rate(model, 0.0)
        opt = make_optimizer(model, o.lr, 10, o.warmup, o.schedule, o.b1,
                             o.b2, o.eps, o.weight_decay, o.grad_clip,
                             trainable_mask(model, cfg))
        step = make_train_step(cfg, model, opt)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        mets = [{k: v.item() for k, v in step(tb).items()} for _ in range(2)]
        runs[dev] = (mets, before, model, opt)
    (_, before, cpu_model, cpu_opt), (gpu_mets, _, gpu_model, _) = (
        runs["cpu"], runs[device])
    worst_metric = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0)
                       for a, b in zip(gpu_mets, runs["cpu"][0]) for k in b)
    rms_m = torch.cat([m.flatten() for m in cpu_opt.m]).square().mean().sqrt()
    moments = dict(zip(map(id, cpu_opt.params), cpu_opt.m))
    worst_param = 0.0
    for (name, pc), pg in zip(cpu_model.named_parameters(),
                              gpu_model.parameters()):
        dc, dg = pc.detach() - before[name], pg.detach().cpu() - before[name]
        real = (moments[id(pc)].abs() >= 1e-5 * rms_m if id(pc) in moments
                else torch.ones_like(dc, dtype=torch.bool))
        if dc[real].norm() > 0:
            worst_param = max(worst_param, ((dg - dc)[real].norm()
                                            / dc[real].norm()).item())
    log(f"plain train step card vs CPU (tiny, f32, 2 steps): max rel metric "
        f"error {worst_metric:.2e}, max rel parameter-update error "
        f"{worst_param:.2e}")
    if worst_metric > 1e-4 or worst_param > 1e-3:
        raise AssertionError(f"card and CPU train steps disagree: metrics "
                             f"{worst_metric}, updates {worst_param}")


def phase_plain_path_card_vs_cpu():
    """The tiny f32 model's plain path on the card against the CPU."""
    cfg = tiny_test_config(task="hgqa", use_pallas_ffn=False)
    cpu = entry.build_model(cfg, "cpu", seed=1)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.RandomState(0)
    d, e = cfg.data, cfg.encoder
    batch = {
        "input_ids": rng.randint(1, e.vocab_size, (2, d.max_seq_length)),
        "input_mask": np.ones((2, d.max_seq_length), np.int32),
        "segment_ids": np.zeros((2, d.max_seq_length), np.int32),
        "frames": rng.randint(0, 255, (2, e.visual_t + 8, d.image_size,
                                       d.image_size, 3)).astype(np.uint8),
    }
    with torch.inference_mode():
        want = cpu({k: torch.as_tensor(v) for k, v in batch.items()})
        got = gpu({k: torch.as_tensor(v, device="cuda")
                   for k, v in batch.items()})
    worst = max(((got[k].cpu() - want[k]).abs().max()
                 / want[k].abs().max()).item() for k in want)
    log(f"plain path card vs CPU (tiny, f32): max rel error {worst:.2e}")
    if worst > 1e-4:
        raise AssertionError(f"card and CPU disagree by {worst}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("attention",),
                        help="build and run only this kernel phase (no "
                             "result lines)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power_limit()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs, build_logs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    if args.only == "attention":
        attn_rows, attn_err = phase_attention_kernels()
        log(f"attention kernels ok; max errors {json.dumps(attn_err)}")
        return 0

    rows, max_err = phase_ffn_kernel()
    attn_rows, attn_err = phase_attention_kernels()
    model, launches = phase_main_path()
    cps = phase_throughput(model)
    del model
    train_model, optimizer, generator, batch, train_launches = (
        phase_train_main_path())
    train_cps = phase_train_throughput(train_model, optimizer, generator,
                                       batch)
    del train_model, optimizer, batch
    phase_plain_path_card_vs_cpu()
    phase_plain_train_step_card_vs_cpu()

    bsz = BATCH_SIZE
    widest = max(FFN_SITES, key=lambda s: s[1] * rows[s[0] * bsz]["bound_ms"])
    kernels = [{
        "name": "fused_ffn", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/ffn.cu",
        "replaces": "shgvqa_tpu/kernels/ffn.py:98",
        "launches": launches, "max_abs_err": max_err,
        "ms": per_forward(rows, bsz, "kernel_ms"),
        "plain_ms": per_forward(rows, bsz, "plain_ms"),
        "bound_ms": per_forward(rows, bsz, "bound_ms"),
        "bound_by": rows[widest[0] * bsz]["bound_by"], "library_ms": None,
    }]
    log(f"per forward at b{bsz} (18 FFN sites): kernel "
        f"{kernels[0]['ms']:.3f} ms, plain {kernels[0]['plain_ms']:.3f} ms, "
        f"yardstick {per_forward(rows, bsz, 'yardstick_ms'):.3f} ms, bound "
        f"{kernels[0]['bound_ms']:.3f} ms; b2: kernel "
        f"{per_forward(rows, 2, 'kernel_ms'):.3f} ms, plain "
        f"{per_forward(rows, 2, 'plain_ms'):.3f} ms, bound "
        f"{per_forward(rows, 2, 'bound_ms'):.3f} ms; clips/s b{bsz} "
        f"{json.dumps(cps)}")
    for backward, (name, line) in enumerate(
            (("fused_attention_fwd", 143), ("fused_attention_bwd", 171))):
        pre = "bwd_" if backward else ""
        widest = max(ATTN_SITES, key=lambda s: (s[6] if backward else s[5])
                     * attn_rows[(s[0], bsz)][pre + "bound_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "shgvqa_tpu_torch/csrc/attention.cu",
            "replaces": f"shgvqa_tpu/kernels/attention.py:{line}",
            "launches": train_launches[backward],
            "max_abs_err": attn_err["bwd" if backward else "fwd"],
            "ms": per_step(attn_rows, bsz, pre + "kernel_ms", backward),
            "plain_ms": per_step(attn_rows, bsz, pre + "plain_ms", backward),
            "bound_ms": per_step(attn_rows, bsz, pre + "bound_ms", backward),
            "bound_by": attn_rows[(widest[0], bsz)][pre + "bound_by"],
            "library_ms": per_step(attn_rows, bsz, pre + "library_ms",
                                   backward),
        })
        log(f"{name} per train step at b{bsz} ({train_launches[backward]} "
            f"sites): " + ", ".join(
                f"{k} {per_step(attn_rows, b, pre + k, backward):.3f} ms at "
                f"b{b}" for k in ("kernel_ms", "plain_ms", "library_ms",
                                  "bound_ms") for b in (bsz, 2)))
    log(f"train clips/s b{bsz}: {json.dumps(train_cps)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

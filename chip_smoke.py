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
   time and the bound.  Every kernel, library and yardstick time is the
   median [min-max] of 5 turns of 20 calls (CUDA events); a plain version
   is timed in one turn:
   - the FFN forward (and its autograd backward at a small shape), beside
     a composite-of-library-calls yardstick;
   - both attention kernels at every attention site of the train step at
     B=2 and B=32: the forward and dQ, dK, dV at rate 0, and at the site's
     dropout rate with the kernels' own keep mask given to the plain
     version; the realised keep rate, and at one site per batch size the
     card's keep mask bit-equal to ``keep_mask_reference``; the largest
     difference between two backward calls on the same inputs (dQ is
     summed with atomics); the kernels and SDPA with the same additive
     mask (timed only) each at rate 0 and at the site's rate, forward and
     backward, and the kernels' device time per call from torch.profiler;
   - both FFN train kernels (forward and backward, ``csrc/ffn_train.cu``)
     at every FFN site's shape of the train step (M = B * L, L in 40, 177,
     393) at B=2 and B=32: y and every gradient against autograd of the
     plain version at rate 0, and at rate 0.1 with the kernels' own keep
     mask given to the plain version; the realised keep rate; the times of
     the kernels, of the weight-gradient products after the backward
     kernel, of the plain version and of the unfused yardstick;
   - the tokenizer conv kernel (``csrc/tok_conv.cu``) at both convs'
     shapes and the bottleneck kernel (``csrc/bottleneck.cu``) at ragged
     frames and at its three trunk geometries (res_2 block_0 with its
     projection, res_2, res_3), at B=2 and B=32: kernel against plain
     within 2e-2 of max |plain|, the times of the kernel, the plain version
     and a yardstick (F.conv3d in bf16 + gelu; the unfused bf16
     Bottleneck3D) and the bound;
   - the attention-output kernel (``csrc/out_ln.cu``) at every AttOutput
     site's shape (M = B * L, L in 40, 177, 393) at B=2 and B=32 within
     3e-2 * max(1, |ref|) of ``out_ln_reference`` (and its autograd
     backward at a small shape), with the times of the kernel, the plain
     version and the unfused yardstick (F.linear, add, F.layer_norm) and
     the bound;
   - the head-sliced attention kernel (``csrc/headsliced_attn.cu``) at
     every attention site's shape at B=2 and B=32 within 2e-2 of max |ref|
     of ``headsliced_reference`` and of the transpose path (the fused
     attention forward on (B, H, L, 64) views of the same projections), with
     the times of the kernel, the plain version, the transpose path and
     SDPA with the same additive mask (timed only) and the bound; then the
     prototype's own A/B (``tools/proto_headsliced_attn.py``): B=64, (40,
     40), (393, 393), (128, 393), a 10% key mask, the max error between the
     two paths and both times, one line per shape;
4. main path: ``entry.entry()`` -- the flagship uint8 frames -> hg_logit
   forward at B=2 -- with every launch count set to 0 just before and read
   just after: with the FFN kernel (18 launches), with no kernel, with
   the FFN, tokenizer and bottleneck kernels (18 + 2 + 6), with the FFN
   and the attention forward at every site (``--pallasAttention``: 18 +
   38), and with the FFN, out_ln and head-sliced kernels (18 + 18 + 38);
   each kernel path's hg_logit against the plain one;
5. throughput: clips/s at B=32 with the FFN kernel, with no kernel, with
   the FFN, tokenizer and bottleneck kernels, with the FFN and attention
   kernels, and with the FFN, out_ln and head-sliced kernels, in turns;
6. train main path: ``entry.train_entry()`` -- three flagship train steps
   at B=32 with the tokenizer and bottleneck switches on -- with the
   launch counts set to 0 before each step and read after it (38
   attention forwards, 34 backwards, 0 FFN, 0 tokenizer, 6 bottleneck);
   finite losses; the trainable parameters move, the trunk and the
   disconnected LXRT x-layers and pooler stay bit-identical; the eval step
   at B=2 (18 FFN, 2 tokenizer and 6 bottleneck launches, no attention
   launch); then, with every dropout rate at 0, the attention kernels
   against the plain attention and the FFN train kernels against the
   unfused FFN (loss and gradient norm); the switches off again;
7. train throughput: clips/s at B=32 with the attention kernels and with
   the plain attention, then with the FFN train kernels and with the
   unfused FFN (in turns), and the steps' splits;
8. the driver: ``cli.agqa_hgqa.main`` at the flagship flags with
   ``--pallasFFNTrain`` at B=32 on synthetic data under a temporary
   directory: two epochs with the launch counts set to 0 before each train
   step and eval forward and read after it (38 attention forwards, 34
   backwards, 18 FFN train forwards, 14 backwards, 0 FFN per train step;
   18 FFN and nothing else per eval forward), finite losses, CURRENT and
   LAST written and LAST reloaded bit-equal; then ``--test`` from
   ``--load LAST`` (oracle score 1.0, the predict files), and again with
   ``--pallasAttention`` (38 attention forwards and 18 FFN per eval
   forward);
9. the plain path, then two plain train steps, on the card against the
   CPU at tiny size in f32;
10. the card line, one ``{"kernels": [...]}`` line (nine kernels), and
    last ``{"ok": true, "device": {...}}``.

Launch counts are read as a tuple of nine: (attention forward, attention
backward, FFN, FFN train forward, FFN train backward, tokenizer conv,
bottleneck, out_ln, head-sliced attention).

TF32 is switched off for f32 matmuls and convolutions (phase 9 compares
f32 results).  ``bound_ms`` is max(operations / 989 TFLOP/s bf16, bytes /
3.35 TB/s): the H100 SXM's published dense peaks, each input read once and
each output written once.  ``--only attention`` (``--only ffn_train``,
``--only tok_block``, ``--only out_ln_headsliced``) runs phases 1-2 and the
attention (FFN train; tokenizer conv and bottleneck; out_ln and head-sliced
attention) checks of phase 3, and prints no result lines.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from shgvqa_tpu_torch import entry
from shgvqa_tpu_torch.cli import agqa_hgqa
from shgvqa_tpu_torch.bench import (
    BATCH_SIZE,
    card_name_and_power_limit,
    clips_per_second,
    time_ms,
    time_spread,
    train_clips_per_second,
    train_split_ms,
)
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.data.featurize import situation_causal_mask
from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.bottleneck import (
    bottleneck_reference,
    fused_bottleneck,
)
from shgvqa_tpu_torch.kernels.attention import (
    attention_reference,
    decompose_mask,
    draw_seed,
    fused_attention,
    keep_mask,
    keep_mask_reference,
)
from shgvqa_tpu_torch.kernels import ffn as ffn_kernels
from shgvqa_tpu_torch.kernels.ffn import (
    ffn_reference,
    ffn_train_reference,
    fused_ffn,
    fused_ffn_train,
    fused_out_ln,
    keep_mask as ffn_keep_mask,
    out_ln_reference,
)
from shgvqa_tpu_torch.kernels.headsliced import (
    headsliced_attention,
    headsliced_reference,
)
from shgvqa_tpu_torch.kernels.tok_conv import fused_tok_conv, tok_conv_reference
from shgvqa_tpu_torch.models.backbone import Bottleneck3D, set_block_kernel
from shgvqa_tpu_torch.models.layers import (
    FFN,
    Dropout,
    extend_mask,
    gelu,
    init_weights,
    set_attention_kernel,
    set_attention_kernel_eval,
    set_dropout_rate,
    set_ffn_train_kernel,
    set_headsliced_kernel,
    set_out_ln_kernel,
)
from shgvqa_tpu_torch.models.visual import set_tok_kernel
from shgvqa_tpu_torch.train import loop
from shgvqa_tpu_torch.train.loop import Trainer
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
# FFN sites of one flagship train step: (rows per clip, forward launches,
# backward launches).  The LXRT x-layers' FFNs (2 language, 2 visual) feed
# only the unsupervised `logit`, so their backward never runs.
FFN_TRAIN_SITES = ((40, 9, 7), (393, 7, 5), (177, 2, 2))
FFN_TRAIN_RATE = 0.1                   # the FFN's hidden_dropout
FFN_OPERANDS = ("x", "W1", "b1", "W2", "b2", "gamma", "beta")
# max |kernel grad - autograd of the plain version on f32 copies| <= tol *
# max |ref| (the kernels round do and du to bf16 before their products and
# the weight gradients to bf16)
FFN_GRAD_TOL = 3e-2
# tokenizer convs of one flagship forward: (site, T in, Ci); Co = 768, 7 x 7
# features, kernel (5, 3, 3)
TOK_SITES = (("conv1", 16, 2048), ("conv2", 12, D))
TOK_HW, TOK_KT = 7, 5
# trunk blocks the fused bottleneck covers in one flagship forward: (site,
# H = W, Ci, Cm, Co, projection, blocks); frames N = 16 * B
BLOCK_SITES = (("res_2 block_0", 56, 64, 64, 256, True, 1),
               ("res_2 blocks 1-2", 56, 256, 64, 256, False, 2),
               ("res_3 blocks 1-3", 28, 512, 128, 512, False, 3))
# max |kernel - plain| <= tol * max |plain| (bf16; the prototypes' own check)
TOK_BLOCK_TOL = 2e-2
# the flagship's published flags (README.md, agqa_hgqa) with the FFN train
# kernels; the port raises without --LossHGPerFrame (the global matcher,
# ROADMAP item 8) and --freezeBackbone (training the trunk, item 11)
DRIVER_FLAGS = ["--taskHGQA", "--noCaps", "--crossAttnType", "cross",
                "--llayers", "5", "--xlayers", "2", "--rlayers", "5",
                "--dlayers", "5", "--backbone", "slow_r50", "--fromScratch",
                "--LossHGPerFrame", "--freezeBackbone", "--pallasFFNTrain"]


def log(msg: str) -> None:
    print(msg, flush=True)


def spread(name, fn, **kw):
    """{name: median ms, name + "_range": [min, max]} of ``time_spread``."""
    med, (lo, hi) = time_spread(fn, **kw)
    return {name: med, name + "_range": [lo, hi]}


def bound_ms(flops, nbytes):
    """(ms, bound_by): the larger of operations over the bf16 peak and bytes
    over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ffn_bound(m: int, d: int = D, f: int = FF):
    flops = 4 * m * d * f
    nbytes = 2 * m * d * 2 + 2 * d * f * 2 + (f + 3 * d) * 4
    return bound_ms(flops, nbytes)


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
                    M=m, **spread("kernel_ms", lambda: fused_ffn(*args)),
                    plain_ms=time_ms(lambda: ffn_reference(*args)),
                    **spread("yardstick_ms", yard), bound_ms=bound,
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


def ffn_train_bound(m: int, backward: bool, d: int = D, f: int = FF):
    """(ms, bound_by) of one train-kernel call: 4 (forward) or 8 (backward)
    M*D*F products (the JAX cost estimates, ffn.py:290 and :337) over the
    bf16 peak, against its bytes over the memory rate: forward x, y, W1, W2
    and the f32 vectors; backward x, dy, dx, do (M, D), du, h (M, F), W1,
    W2 (bf16) and the f32 vectors, dgamma, dbeta."""
    if backward:
        flops = 8 * m * d * f
        nbytes = (4 * m * d + 2 * m * f + 2 * d * f) * 2 + (f + 4 * d) * 4
    else:
        flops = 4 * m * d * f
        nbytes = (2 * m * d + 2 * d * f) * 2 + (f + 3 * d) * 4
    return bound_ms(flops, nbytes)


def ffn_train_grads_vs_plain(tag, ops, y, dy, rate, keep):
    """Gradients of ``y`` (the kernels' output) at ``dy`` against autograd of
    ffn_train_reference on f32 copies with the same keep mask: the worst
    (max |err|, that over max |ref|) over dx, dW1, db1, dW2, db2, dgamma,
    dbeta."""
    grads = torch.autograd.grad(y, ops, dy, retain_graph=True)
    ref_ops = [o.detach().float().requires_grad_(True) for o in ops]
    ref = ffn_train_reference(*ref_ops, rate, keep)
    refs = torch.autograd.grad(ref, ref_ops, dy.float())
    errs = [rel_max_err(f"{tag} d{name}", gr, rr, FFN_GRAD_TOL)
            for name, gr, rr in zip(FFN_OPERANDS, grads, refs)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def phase_ffn_train_kernels(batch_sizes=(2, BATCH_SIZE)):
    """Both FFN train kernels against the plain version at every main-path
    shape (M = B * L for L in 40, 177, 393): y and every gradient at rate 0,
    and at rate 0.1 with the kernels' own keep mask given to the plain
    version; the realised keep rate; the times of the kernels, of the
    weight-gradient products after the backward kernel, of the plain
    version and of the unfused yardstick (F.linear, GeLU, dropout,
    layer_norm, and its autograd backward)."""
    rows = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    rate = FFN_TRAIN_RATE
    for bsz in batch_sizes:
        for per_clip, _, _ in FFN_TRAIN_SITES:
            m = per_clip * bsz
            tag = f"fused_ffn_train M={m}"
            ops = [a.detach().requires_grad_(True)
                   for a in ffn_operands(m, seed=1000 + m)]
            dy = torch.randn(m, D, device="cuda").to(torch.bfloat16)
            # rate 0
            y0 = fused_ffn_train(*ops, 0.0)
            e0 = check_close(f"{tag} rate 0", y0,
                             ffn_train_reference(*ops, 0.0, None))
            g0, r0 = ffn_train_grads_vs_plain(f"{tag} rate 0", ops, y0, dy,
                                              0.0, None)
            # rate > 0: the seed the call draws is read back from a copy of
            # the generator's state, and the kernels' keep mask from it
            gen = torch.Generator(device="cuda").manual_seed(m)
            state = gen.get_state()
            y1 = fused_ffn_train(*ops, rate, gen)
            gen.set_state(state)
            keep = ffn_keep_mask(draw_seed(gen, ops[0].device), m, D, rate)
            kept = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            if abs(kept - (1 - rate)) > 6 * sigma:
                raise AssertionError(f"{tag}: keep rate {kept} vs {1 - rate}"
                                     f" (6 sigma {6 * sigma})")
            e1 = check_close(f"{tag} rate {rate}", y1,
                             ffn_train_reference(*ops, rate, keep))
            g1, r1 = ffn_train_grads_vs_plain(f"{tag} rate {rate}", ops, y1,
                                              dy, rate, keep)
            max_err["fwd"] = max(max_err["fwd"], e0, e1)
            max_err["bwd"] = max(max_err["bwd"], g0, g1)

            # times
            x2, w1t, b1, w2t, b2, gamma, beta = (o.detach() for o in ops)
            seed = draw_seed(gen, x2.device)
            spills = ffn_kernels._launch_train_bwd(
                x2, w1t, b1, w2t, b2, gamma, seed, rate, 1e-12, dy)
            plain_out = ffn_train_reference(*ops, rate, keep)
            hidden = F.linear(ops[0], ops[1], ops[2].to(torch.bfloat16))
            yard_out = F.layer_norm(
                ops[0] + F.dropout(F.linear(F.gelu(hidden), ops[3],
                                            ops[4].to(torch.bfloat16)), rate),
                (D,), ops[5].to(torch.bfloat16), ops[6].to(torch.bfloat16),
                1e-12)
            with torch.no_grad():
                timed = dict(
                    **spread("kernel_ms", lambda: fused_ffn_train(
                        *ops, rate, gen)),
                    plain_ms=time_ms(lambda: ffn_train_reference(
                        *ops, rate, keep)),
                    **spread("yardstick_ms", lambda: F.layer_norm(
                        x2 + F.dropout(F.linear(F.gelu(F.linear(
                            x2, w1t, b1.to(x2.dtype))), w2t,
                            b2.to(x2.dtype)), rate),
                        (D,), gamma.to(x2.dtype), beta.to(x2.dtype), 1e-12)),
                    **spread("bwd_kernel_ms",
                             lambda: ffn_kernels._launch_train_bwd(
                                 x2, w1t, b1, w2t, b2, gamma, seed, rate,
                                 1e-12, dy)),
                    **spread("wgrad_ms", lambda: ffn_kernels._weight_grads(
                        x2, spills[1], spills[2], spills[3])))
            timed.update(
                bwd_plain_ms=time_ms(lambda: torch.autograd.grad(
                    plain_out, ops, dy, retain_graph=True)),
                **spread("bwd_yardstick_ms", lambda: torch.autograd.grad(
                    yard_out, ops, dy, retain_graph=True)))
            del spills, plain_out, yard_out, hidden
            bound, bound_by = ffn_train_bound(m, False)
            bwd_bound, bwd_bound_by = ffn_train_bound(m, True)
            rows[m] = dict(M=m, keep_rate=kept, err_fwd=max(e0, e1),
                           err_grads=max(g0, g1), rel_err_grads=max(r0, r1),
                           bound_ms=bound, bound_by=bound_by,
                           bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_bound_by,
                           **timed)
            log(f"fused_ffn_train {json.dumps(rows[m])}")
    return rows, max_err


def per_train_step(rows, bsz, key, backward=False):
    """Sum over the FFN sites of one train step of ``key``."""
    return sum((nb if backward else nf) * rows[per_clip * bsz][key]
               for per_clip, nf, nb in FFN_TRAIN_SITES)


def attention_bound(b, lq, lk, key, pane, backward: bool, lse: bool = True):
    """(ms, bound_by) of one call: 4 (forward) or 10 (backward) products of
    g*Lq*Lk*64 (the JAX cost estimates, attention.py:247 and :277) over the
    bf16 peak, against its bytes (bf16 operands and results, f32 masks and
    logsumexp -- none for the head-sliced kernel, ``lse=False`` -- each read
    or written once) over the memory rate."""
    g, d = b * H, HEAD_DIM
    flops = (10 if backward else 4) * g * lq * lk * d
    operands = (2 * g * lq * d + 2 * g * lk * d) * 2        # q, o, k, v
    masks = (0 if key is None else b * lk * 4) + (0 if pane is None
                                                  else lq * lk * 4)
    nbytes = operands + masks + (g * lq * 4 if lse else 0)
    if backward:
        nbytes += (2 * g * lq * d + 2 * g * lk * d) * 2     # do, dq, dk, dv
    return bound_ms(flops, nbytes)


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


def fwd_and_grads(q, k, v, mask, rate, generator, keep, tag):
    """The forward (at ``rate`` with ``generator``) and dQ, dK, dV against
    the plain version given ``keep``: (out, do, leaves, fwd (max |err|,
    rel), grads (max |err|, rel))."""
    leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
    out = fused_attention(*leaves, mask, rate, generator)
    fwd = rel_max_err(f"attention fwd rate {rate} {tag}", out,
                      attention_reference(q, k, v, mask, rate, keep),
                      ATTN_TOL)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    grads = grad_errors(f"attention rate {rate} {tag}", *leaves, mask, rate,
                        keep, out, do)
    return out, do, leaves, fwd, grads


def device_ms(fn, own=(), calls: int = 10, tries: int = 3):
    """Device ms per call of ``fn`` from torch.profiler over ``calls`` + 1
    calls: (the kernels whose names hold one of ``own``, every kernel's),
    each kernel's mean time times its launches per call.  The profiler can
    miss the first kernel of a session (so launches per call are rounded)
    or a whole session (so it tries again); (None, None) when ``tries``
    traces hold no device time or ``own`` kernels do not launch once a
    call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls + 1):
                fn()
            torch.cuda.synchronize()
        mine = total = 0.0
        per_call = {name: 0 for name in own}
        for evt in prof.key_averages():
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or not evt.count):
                continue
            n = round(evt.count / (calls + 1))
            ms = evt.device_time_total / evt.count * n / 1e3
            total += ms
            for name in own:
                if name in evt.key:
                    mine += ms
                    per_call[name] += n
        if total > 0.0 and all(n == 1 for n in per_call.values()):
            return mine, total
    log(f"profiler: launches per call {per_call}, {total} ms a call, after "
        f"{tries} traces")
    return None, None


# the site whose card keep mask is held bit-equal to keep_mask_reference,
# per batch size
KEEP_CHECK_SITES = {2: "visual self", BATCH_SIZE: "rel decoder self"}


def phase_attention_kernels(batch_sizes=(2, BATCH_SIZE)):
    """Both attention kernels against the plain version at every main-path
    shape: the forward and dQ, dK, dV at rate 0 and at the site's rate with
    the kernels' own keep mask fed to the plain version; the realised keep
    rate, and the card's keep mask bit-equal to keep_mask_reference at one
    site per batch size; the largest difference between two backward calls
    on the same inputs; the times (median [min-max] over 5 turns) of the
    kernels and of SDPA, each at rate 0 and at the site's rate, of SDPA's
    forward and backward in one call, of the plain version (one turn), and
    the kernels' device time per call from torch.profiler."""
    rows = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for bsz in batch_sizes:
        for i, (name, lq, lk, kind, rate, _, _) in enumerate(ATTN_SITES):
            q, k, v, mask = attention_operands(bsz, lq, lk, kind, 100 + i)
            key, pane = decompose_mask(mask, bsz, H, lq, lk)
            tag = f"{name} b{bsz} ({lq}, {lk})"
            out0, do0, leaves0, (e0, r0), (e3, r3) = fwd_and_grads(
                q, k, v, mask, 0.0, None, None, tag)
            # rate > 0: the seed the call draws is read back from a copy of
            # the generator's state, and the kernels' keep mask from it
            g = torch.Generator(device="cuda").manual_seed(7 + i)
            state = g.get_state()
            seed = draw_seed(g, q.device)
            g.set_state(state)
            keep = keep_mask(seed, bsz * H, lq, lk, rate).view(bsz, H, lq, lk)
            kept = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            if abs(kept - (1 - rate)) > 6 * sigma + 1e-9:
                raise AssertionError(f"{tag}: keep rate {kept} vs {1 - rate}"
                                     f" (6 sigma {6 * sigma})")
            if KEEP_CHECK_SITES[bsz] == name:
                want = keep_mask_reference(seed, bsz * H, lq, lk, rate)
                if not torch.equal(keep.view(bsz * H, lq, lk).cpu(), want):
                    raise AssertionError(f"{tag}: keep_mask differs from "
                                         "keep_mask_reference")
                log(f"attention keep_mask {tag} rate {rate}: bit-equal to "
                    f"keep_mask_reference ({keep.numel()} elements)")
            out, do, leaves, (e1, r1), (e2, r2) = fwd_and_grads(
                q, k, v, mask, rate, g, keep, tag)
            # two backward calls on the same inputs: dQ sums with atomics
            first = torch.autograd.grad(out, leaves, do, retain_graph=True)
            second = torch.autograd.grad(out, leaves, do, retain_graph=True)
            rerun = max((a.float() - b_.float()).abs().max().item()
                        for a, b_ in zip(first, second))
            max_err["fwd"] = max(max_err["fwd"], e0, e1)
            max_err["bwd"] = max(max_err["bwd"], e2, e3)

            # times: kernels and SDPA at rate 0 and at the site's rate, the
            # plain version at the site's rate
            plain_out = attention_reference(*leaves, mask, rate, keep)
            sdpa_mask = sdpa_additive_mask(bsz, lq, lk, key, pane)
            sdpa0 = F.scaled_dot_product_attention(*leaves0, sdpa_mask)
            sdpa1 = F.scaled_dot_product_attention(*leaves, sdpa_mask,
                                                   dropout_p=rate)

            def grad(y, xs, dy):
                return lambda: torch.autograd.grad(y, xs, dy,
                                                   retain_graph=True)

            fns = {
                "kernel0_ms": lambda: fused_attention(q, k, v, mask),
                "kernel_ms": lambda: fused_attention(q, k, v, mask, rate, g),
                "library0_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, sdpa_mask),
                "library_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, sdpa_mask, dropout_p=rate),
                "bwd_kernel0_ms": grad(out0, leaves0, do0),
                "bwd_kernel_ms": grad(out, leaves, do),
                "bwd_library0_ms": grad(sdpa0, leaves0, do0),
                "bwd_library_ms": grad(sdpa1, leaves, do),
                # SDPA forward and backward in one call, as a step runs them
                "fwd_bwd_library_ms": lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(*leaves, sdpa_mask,
                                                   dropout_p=rate),
                    leaves, do),
            }
            timed = {}
            for key_ms, fn in fns.items():
                timed.update(spread(key_ms, fn))
            timed.update(
                plain_ms=time_ms(lambda: attention_reference(
                    q, k, v, mask, rate, keep)),
                bwd_plain_ms=time_ms(grad(plain_out, leaves, do)))
            fwd_own = ("attn_fwd_kernel",)
            bwd_own = ("attn_bwd_prep_kernel", "attn_bwd_kernel",
                       "attn_bwd_dq_kernel")
            for key_ms, own in (("kernel0_ms", fwd_own),
                                ("kernel_ms", fwd_own),
                                ("bwd_kernel0_ms", bwd_own),
                                ("bwd_kernel_ms", bwd_own),
                                ("library0_ms", ()), ("library_ms", ()),
                                ("bwd_library0_ms", ()),
                                ("bwd_library_ms", ())):
                mine, total = device_ms(fns[key_ms], own)
                if own:
                    timed[key_ms.replace("_ms", "_device_ms")] = mine
                timed[key_ms.replace("_ms", "_device_all_ms")] = total
            del plain_out, sdpa0, sdpa1, first, second
            bound, bound_by = attention_bound(bsz, lq, lk, key, pane, False)
            bwd_bound, bwd_bound_by = attention_bound(bsz, lq, lk, key, pane,
                                                      True)
            rows[(name, bsz)] = dict(
                site=name, B=bsz, Lq=lq, Lk=lk, mask=kind, rate=rate,
                keep_rate=kept, err_fwd=max(e0, e1), err_grads=max(e2, e3),
                rel_err_fwd=max(r0, r1), rel_err_grads=max(r2, r3),
                bwd_rerun_max_diff=rerun, bound_ms=bound, bound_by=bound_by,
                bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_bound_by, **timed)
            log(f"fused_attention {json.dumps(rows[(name, bsz)])}")
        rerun = max(rows[(n, bsz)]["bwd_rerun_max_diff"]
                    for n, *_ in ATTN_SITES)
        log(f"attention b{bsz}: largest difference between two backward "
            f"calls on the same inputs (dQ sums with f32 atomics) {rerun}")
    return rows, max_err


def sdpa_additive_mask(bsz, lq, lk, key, pane):
    """The decomposed masks as one bf16 additive mask for SDPA, or None."""
    if key is None and pane is None:
        return None
    mask = torch.zeros(bsz if key is not None else 1, 1, lq, lk,
                       device="cuda")
    if key is not None:
        mask = mask + key[:, None, None, :]
    if pane is not None:
        mask = mask + pane
    return mask.to(torch.bfloat16)


def per_step(rows, bsz, key, backward=False):
    """Sum over the attention sites of one train step of ``key`` (None if a
    site has none)."""
    values = [(nb if backward else nf) * rows[(name, bsz)][key]
              if rows[(name, bsz)][key] is not None else None
              for name, _, _, _, _, nf, nb in ATTN_SITES]
    return None if None in values else sum(values)


def per_step_text(rows, bsz, key, backward=False):
    """``key`` summed over one train step's sites, and for a timed key the
    sums of the sites' fastest and slowest turns: "x [lo-hi]"."""
    total = per_step(rows, bsz, key, backward)
    if total is None:
        return "not measured"
    text = f"{total:.3f}"
    if key + "_range" in rows[(ATTN_SITES[0][0], bsz)]:
        lo, hi = (sum((nb if backward else nf)
                      * rows[(name, bsz)][key + "_range"][i]
                      for name, _, _, _, _, nf, nb in ATTN_SITES)
                  for i in (0, 1))
        text += f" [{lo:.3f}-{hi:.3f}]"
    return text


# per train step keys of the attention rows: kernel and SDPA at rate 0 and
# at the site's rate (timed), the plain version, the bound, the kernels'
# device time per call (profiler), and every kernel's in the kernels' call
# and in SDPA's
ATTN_STEP_KEYS = ("kernel0_ms", "kernel_ms", "library0_ms", "library_ms",
                  "plain_ms", "bound_ms", "kernel0_device_ms",
                  "kernel_device_ms", "kernel0_device_all_ms",
                  "kernel_device_all_ms", "library0_device_all_ms",
                  "library_device_all_ms")


def attention_entries(rows, max_err, launches=None, bsz=BATCH_SIZE):
    """The forward and backward kernels' entries of the kernels line (at
    the sites' rates, SDPA at the same rate as the library call), with one
    log line each of their per-step sums at every batch size."""
    entries = []
    sizes = sorted({b for _, b in rows}, reverse=True)
    for backward, (name, line) in enumerate(
            (("fused_attention_fwd", 143), ("fused_attention_bwd", 171))):
        pre = "bwd_" if backward else ""
        widest = max(ATTN_SITES, key=lambda s: (s[6] if backward else s[5])
                     * rows[(s[0], bsz)][pre + "bound_ms"])
        entries.append({
            "name": name, "route": "cuda",
            "source": "shgvqa_tpu_torch/csrc/attention.cu",
            "replaces": f"shgvqa_tpu/kernels/attention.py:{line}",
            "launches": None if launches is None else launches[backward],
            "max_abs_err": max_err["bwd" if backward else "fwd"],
            "ms": per_step(rows, bsz, pre + "kernel_ms", backward),
            "plain_ms": per_step(rows, bsz, pre + "plain_ms", backward),
            "bound_ms": per_step(rows, bsz, pre + "bound_ms", backward),
            "bound_by": rows[(widest[0], bsz)][pre + "bound_by"],
            "library_ms": per_step(rows, bsz, pre + "library_ms", backward),
        })
        keys = [(k, pre + k) for k in ATTN_STEP_KEYS] + (
            [("fwd_bwd_library_ms",) * 2] if backward else [])
        for b in sizes:
            log(f"{name} per train step at b{b} ("
                + ("34" if backward else "38") + " sites; library: SDPA "
                "with the same additive mask; device: torch.profiler per "
                "call, the attention kernels' own / every kernel's): "
                + ", ".join(f"{k} {per_step_text(rows, b, rk, backward)}"
                            for k, rk in keys if rk in rows[(widest[0], b)]))
    return entries


def phase_tok_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The tokenizer conv kernel against tok_conv_reference at both convs'
    shapes (bf16); the times of the kernel on a bf16 weight, of the
    weight's cast from the f32 parameter (each call of the model makes it),
    of the plain version and of the yardstick (F.conv3d in bf16, then the
    port's gelu, on the same channels-last operands)."""
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        for bsz in batch_sizes:
            for site, t_len, ci in TOK_SITES:
                g = torch.Generator(device="cuda").manual_seed(bsz * 10 + ci)

                def randn(*shape):
                    return torch.randn(*shape, generator=g, device="cuda")

                x = randn(bsz, t_len, TOK_HW, TOK_HW, ci).to(torch.bfloat16)
                w32 = (0.02 * randn(D, ci, TOK_KT, 3, 3)).contiguous(
                    memory_format=torch.channels_last_3d)
                b = 0.02 * randn(D)
                w = w32.to(torch.bfloat16)
                tag = f"fused_tok_conv {site} b{bsz}"
                err, rel = rel_max_err(tag, fused_tok_conv(x, w, b),
                                       tok_conv_reference(x, w, b),
                                       TOK_BLOCK_TOL)
                max_err = max(max_err, err)
                xv = x.permute(0, 4, 1, 2, 3)
                m = bsz * (t_len - TOK_KT + 1) * TOK_HW * TOK_HW
                k = TOK_KT * 9 * ci
                bound, bound_by = bound_ms(
                    2 * m * D * k, (x.numel() + w.numel() + m * D) * 2 + 4 * D)
                rows[(site, bsz)] = dict(
                    site=site, B=bsz, M=m, N=D, K=k, max_abs_err=err,
                    rel_err=rel, bound_ms=bound, bound_by=bound_by,
                    **spread("kernel_ms", lambda: fused_tok_conv(x, w, b)),
                    **spread("cast_ms", lambda: w32.to(torch.bfloat16)),
                    plain_ms=time_ms(lambda: tok_conv_reference(x, w, b),
                                     iters=5, warmup=1),
                    **spread("yardstick_ms", lambda: gelu(F.conv3d(
                        xv, w, b.to(torch.bfloat16), padding=(0, 1, 1))),
                        iters=5, warmup=1))
                log(f"fused_tok_conv {json.dumps(rows[(site, bsz)])}")
    return rows, max_err


def random_block(ci, cm, co, seed):
    """A bf16 ``Bottleneck3D`` on the card (channels-last, as the model's)
    with seeded random weights and BN statistics."""
    block = init_weights(Bottleneck3D(ci, cm, co, dtype=torch.bfloat16), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in block.named_buffers():
            noise = torch.randn(buf.shape, generator=g)
            buf.copy_(1.0 + 0.2 * noise.abs() if name.endswith("var")
                      else 0.1 * noise)
        for name, prm in block.named_parameters():
            if name.startswith("bn"):
                noise = torch.randn(prm.shape, generator=g)
                prm.copy_(1.0 + 0.1 * noise if name.endswith("weight")
                          else 0.1 * noise)
    return block.to(device="cuda", memory_format=torch.channels_last_3d).eval()


def phase_block_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The fused bottleneck kernel against bottleneck_reference at the three
    block geometries it covers in the trunk (bf16, frames N = 16 B); the
    times of the kernel, of the plain version and of the yardstick (the
    port's unfused bf16 Bottleneck3D on the same weights and frames)."""
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        # ragged frames first: the last band of rows is short
        for hw, ci, cm, co in ((30, 64, 64, 256), (13, 512, 128, 512)):
            block = random_block(ci, cm, co, seed=hw)
            x = torch.relu(torch.randn(3, hw, hw, ci, device="cuda")).to(
                torch.bfloat16)
            ops = block.kernel_operands()
            err, _ = rel_max_err(f"fused_bottleneck {hw}x{hw} Ci={ci}",
                                 fused_bottleneck(x, *ops),
                                 bottleneck_reference(x, *ops), TOK_BLOCK_TOL)
            log(f"fused_bottleneck ragged {hw}x{hw} Ci={ci} Cm={cm} Co={co}: "
                f"max |err| {err}")
        for bsz in batch_sizes:
            for site, hw, ci, cm, co, proj, _ in BLOCK_SITES:
                block = random_block(ci, cm, co, seed=ci + cm)
                ops = block.kernel_operands()
                g = torch.Generator(device="cuda").manual_seed(bsz + ci)
                n = 16 * bsz
                x = torch.relu(torch.randn(n, hw, hw, ci, generator=g,
                                           device="cuda")).to(torch.bfloat16)
                xv = x.view(bsz, 16, hw, hw, ci).permute(0, 4, 1, 2, 3)
                tag = f"fused_bottleneck {site} b{bsz}"
                err, rel = rel_max_err(tag, fused_bottleneck(x, *ops),
                                       bottleneck_reference(x, *ops),
                                       TOK_BLOCK_TOL)
                max_err = max(max_err, err)
                macs = ci * cm + 9 * cm * cm + cm * co + (ci * co if proj
                                                          else 0)
                positions = n * hw * hw
                bound, bound_by = bound_ms(
                    2 * positions * macs,
                    positions * (ci + co) * 2 + macs * 2 + (4 * cm + 4 * co) * 2)
                rows[(site, bsz)] = dict(
                    site=site, B=bsz, frames=n, H=hw, Ci=ci, Cm=cm, Co=co,
                    proj=proj, max_abs_err=err, rel_err=rel, bound_ms=bound,
                    bound_by=bound_by,
                    **spread("kernel_ms", lambda: fused_bottleneck(x, *ops)),
                    plain_ms=time_ms(lambda: bottleneck_reference(x, *ops),
                                     iters=5, warmup=1),
                    **spread("yardstick_ms", lambda: block(xv), iters=5,
                             warmup=1))
                log(f"fused_bottleneck {json.dumps(rows[(site, bsz)])}")
                del block, x, xv
    return rows, max_err


def per_forward_tok(rows, bsz, key):
    return sum(rows[(site, bsz)][key] for site, _, _ in TOK_SITES)


def per_forward_block(rows, bsz, key):
    return sum(n * rows[(site, bsz)][key]
               for site, *_, n in BLOCK_SITES)


def out_ln_operands(m: int, d: int = D, seed: int = 0):
    """bf16 x (M, D), W (D, D) in nn.Linear layout, f32 b, bf16 residual
    (M, D), f32 gamma, beta."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(m, d).to(torch.bfloat16),
            (0.02 * randn(d, d)).to(torch.bfloat16), 0.02 * randn(d),
            randn(m, d).to(torch.bfloat16), 1.0 + 0.1 * randn(d),
            0.1 * randn(d))


def out_ln_bound(m: int, d: int = D):
    """(ms, bound_by) of one call: 2*M*D*D operations over the bf16 peak
    against x, residual, y (M, D) and W (D, D) in bf16 and b, gamma, beta in
    f32 over the memory rate (the JAX cost estimate, ffn.py:519-523, plus
    the vectors)."""
    return bound_ms(2 * m * d * d, (3 * m * d + d * d) * 2 + 3 * d * 4)


def phase_out_ln_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The attention-output kernel against out_ln_reference at every
    AttOutput site's shape (the FFN sites' rows, bf16), its autograd
    backward at a small shape, and the times of the kernel, the plain
    version and the unfused yardstick (F.linear, add, F.layer_norm in
    bf16)."""
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        for bsz in batch_sizes:
            for per_clip, _ in FFN_SITES:
                m = per_clip * bsz
                args = out_ln_operands(m, seed=2000 + m)
                err = check_close(f"fused_out_ln M={m}", fused_out_ln(*args),
                                  out_ln_reference(*args))
                max_err = max(max_err, err)
                x, w, b, res, gamma, beta = args
                bound, bound_by = out_ln_bound(m)
                rows[m] = dict(
                    M=m, **spread("kernel_ms", lambda: fused_out_ln(*args)),
                    plain_ms=time_ms(lambda: out_ln_reference(*args)),
                    **spread("yardstick_ms", lambda: F.layer_norm(
                        F.linear(x, w, b.to(x.dtype)) + res, (D,),
                        gamma.to(x.dtype), beta.to(x.dtype), 1e-12)),
                    bound_ms=bound, bound_by=bound_by, max_abs_err=err)
                log(f"fused_out_ln {json.dumps(rows[m])}")
    ops = [a.detach().requires_grad_(True)
           for a in out_ln_operands(64, 128, seed=9)]
    grads = torch.autograd.grad((fused_out_ln(*ops).float() ** 2).sum(), ops)
    refs = torch.autograd.grad((out_ln_reference(*ops).float() ** 2).sum(),
                               ops)
    for i, (g, r) in enumerate(zip(grads, refs)):
        check_close(f"fused_out_ln backward grad {i}", g, r)
    log("fused_out_ln backward ok (M=64, D=128)")
    return rows, max_err


def split_heads(x2):
    """(B, L, H*64) -> its (B, H, L, 64) view."""
    b, length, _ = x2.shape
    return x2.view(b, length, H, HEAD_DIM).transpose(1, 2)


def transpose_path(q2, k2, v2, mask):
    """The model's attention core before the head-sliced kernel: the fused
    attention forward at rate 0 on (B, H, L, 64) views of the projections,
    its output back to (B, Lq, H*64)."""
    b, lq, _ = q2.shape
    out = fused_attention(split_heads(q2), split_heads(k2), split_heads(v2),
                          mask)
    return out.transpose(1, 2).reshape(b, lq, D)


def phase_headsliced_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The head-sliced attention kernel against headsliced_reference and
    the transpose path at every attention site's shape (bf16 (B, L, 768)
    projections, the site's mask), and the times of the kernel, the plain
    version, the transpose path and SDPA with the same additive mask."""
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        for bsz in batch_sizes:
            for i, (name, lq, lk, kind, *_) in enumerate(ATTN_SITES):
                q, k, v, mask = attention_operands(bsz, lq, lk, kind, 300 + i)
                q2, k2, v2 = (x.transpose(1, 2).reshape(bsz, -1, D)
                              for x in (q, k, v))
                key, pane = decompose_mask(mask, bsz, H, lq, lk)
                tag = f"{name} b{bsz} ({lq}, {lk})"
                out = headsliced_attention(q2, k2, v2, mask, H)
                err, rel = rel_max_err(
                    f"headsliced {tag}", out, headsliced_reference(
                        q2, k2, v2, key, pane, heads=H), ATTN_TOL)
                err_t, rel_t = rel_max_err(
                    f"headsliced vs transpose path {tag}", out,
                    transpose_path(q2, k2, v2, mask), ATTN_TOL)
                max_err = max(max_err, err)
                sdpa_mask = sdpa_additive_mask(bsz, lq, lk, key, pane)
                bound, bound_by = attention_bound(bsz, lq, lk, key, pane,
                                                  False, lse=False)
                rows[(name, bsz)] = dict(
                    site=name, B=bsz, Lq=lq, Lk=lk, mask=kind,
                    max_abs_err=err, rel_err=rel,
                    max_abs_err_vs_transpose=err_t, rel_err_vs_transpose=rel_t,
                    bound_ms=bound, bound_by=bound_by,
                    **spread("kernel_ms", lambda: headsliced_attention(
                        q2, k2, v2, mask, H)),
                    plain_ms=time_ms(lambda: headsliced_reference(
                        q2, k2, v2, key, pane, heads=H)),
                    **spread("transpose_ms", lambda: transpose_path(
                        q2, k2, v2, mask)),
                    **spread("library_ms",
                             lambda: F.scaled_dot_product_attention(
                                 q, k, v, sdpa_mask)))
                log(f"headsliced_attention {json.dumps(rows[(name, bsz)])}")
    return rows, max_err


def phase_headsliced_ab(b=64, shapes=((40, 40), (393, 393), (128, 393))):
    """tools/proto_headsliced_attn.py's A/B on the card: the head-sliced
    kernel against the transpose path at B=64 with a 10% key mask of
    -10000, one line per shape."""
    with torch.inference_mode():
        for lq, lk in shapes:
            g = torch.Generator(device="cuda").manual_seed(lq * 1000 + lk)
            q2, k2, v2 = (torch.randn(b, n, D, generator=g, device="cuda").to(
                torch.bfloat16) for n in (lq, lk, lk))
            mask = torch.where(
                torch.rand(b, 1, 1, lk, generator=g, device="cuda") < 0.1,
                -10000.0, 0.0)
            tag = f"b{b} h{H} {lq}x{lk} d{HEAD_DIM}"
            err, _ = rel_max_err(f"headsliced A/B {tag}",
                                 headsliced_attention(q2, k2, v2, mask, H),
                                 transpose_path(q2, k2, v2, mask), ATTN_TOL)
            hs_ms, hs_range = time_spread(
                lambda: headsliced_attention(q2, k2, v2, mask, H))
            tr_ms, tr_range = time_spread(
                lambda: transpose_path(q2, k2, v2, mask))
            log("headsliced A/B " + json.dumps(dict(
                shape=tag, max_err_vs_transpose_path=err, headsliced_ms=hs_ms,
                headsliced_ms_range=hs_range, transpose_path_ms=tr_ms,
                transpose_path_ms_range=tr_range, speedup=tr_ms / hs_ms)))


def per_forward_attn(rows, bsz, key):
    """Sum over the attention sites of one inference forward of ``key``."""
    return sum(nf * rows[(name, bsz)][key]
               for name, _, _, _, _, nf, _ in ATTN_SITES)


def set_ffn_kernel(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, FFN):
            m.use_kernel = on


def set_inference_kernels(model, ffn: bool, tok_block: bool = False,
                          attention: bool = False,
                          out_ln_headsliced: bool = False) -> None:
    """The FFN kernel; the tokenizer and bottleneck kernels; the attention
    forward at every site (``--pallasAttention``); the out_ln and
    head-sliced kernels: each on or off."""
    set_ffn_kernel(model, ffn)
    set_tok_kernel(model, tok_block)
    set_block_kernel(model, tok_block)
    set_attention_kernel_eval(model, attention)
    set_out_ln_kernel(model, out_ln_headsliced)
    set_headsliced_kernel(model, out_ln_headsliced)


# inference modes of phases 4 and 5: name -> set_inference_kernels keywords
MODES = {
    "kernel": dict(ffn=True),
    "plain": dict(ffn=False),
    "tok_block": dict(ffn=True, tok_block=True),
    "attention": dict(ffn=True, attention=True),
    "out_ln_headsliced": dict(ffn=True, out_ln_headsliced=True),
}


# phase 4's forwards: (name, mode, launches per B=2 forward)
MAIN_RUNS = (
    ("FFN kernel", "kernel", (0, 0, 18, 0, 0, 0, 0, 0, 0)),
    ("plain", "plain", (0,) * 9),
    ("FFN + tok + block kernels", "tok_block", (0, 0, 18, 0, 0, 2, 6, 0, 0)),
    ("FFN + attention kernels", "attention", (38, 0, 18, 0, 0, 0, 0, 0, 0)),
    ("FFN + out_ln + headsliced", "out_ln_headsliced",
     (0, 0, 18, 0, 0, 0, 0, 18, 38)),
)


def phase_main_path():
    """entry.entry() at B=2 with launch counts from 0, on the same weights:
    with the FFN kernel (the default), with every kernel off, with the FFN,
    tokenizer and bottleneck kernels, with the FFN kernel and the attention
    forward at every site (``--pallasAttention``), and with the FFN, out_ln
    and head-sliced kernels; each kernel path's hg_logit against the plain
    one.  Returns the model and each run's launch counts."""
    t0 = time.perf_counter()
    fn, args = entry.entry()
    log(f"main path: flagship model built in {time.perf_counter() - t0:.1f} s")
    model, batch = args
    cfg = model.cfg
    want_shape = (batch["frames"].shape[0], cfg.num_answers)
    runs = {}
    for name, mode, want in MAIN_RUNS:
        set_inference_kernels(model, **MODES[mode])
        reset_counts()
        y = fn(*args)
        torch.cuda.synchronize()
        runs[name] = (y, counts())
        if runs[name][1] != want:
            raise AssertionError(f"{name} forward launched {runs[name][1]}, "
                                 f"expected {want}")
        if tuple(y.shape) != want_shape or not torch.isfinite(y).all():
            raise AssertionError(f"hg_logit ({name}) shape {tuple(y.shape)} "
                                 f"or non-finite values")
    set_inference_kernels(model, **MODES["kernel"])
    plain = runs["plain"][0].float()
    for name, _, _ in MAIN_RUNS:
        if name == "plain":
            continue
        out, launched = runs[name]
        rel = ((out.float() - plain).norm() / plain.norm()).item()
        agree = (out.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"main path ({name}): hg_logit {want_shape}, rel Frobenius vs "
            f"the plain path {rel:.3e}, argmax agreement {agree:.3f}, "
            f"launches ({COUNT_NAMES}) {launched}")
        if rel > 5e-2:
            raise AssertionError(f"hg_logit ({name}) differs from the plain "
                                 f"path by {rel}")
    return model, {name: launched for name, (_, launched) in runs.items()}


def phase_throughput(model):
    """clips/s at B=32 on the same weights, in turns: the FFN kernel
    ("kernel"), no kernel ("plain"), the FFN, tokenizer and bottleneck
    kernels ("tok_block"), the FFN and attention kernels ("attention") and
    the FFN, out_ln and head-sliced kernels ("out_ln_headsliced")."""
    batches = [entry.device_batch(model.cfg, BATCH_SIZE, seed)
               for seed in (0, 1)]
    order = ("kernel", "plain", "tok_block", "attention", "out_ln_headsliced")
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        set_inference_kernels(model, **MODES[name])
        runs[name].append(clips_per_second(model, batches))
    set_inference_kernels(model, **MODES["kernel"])
    log(f"throughput b{BATCH_SIZE} clips/s: {json.dumps(runs)}")
    return {k: sum(v) / len(v) for k, v in runs.items()}


COUNT_NAMES = ("attention fwd, bwd, ffn, ffn train fwd, bwd, tok, block, "
               "out_ln, headsliced")


def reset_counts():
    fused_ffn.launches = 0
    fused_attention.launches = 0
    fused_attention.bwd_launches = 0
    fused_ffn_train.launches = 0
    fused_ffn_train.bwd_launches = 0
    fused_tok_conv.launches = 0
    fused_bottleneck.launches = 0
    fused_out_ln.launches = 0
    headsliced_attention.launches = 0


def counts():
    """(attention forward, attention backward, FFN, FFN train forward, FFN
    train backward, tokenizer conv, bottleneck, out_ln, head-sliced
    attention) launches since ``reset_counts``."""
    return (fused_attention.launches, fused_attention.bwd_launches,
            fused_ffn.launches, fused_ffn_train.launches,
            fused_ffn_train.bwd_launches, fused_tok_conv.launches,
            fused_bottleneck.launches, fused_out_ln.launches,
            headsliced_attention.launches)


def grad_norm(params):
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.float().norm() if p.grad is not None
         else torch.zeros((), device="cuda") for p in params])).item()


def phase_train_main_path():
    """entry.train_entry() at B=32 with the tokenizer and bottleneck
    switches on: three train steps with every launch count set to 0 just
    before each and read just after (the tokenizer trains, so its kernel
    stays off; the frozen trunk's 6 blocks take theirs); the frozen and
    disconnected parameters stay bit-identical, the trainable ones move;
    the eval step at B=2; then the kernel path against the plain path on
    the same weights and batch with every dropout rate at 0.  Returns with
    the two switches off again."""
    t0 = time.perf_counter()
    model, optimizer, generator, batch = entry.train_entry()
    cfg = model.cfg
    log(f"train main path: flagship model and optimizer built in "
        f"{time.perf_counter() - t0:.1f} s")
    set_tok_kernel(model, True)
    set_block_kernel(model, True)
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
        log(f"train step {i}: launches ({COUNT_NAMES}) "
            f"{step_counts[-1]}; {json.dumps(values)}")
    if any(c != (38, 34, 0, 0, 0, 0, 6, 0, 0) for c in step_counts):
        raise AssertionError(f"train step launches {step_counts}, expected "
                             "38 attention forward, 34 backward, 0 FFN, 0 "
                             "tokenizer, 6 bottleneck")
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
    if eval_counts != (0, 0, 18, 0, 0, 2, 6, 0, 0):
        raise AssertionError(f"eval step launches {eval_counts}, expected 0 "
                             "attention, 18 FFN, 2 tokenizer, 6 bottleneck")
    log(f"eval step b2: launches {eval_counts}; rel/act class acc "
        f"{preds['rel_class_acc'].item():.2f} / "
        f"{preds['act_class_acc'].item():.2f}")

    # kernel path vs plain path with every dropout rate 0, same weights
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    set_dropout_rate(model, 0.0)
    results = {}
    model.train()
    # (attention kernels, FFN train kernels): the attention kernels against
    # the plain attention, then the FFN train kernels against the unfused
    # FFN with the attention kernels on
    for name, attn, ffn in (("kernel", True, False), ("plain", False, False),
                            ("ffn kernel", True, True)):
        set_attention_kernel(model, attn)
        set_ffn_train_kernel(model, ffn)
        optimizer.zero_grad()
        loss, _ = compute_losses(cfg, model(batch, generator), batch)
        loss.backward()
        results[name] = (loss.item(), grad_norm(optimizer.params))
    optimizer.zero_grad()
    set_attention_kernel(model, True)
    set_ffn_train_kernel(model, False)
    set_tok_kernel(model, False)
    set_block_kernel(model, False)
    for m, rate in rates.items():
        m.rate = rate
    for what, (name, ref) in (("attention", ("kernel", "plain")),
                              ("FFN", ("ffn kernel", "kernel"))):
        (lk, gk), (lp, gp) = results[name], results[ref]
        rel_loss, rel_grad = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        log(f"train kernel vs plain {what} (dropout 0, b{BATCH_SIZE}): loss "
            f"{lk:.6f} vs {lp:.6f} (rel {rel_loss:.2e}), grad norm {gk:.6f} "
            f"vs {gp:.6f} (rel {rel_grad:.2e})")
        if rel_loss > TRAIN_TOL or rel_grad > TRAIN_TOL:
            raise AssertionError(f"kernel and plain {what} train paths "
                                 f"differ: loss rel {rel_loss}, grad norm "
                                 f"rel {rel_grad}")
    return model, optimizer, generator, batch, step_counts[-1]


def phase_train_throughput(model, optimizer, generator, batch):
    """Train clips/s at B=32: kernel and plain attention in turns (unfused
    FFN), then the FFN train kernels and the unfused FFN in turns
    (attention kernels on); the step split of the attention-kernel step
    with each FFN."""
    step = make_train_step(model.cfg, model, optimizer)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        set_attention_kernel(model, name == "kernel")
        runs[name].append(train_clips_per_second(step, batch, generator))
    set_attention_kernel(model, True)
    split = train_split_ms(model, optimizer, batch, generator)
    ffn_runs = {"ffn_kernel": [], "ffn_plain": []}
    for name in ("ffn_kernel", "ffn_plain", "ffn_plain", "ffn_kernel"):
        set_ffn_train_kernel(model, name == "ffn_kernel")
        ffn_runs[name].append(train_clips_per_second(step, batch, generator))
    set_ffn_train_kernel(model, True)
    ffn_split = train_split_ms(model, optimizer, batch, generator)
    set_ffn_train_kernel(model, False)
    log(f"train throughput b{BATCH_SIZE} clips/s: {json.dumps(runs)}; "
        f"kernel step split ms {json.dumps(split)}")
    log(f"train throughput b{BATCH_SIZE} clips/s, FFN train kernels vs "
        f"unfused FFN (attention kernels on): {json.dumps(ffn_runs)}; step "
        f"split ms with the FFN train kernels {json.dumps(ffn_split)}")
    runs.update(ffn_runs)
    return {k: sum(v) / len(v) for k, v in runs.items()}


class _Counted:
    """Wraps the train and eval steps the driver's Trainer builds so that
    every launch count is set to 0 just before each step and read just
    after it; keeps the trained model."""

    def __init__(self):
        self.train, self.eval, self.losses, self.model = [], [], [], None

    def __enter__(self):
        self._saved = (loop.make_train_step, loop.make_eval_step)
        make_train, make_eval = self._saved

        def counted(make, sink, keep_loss):
            def build(cfg, model, *args, **kw):
                fn = make(cfg, model, *args, **kw)
                if keep_loss:
                    self.model = model

                def run(*a):
                    torch.cuda.synchronize()
                    reset_counts()
                    out = fn(*a)
                    torch.cuda.synchronize()
                    sink.append(counts())
                    if keep_loss:
                        self.losses.append(out["total_loss"].item())
                    return out
                return run
            return build

        loop.make_train_step = counted(make_train, self.train, True)
        loop.make_eval_step = counted(make_eval, self.eval, False)
        return self

    def __exit__(self, *exc):
        loop.make_train_step, loop.make_eval_step = self._saved


def run_main(argv):
    """``agqa_hgqa.main(argv)`` on the card; its stdout is captured, then
    printed.  Returns (result, stdout, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = agqa_hgqa.main(argv)
    finally:
        for line in out.getvalue().splitlines():
            log(f"  | {line}")
    return result, out.getvalue(), time.perf_counter() - t0


def phase_driver(tmp: str):
    """The agqa_hgqa driver at the flagship flags with --pallasFFNTrain at
    B=32 on synthetic data: two epochs (launch counts per train step and
    per eval forward, finite losses, checkpoints, LAST reloaded bit-equal),
    then the test protocol from --load LAST (oracle 1.0, predict files)."""
    out = os.path.join(tmp, "train")
    argv = DRIVER_FLAGS + ["--syntheticData", "64", "--syntheticValid", "32",
                           "--batchSize", str(BATCH_SIZE), "--epochs", "2",
                           "--logFreq", "1", "--output", out, "--dataDir",
                           tmp]
    with _Counted() as counted:
        result, stdout, seconds = run_main(argv)
    want_train = (38, 34, 0, 18, 14, 0, 0, 0, 0)
    want_eval = (0, 0, 18, 0, 0, 0, 0, 0, 0)
    if len(counted.train) != 4 or any(c != want_train for c in counted.train):
        raise AssertionError(f"driver train steps launched {counted.train}, "
                             f"expected 4 x {want_train}")
    if len(counted.eval) != 8 or any(c != want_eval for c in counted.eval):
        raise AssertionError(f"driver eval forwards launched {counted.eval}, "
                             f"expected 8 x {want_eval}")
    if not all(math.isfinite(v) for v in counted.losses):
        raise AssertionError(f"driver losses {counted.losses}")
    names = set(os.listdir(out))
    if not {"CURRENT", "LAST", "log.log", "metrics.jsonl"} <= names:
        raise AssertionError(f"driver output {sorted(names)}")
    epochs = [float(s) for s in re.findall(r"Epoch \d+: \d+ steps in "
                                           r"([\d.]+)s", stdout)]
    log(f"driver: {result['steps']} steps, launches per train step "
        f"({COUNT_NAMES}) {counted.train[0]}, "
        f"per eval forward {counted.eval[0]}; losses {counted.losses}; "
        f"epochs {epochs} s; history {result['history']}; files "
        f"{sorted(names)}; {seconds:.1f} s")

    train_counts = counted.train
    # LAST reloads bit-equal into a fresh model
    model, cfg = counted.model, counted.model.cfg
    fresh = entry.build_model(cfg, "cuda", seed=cfg.seed + 1)
    Trainer(cfg, 1, fresh, trainable_mask(fresh, cfg)).load(
        os.path.join(out, "LAST"))
    trained = model.state_dict()
    for name, value in fresh.state_dict().items():
        if not torch.equal(value, trained[name]):
            raise AssertionError(f"LAST reloads {name} differently")
    del fresh, trained, model, counted
    gc.collect()
    torch.cuda.empty_cache()
    log("driver: LAST reloads bit-equal")

    # the test protocol from LAST, then again with --pallasAttention (the
    # attention forward kernel at every site of each eval forward)
    for extra, want in (([], want_eval),
                        (["--pallasAttention"],
                         (38, 0, 18, 0, 0, 0, 0, 0, 0))):
        test_out = os.path.join(tmp, "test" + "".join(extra))
        argv_test = [a if a != out else test_out for a in argv] + [
            "--test", "test", "--load", os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            result, stdout, seconds = run_main(argv_test)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"the test protocol's oracle score {extra} "
                                 "is not 1.0")
        if len(counted.eval) != 4 or any(c != want for c in counted.eval):
            raise AssertionError(f"test forwards {extra} launched "
                                 f"{counted.eval}, expected 4 x {want}")
        for name in ("predict.json", "predict_hg.json"):
            with open(os.path.join(test_out, name)) as f:
                if len(json.load(f)) != 32:
                    raise AssertionError(f"{name} does not hold 32 answers")
        log(f"driver --test {' '.join(extra)}: oracle 1.0, predict files of "
            f"32 answers, launches per eval forward {counted.eval[0]}, "
            f"{seconds:.1f} s")
    return train_counts, epochs


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
    parser.add_argument("--only", choices=("attention", "ffn_train",
                                           "tok_block", "out_ln_headsliced"),
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
        attention_entries(attn_rows, attn_err)
        log(f"attention kernels ok; max errors {json.dumps(attn_err)}")
        return 0
    if args.only == "ffn_train":
        _, train_err = phase_ffn_train_kernels()
        log(f"FFN train kernels ok; max errors {json.dumps(train_err)}")
        return 0
    if args.only == "tok_block":
        _, tok_err = phase_tok_kernel()
        _, block_err = phase_block_kernel()
        log(f"tokenizer conv and bottleneck kernels ok; max errors {tok_err}, "
            f"{block_err}")
        return 0
    if args.only == "out_ln_headsliced":
        _, out_ln_err = phase_out_ln_kernel()
        _, hs_err = phase_headsliced_kernel()
        phase_headsliced_ab()
        log(f"out_ln and head-sliced attention kernels ok; max errors "
            f"{out_ln_err}, {hs_err}")
        return 0

    rows, max_err = phase_ffn_kernel()
    attn_rows, attn_err = phase_attention_kernels()
    train_rows, train_err = phase_ffn_train_kernels()
    tok_rows, tok_err = phase_tok_kernel()
    block_rows, block_err = phase_block_kernel()
    out_ln_rows, out_ln_err = phase_out_ln_kernel()
    hs_rows, hs_err = phase_headsliced_kernel()
    phase_headsliced_ab()
    model, main_launches = phase_main_path()
    launches = main_launches["FFN + tok + block kernels"]
    olhs_launches = main_launches["FFN + out_ln + headsliced"]
    cps = phase_throughput(model)
    del model
    train_model, optimizer, generator, batch, train_launches = (
        phase_train_main_path())
    train_cps = phase_train_throughput(train_model, optimizer, generator,
                                       batch)
    del train_model, optimizer, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        driver_counts, epoch_s = phase_driver(tmp)
    phase_plain_path_card_vs_cpu()
    phase_plain_train_step_card_vs_cpu()

    bsz = BATCH_SIZE
    widest = max(FFN_SITES, key=lambda s: s[1] * rows[s[0] * bsz]["bound_ms"])
    kernels = [{
        "name": "fused_ffn", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/ffn.cu",
        "replaces": "shgvqa_tpu/kernels/ffn.py:98",
        "launches": launches[2], "max_abs_err": max_err,
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
    kernels += attention_entries(attn_rows, attn_err, train_launches)
    for backward, (name, line) in enumerate(
            (("fused_ffn_train_fwd", 200), ("fused_ffn_train_bwd", 214))):
        pre = "bwd_" if backward else ""
        widest = max(FFN_TRAIN_SITES, key=lambda s: s[1 + backward]
                     * train_rows[s[0] * bsz][pre + "bound_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "shgvqa_tpu_torch/csrc/ffn_train.cu",
            "replaces": f"shgvqa_tpu/kernels/ffn.py:{line}",
            "launches": driver_counts[-1][3 + backward],
            "max_abs_err": train_err["bwd" if backward else "fwd"],
            "ms": per_train_step(train_rows, bsz, pre + "kernel_ms",
                                 backward),
            "plain_ms": per_train_step(train_rows, bsz, pre + "plain_ms",
                                       backward),
            "bound_ms": per_train_step(train_rows, bsz, pre + "bound_ms",
                                       backward),
            "bound_by": train_rows[widest[0] * bsz][pre + "bound_by"],
            "library_ms": None,
        })
        keys = ("kernel_ms", "plain_ms", "yardstick_ms", "bound_ms") + (
            ("wgrad_ms",) if backward else ())
        log(f"{name} per train step ({driver_counts[-1][3 + backward]} "
            f"sites; yardstick: the unfused F.linear/GeLU/dropout/layer_norm"
            + (" autograd backward" if backward else "") + "; "
            + ("wgrad: the weight-gradient products after the kernel; "
               if backward else "") + "no single library call computes "
            "this block): " + ", ".join(
                f"{k} {per_train_step(train_rows, b, (pre if k != 'wgrad_ms' else '') + k, backward):.3f} ms at b{b}"
                for k in keys for b in (bsz, 2)))
    kernels.append({
        "name": "fused_tok_conv", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/tok_conv.cu",
        "replaces": "tools/proto_tok_kernel.py:43",
        "launches": launches[5], "max_abs_err": tok_err,
        "ms": per_forward_tok(tok_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward_tok(tok_rows, bsz, "plain_ms"),
        "bound_ms": per_forward_tok(tok_rows, bsz, "bound_ms"),
        "bound_by": tok_rows[("conv1", bsz)]["bound_by"], "library_ms": None,
    })
    kernels.append({
        "name": "fused_bottleneck", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/bottleneck.cu",
        "replaces": "tools/proto_block_kernel.py:41",
        "launches": launches[6], "max_abs_err": block_err,
        "ms": per_forward_block(block_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward_block(block_rows, bsz, "plain_ms"),
        "bound_ms": per_forward_block(block_rows, bsz, "bound_ms"),
        "bound_by": block_rows[("res_2 blocks 1-2", bsz)]["bound_by"],
        "library_ms": None,
    })
    for name, per, site_rows, n, yard in (
            ("fused_tok_conv", per_forward_tok, tok_rows, launches[5],
             "F.conv3d in bf16 + the port's gelu"),
            ("fused_bottleneck", per_forward_block, block_rows, launches[6],
             "the port's unfused bf16 Bottleneck3D")):
        log(f"{name} per forward ({n} sites; yardstick: {yard}; no single "
            "library call computes this function): " + ", ".join(
                f"{k} {per(site_rows, b, k):.3f} ms at b{b}"
                for k in ("kernel_ms", "plain_ms", "yardstick_ms", "bound_ms")
                for b in (bsz, 2)))
    widest = max(FFN_SITES,
                 key=lambda s: s[1] * out_ln_rows[s[0] * bsz]["bound_ms"])
    kernels.append({
        "name": "fused_out_ln", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/out_ln.cu",
        "replaces": "shgvqa_tpu/kernels/ffn.py:479",
        "launches": olhs_launches[7], "max_abs_err": out_ln_err,
        "ms": per_forward(out_ln_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward(out_ln_rows, bsz, "plain_ms"),
        "bound_ms": per_forward(out_ln_rows, bsz, "bound_ms"),
        "bound_by": out_ln_rows[widest[0] * bsz]["bound_by"],
        "library_ms": None,
    })
    log(f"fused_out_ln per forward ({olhs_launches[7]} sites; yardstick: "
        "F.linear + add + F.layer_norm in bf16; no single library call "
        "computes this function): " + ", ".join(
            f"{k} {per_forward(out_ln_rows, b, k):.3f} ms at b{b}"
            for k in ("kernel_ms", "plain_ms", "yardstick_ms", "bound_ms")
            for b in (bsz, 2)))
    widest = max(ATTN_SITES,
                 key=lambda s: s[5] * hs_rows[(s[0], bsz)]["bound_ms"])
    kernels.append({
        "name": "headsliced_attention", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/headsliced_attn.cu",
        "replaces": "tools/proto_headsliced_attn.py:41",
        "launches": olhs_launches[8], "max_abs_err": hs_err,
        "ms": per_forward_attn(hs_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward_attn(hs_rows, bsz, "plain_ms"),
        "bound_ms": per_forward_attn(hs_rows, bsz, "bound_ms"),
        "bound_by": hs_rows[(widest[0], bsz)]["bound_by"],
        "library_ms": per_forward_attn(hs_rows, bsz, "library_ms"),
    })
    log(f"headsliced_attention per forward ({olhs_launches[8]} sites; "
        "library: SDPA with the same additive mask; transpose: the fused "
        "attention forward on (B, H, L, 64) views): " + ", ".join(
            f"{k} {per_forward_attn(hs_rows, b, k):.3f} ms at b{b}"
            for k in ("kernel_ms", "plain_ms", "transpose_ms", "library_ms",
                      "bound_ms")
            for b in (bsz, 2)))
    log(f"train clips/s b{bsz}: {json.dumps(train_cps)}; driver epochs "
        f"{epoch_s} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

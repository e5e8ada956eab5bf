"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a).  Every phase raises on failure and
the script then exits non-zero; without a card, or outside the repository,
it exits non-zero before printing any result.

1. card: its name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every ``shgvqa_tpu_torch/csrc/*.cu``, one nvcc each, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, forward (and the FFN's autograd
   backward at a small shape), with its time, the plain version's time,
   the bound and a composite-of-library-calls yardstick;
4. main path: ``entry.entry()`` -- the flagship uint8 frames -> hg_logit
   forward at B=2 -- with every launch count set to 0 just before and read
   just after, then the same weights with the FFN kernel switched off;
5. throughput: clips/s at B=32 with the kernel and with the plain FFN;
6. the plain path on the card against the CPU at tiny size in f32;
7. the card line, one ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for f32 matmuls and convolutions (phase 6 compares
f32 results).  ``bound_ms`` is max(operations / 989 TFLOP/s bf16, bytes /
3.35 TB/s): the H100 SXM's published dense peaks, each input read once and
each output written once.
"""

from __future__ import annotations

import copy
import json
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
)
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.ffn import ffn_reference, fused_ffn
from shgvqa_tpu_torch.models.layers import FFN

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
D, FF = 768, 3072
# FFN sites of one flagship forward, as (rows per clip, sites): language
# (5 layers + 2 cross steps + 2 HG-cross steps), visual (5 + 2), HG (2)
FFN_SITES = ((40, 9), (393, 7), (177, 2))
TOL = 3e-2                     # |y - ref| <= TOL * max(1, |ref|), bf16


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


def main() -> int:
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

    rows, max_err = phase_ffn_kernel()
    model, launches = phase_main_path()
    cps = phase_throughput(model)
    phase_plain_path_card_vs_cpu()

    bsz = BATCH_SIZE
    widest = max(FFN_SITES, key=lambda s: s[1] * rows[s[0] * bsz]["bound_ms"])
    kernels = [{
        "name": "fused_ffn", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/ffn.cu",
        "replaces": "shgvqa_tpu/kernels/ffn.py:97",
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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

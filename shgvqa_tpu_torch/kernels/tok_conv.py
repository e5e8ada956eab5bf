"""The visual tokenizer's convolution: Conv3d(kT, 3, 3), valid in time and
zero-padded by 1 in space, + bias + exact GeLU, on channels-last features.

Replaces ``tools/proto_tok_kernel.py::_make_tok``, the Pallas TPU prototype
written for the tokenizer's convs, with the hand-written CUDA C++ kernel in
``csrc/tok_conv.cu`` (sm_90a, built by ``kernels/_build.py`` and bound with
``ctypes``).  On the card the conv is bound by the tensor cores (2*M*N*K
operations for M = B*T'*H*W positions, N = Co, K = kT*9*Ci); the kernel is
an implicit GEMM on wgmma whose producer warp lands each tap's A tile with
one TMA load in im2col mode straight from the channels-last input, instead
of laying the taps out as copies.  ``tok_conv.cu`` describes the design;
``tile_plan`` is its split of the work over the SMs.

- ``tok_conv_reference`` is the plain version, the TPU kernel's math on f32
  copies: the conv summed in f32, + the f32 bias, the erf GeLU in f32,
  returned in x's dtype (``torch.erf`` where the TPU kernel used the A-S
  polynomial, as the port's FFN kernels do).
- ``fused_tok_conv`` runs the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; on the card it launches the kernel or raises.
  It is forward only, as the TPU kernel, and raises when a gradient is
  required.  ``fused_tok_conv.launches`` counts its calls that launch.
  The kernel takes Ci a multiple of 64 and Co a multiple of 256.

The weight comes in the port's ``Conv3d`` layout (Co, Ci, kT, 3, 3); the
kernel reads it as (Co, kT, 3, 3, Ci), which is its memory under
``channels_last_3d`` (a copy is made otherwise).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import _stream


def _gelu_f32(y: torch.Tensor) -> torch.Tensor:
    return y * 0.5 * (1.0 + torch.erf(y * 0.7071067811865476))


def tok_conv_reference(x, w, b, gelu: bool = True):
    """Plain PyTorch version: x (B, T, H, W, Ci); w (Co, Ci, kT, 3, 3); b
    (Co,).  Returns (B, T - kT + 1, H, W, Co) in x's dtype."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float(), None,
                 padding=(0, 1, 1))
    y = y.permute(0, 2, 3, 4, 1) + b.float()
    return (_gelu_f32(y) if gelu else y).to(x.dtype)


# the kernel's tile (csrc/tok_conv.cu: kGemmBM, kBN, kGemmBK) and its K
# splits of the tiles after the last whole wave (kMaxSplits, and at least
# MIN_SPLIT_STEPS steps of K a split)
TILE_M, TILE_N, STEP_K = 128, 256, 64
MAX_SPLITS, MIN_SPLIT_STEPS = 16, 16


def tile_plan(m: int, co: int, k: int, sms: int):
    """(tiles, full, splits) of an (M, Co) output over K on ``sms`` SMs, one
    block an SM: the tiles (row-major over (row tile, column tile)), of which
    the first ``full`` (whole waves) each run all of K and the rest each
    split K in ``splits`` ranges, as many as fill the last wave (so 1 when
    the tiles fill whole waves or a split would be short)."""
    tiles = -(-m // TILE_M) * (co // TILE_N)
    tail = tiles % sms
    if tail == 0:
        return tiles, tiles, 1
    splits = min(MAX_SPLITS, sms // tail, (k // STEP_K) // MIN_SPLIT_STEPS)
    return (tiles, tiles, 1) if splits <= 1 else (tiles, tiles - tail, splits)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/tok_conv.cu`` with its C signatures declared."""
    lib = _build.load("tok_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shgvqa_tok_conv_bf16.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
    lib.shgvqa_tok_conv_bf16.restype = i32
    lib.shgvqa_tok_conv_error_string.argtypes = [i32]
    lib.shgvqa_tok_conv_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, w, b, gelu: bool):
    """One call on the current stream (the conv, and the sum of the split
    tiles' partials when there are any): x (B, T, H, W, Ci) bf16, w (Co,
    kT, 3, 3, Ci) bf16, b (Co,) f32, all contiguous."""
    bsz, t, h, wd, ci = x.shape
    co, kt = w.shape[0], w.shape[1]
    m, k = bsz * (t - kt + 1) * h * wd, kt * 9 * ci
    lib = _lib()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles, full, splits = tile_plan(m, co, k, sms)
    y = torch.empty(bsz, t - kt + 1, h, wd, co, dtype=x.dtype,
                    device=x.device)
    part = (torch.empty((tiles - full) * splits, TILE_M, TILE_N,
                        dtype=torch.float32, device=x.device)
            if full < tiles else None)
    with torch.cuda.device(x.device):
        err = lib.shgvqa_tok_conv_bf16(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), bsz, t, h, wd, ci, co,
            kt, full, splits, int(gelu), _stream(x.device))
    if err:
        raise RuntimeError(f"fused_tok_conv kernel launch failed: CUDA error "
                           f"{err} ({lib.shgvqa_tok_conv_error_string(err).decode()})")
    fused_tok_conv.launches += 1
    return y


def _check(x, weight, bias):
    if x.dim() != 5 or weight.dim() != 5 or tuple(weight.shape[3:]) != (3, 3):
        raise ValueError(f"fused_tok_conv: x must be (B, T, H, W, Ci) and "
                         f"weight (Co, Ci, kT, 3, 3); got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    co, ci, kt = weight.shape[:3]
    if x.shape[-1] != ci or tuple(bias.shape) != (co,) or x.shape[1] < kt:
        raise ValueError(f"fused_tok_conv: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} and bias {tuple(bias.shape)}"
                         " do not fit")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, weight, bias)):
        raise RuntimeError("fused_tok_conv is forward only (as the TPU "
                           "kernel): run it under torch.no_grad() or "
                           "inference_mode")


def fused_tok_conv(x, weight, bias, gelu: bool = True):
    """x (B, T, H, W, Ci) channels-last; weight (Co, Ci, kT, 3, 3), cast to
    x's dtype here; bias (Co,), read in f32.  Returns (B, T - kT + 1, H, W,
    Co) in x's dtype: the conv, valid in T and padded by 1 in H and W, +
    bias, then the erf GeLU (when ``gelu``).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    _check(x, weight, bias)
    w, b = weight.to(x.dtype), bias.float()
    if x.device.type == "cpu":
        return tok_conv_reference(x, w, b, gelu)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"fused_tok_conv's kernel takes bfloat16 "
                                  f"features, got {x.dtype}")
    ci, co = x.shape[-1], weight.shape[0]
    if ci % STEP_K or co % TILE_N:
        raise ValueError(f"fused_tok_conv: Ci={ci} must be a multiple of "
                         f"{STEP_K} and Co={co} of {TILE_N}")
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_tok_conv has no kernel for "
                                  f"{x.device}")
    args = (x.contiguous(), w.permute(0, 2, 3, 4, 1).contiguous(),
            b.contiguous())
    for name, t in zip(("x", "weight", "bias"), args):
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"fused_tok_conv: {name} must be on {x.device} "
                             "and 16-byte aligned")
    return _launch(*args, gelu)


fused_tok_conv.launches = 0

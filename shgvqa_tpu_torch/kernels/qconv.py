"""The int8 frozen trunk's convolution (``--quantBackbone int8``): an s8 x s8
-> s32 3-D convolution on channels-last int8 activations with the
dequantize, folded-BatchNorm, ReLU, residual and requantize epilogue of the
JAX ``Bottleneck3D._quant_call`` (``shgvqa_tpu/models/backbone.py``:
``_qconv`` :167, ``deq`` :279, ``quant_sym`` :149).

It replaces no Pallas kernel: the JAX package leaves this path to XLA
(``jax.lax.conv_general_dilated`` with ``preferred_element_type=int32``).
No PyTorch or library call computes it (``F.conv3d`` takes no int8 on
CUDA and ``torch._int_mm`` is a plain GEMM without the padding, the taps or
the epilogue), so the port has the hand-written CUDA C++ kernel of
``csrc/qconv.cu`` (sm_90a, built by ``kernels/_build.py`` and bound with
``ctypes``), an implicit GEMM on ``mma.sync`` s8 tensor cores.

- ``quant_sym``, ``quant_weight`` and ``max_pool_i8`` are the JAX
  package's helpers, bit for bit.
- ``qconv_reference`` is the plain version: the exact integer convolution
  (``F.conv3d`` in float64 on the int8 values, exact since every sum is
  below 2^53, then int32), then the epilogue in torch ops.  It defines the
  rounding points the kernel mirrors: ``acc.to(dt)`` (int32 -> f32 -> dt,
  each round to nearest even), the product with the scale and the sum with
  the shift each rounded to dt once, the residual added in dt, ReLU, then
  an IEEE f32 division by ``max(s, 1e-12)``, round half to even and a clamp
  to +-127.
- ``qconv`` is the wrapper: it quantizes the f32 weight per output channel
  (``quant_weight``, on the device, every call, as the JAX graph does),
  folds ``scale = (max(s_in, 1e-12) * sw * inv).to(dt)`` in f32 in that
  order and ``shift.to(dt)``, then runs the plain version for a tensor on
  the CPU or the kernel for a CUDA tensor (it launches or raises).  Every
  scale reaches the kernel as a device pointer, so nothing is read on the
  host and a CUDA graph replays a recalibration's values.  It is forward
  only and raises under a gradient.  ``qconv.launches`` counts its calls
  that launch.

Epilogues (which one follows from the arguments): with ``s_out`` None the
dequantized BN output in dt (a projection, JAX's ``r``); with ``s_out``
and no residual ``quant_sym(relu(deq), s_out)`` (conv_a, conv_b); with a
residual ``quant_sym(relu(deq + r), s_out)`` (conv_c), r the projection's
dt output or the block's int8 input times ``max(s_res, 1e-12).to(dt)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import _stream

EPS = 1e-12
# the conv kernels of the slow_r50 bottleneck (kT, kH, kW): conv_a of res_2
# and res_3, of res_4 and res_5, conv_b; conv_c and the projection are 1x1x1
KERNELS = ((1, 1, 1), (3, 1, 1), (1, 3, 3))
# channels of one K step (csrc/qconv.cu kBK): every channel count is a
# multiple of it
CHANNEL_MULTIPLE = 64
# csrc/qconv.cu's epilogues (kMode) and dtypes
MODE_QUANT, MODE_DEQ, MODE_RES, MODE_RES_Q = 0, 1, 2, 3
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division on every device (a CUDA tensor divided by
    a Python number is multiplied by its reciprocal instead)."""
    return x / torch.full_like(x, d)


def _scale_tensor(scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def quant_sym(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8: clip(round(x / max(scale, 1e-12)), -127, 127), the
    division in f32 (the JAX ``quant_sym``)."""
    s = _scale_tensor(scale, x).clamp_min(EPS)
    return torch.round(x.float() / s).clamp(-127, 127).to(torch.int8)


def quant_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 of a (Co, Ci, kT, kH, kW) f32
    kernel (the port's Conv3d layout; the JAX ``quant_weight`` on its
    (kT, kH, kW, Ci, Co) layout): (w_q int8 of w's shape, sw (Co,) f32)."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    sw = _div(amax, 127.0).clamp_min(EPS)
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.round(w / sw.view(shape)).clamp(-127, 127).to(torch.int8)
    return wq, sw


def max_pool_i8(x_q: torch.Tensor) -> torch.Tensor:
    """(1, 3, 3) / stride (1, 2, 2) max-pool of (B, T, H, W, C) int8,
    padded by 1 with -128 (the JAX ``_max_pool_i8``'s ``reduce_window``):
    the elementwise max of the window's nine strided views, in int8, so it
    is exact on every device (``F.max_pool3d`` takes no int8 on CUDA).
    Quantize-then-pool equals pool-then-quantize exactly (round and clip
    are non-decreasing)."""
    h, w = x_q.shape[2], x_q.shape[3]
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1), value=-128)
    out = None
    for dy in range(3):
        for dx in range(3):
            v = xp[:, :, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def out_side(size: int, k: int, stride: int) -> int:
    """Output side of a conv of kernel k, padding k // 2, ``stride``."""
    return (size + 2 * (k // 2) - k) // stride + 1


def qconv_acc(x_q, w_q, stride: int = 1) -> torch.Tensor:
    """The exact s32 sums: x_q (B, T, H, W, Ci) int8, w_q (Co, kT, kH, kW,
    Ci) int8, padding k // 2, the spatial ``stride`` -> (B, T, Ho, Wo, Co)
    int32 (the JAX ``_qconv``)."""
    kt, kh, kw = w_q.shape[1:4]
    acc = F.conv3d(x_q.permute(0, 4, 1, 2, 3).double(),
                   w_q.permute(0, 4, 1, 2, 3).double(),
                   stride=(1, stride, stride),
                   padding=(kt // 2, kh // 2, kw // 2))
    return acc.to(torch.int32).permute(0, 2, 3, 4, 1).contiguous()


def qconv_reference(x_q, w_q, scale, shift, stride: int = 1, s_out=None,
                    residual=None, s_res=None):
    """Plain version: x_q (B, T, H, W, Ci) int8; w_q (Co, kT, kH, kW, Ci)
    int8; scale, shift (Co,) in the compute dtype dt; padding k // 2, the
    spatial ``stride``.  Returns (B, T, Ho, Wo, Co): dt with ``s_out`` None,
    else int8 (module docstring)."""
    v = qconv_acc(x_q, w_q, stride).to(scale.dtype) * scale + shift
    if s_out is None:
        return v
    if residual is not None:
        if residual.dtype == torch.int8:
            rs = _scale_tensor(s_res, residual).clamp_min(EPS)
            residual = residual.to(v.dtype) * rs.to(v.dtype)
        v = v + residual
    return quant_sym(torch.relu(v), s_out)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/qconv.cu`` with its C signatures declared."""
    lib = _build.load("qconv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shgvqa_qconv.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
    lib.shgvqa_qconv.restype = i32
    lib.shgvqa_qconv_error_string.argtypes = [i32]
    lib.shgvqa_qconv_error_string.restype = ctypes.c_char_p
    return lib


def _mode(s_out, residual) -> int:
    if s_out is None:
        return MODE_DEQ
    if residual is None:
        return MODE_QUANT
    return MODE_RES_Q if residual.dtype == torch.int8 else MODE_RES


def _launch(x_q, w_k, scale, shift, stride, s_out, residual, s_res):
    """One kernel call on the current stream; every operand contiguous on
    one card, the scales f32 device scalars."""
    bsz, t, h, w, ci = x_q.shape
    co, kt, kh, kw = w_k.shape[:4]
    dt = scale.dtype
    mode = _mode(s_out, residual)
    ho, wo = out_side(h, kh, stride), out_side(w, kw, stride)
    y = torch.empty(bsz, t, ho, wo, co, device=x_q.device,
                    dtype=dt if mode == MODE_DEQ else torch.int8)
    lib = _lib()
    ptrs = [x_q, w_k, scale, shift, residual, s_res, s_out, y]
    with torch.cuda.device(x_q.device):
        err = lib.shgvqa_qconv(
            *(None if p is None else p.data_ptr() for p in ptrs),
            bsz, t, h, w, ci, co, kt, kh, kw, stride, mode, DTYPES[dt],
            _stream(x_q.device))
    if err:
        raise RuntimeError(f"qconv kernel launch failed: CUDA error {err} "
                           f"({lib.shgvqa_qconv_error_string(err).decode()})")
    qconv.launches += 1
    return y


def _check(x_q, weight, inv, shift, stride, s_out, residual, s_res, dt):
    where = "qconv (--quantBackbone int8)"
    if x_q.dtype != torch.int8 or x_q.dim() != 5:
        raise ValueError(f"{where}: x_q must be (B, T, H, W, Ci) int8, got "
                         f"{tuple(x_q.shape)} {x_q.dtype}")
    if weight.dim() != 5 or weight.shape[1] != x_q.shape[-1]:
        raise ValueError(f"{where}: weight must be (Co, Ci, kT, kH, kW) with "
                         f"Ci={x_q.shape[-1]}, got {tuple(weight.shape)}")
    co = weight.shape[0]
    if tuple(inv.shape) != (co,) or tuple(shift.shape) != (co,):
        raise ValueError(f"{where}: inv and shift must be ({co},)")
    if tuple(weight.shape[2:]) not in KERNELS or stride not in (1, 2):
        raise ValueError(f"{where}: kernel {tuple(weight.shape[2:])} stride "
                         f"{stride}; the trunk has kernels {KERNELS} and "
                         "strides 1 and 2")
    if dt not in DTYPES:
        raise ValueError(f"{where}: compute dtype {dt}, not one of "
                         f"{tuple(DTYPES)}")
    if residual is not None:
        if s_out is None:
            raise ValueError(f"{where}: a residual needs s_out")
        if residual.dtype not in (dt, torch.int8) or (
                residual.dtype == torch.int8 and s_res is None):
            raise ValueError(f"{where}: the residual must be {dt}, or int8 "
                             "with its scale s_res")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (weight, inv, shift, residual)):
        raise RuntimeError(f"{where} is forward only (the int8 trunk is "
                           "frozen): run it under torch.no_grad() or "
                           "inference_mode")


def _check_card(x_q, w_k, scales, residual, out_shape):
    where = "qconv (--quantBackbone int8)"
    ci, co = x_q.shape[-1], w_k.shape[0]
    if ci % CHANNEL_MULTIPLE or co % CHANNEL_MULTIPLE:
        raise ValueError(f"{where}: the kernel takes Ci={ci} and Co={co} "
                         f"multiples of {CHANNEL_MULTIPLE}")
    if x_q.device.type != "cuda":
        raise NotImplementedError(f"{where} has no kernel for {x_q.device}")
    if not x_q.is_contiguous():
        raise ValueError(f"{where}: x_q must be contiguous (B, T, H, W, Ci)")
    for name, s in scales.items():
        if s is not None and (s.dtype != torch.float32 or s.numel() != 1
                              or s.device != x_q.device):
            raise ValueError(f"{where}: {name} must be an f32 scalar tensor "
                             f"on {x_q.device}")
    if residual is not None and (tuple(residual.shape) != out_shape
                                 or not residual.is_contiguous()
                                 or residual.device != x_q.device):
        raise ValueError(f"{where}: the residual must be a contiguous "
                         f"{out_shape} tensor on {x_q.device}")


def qconv(x_q, s_in, weight, inv, shift, stride: int = 1, s_out=None,
          residual=None, s_res=None, dtype=torch.bfloat16):
    """x_q (B, T, H, W, Ci) int8 with its scale ``s_in`` (an f32 scalar
    tensor); ``weight`` (Co, Ci, kT, kH, kW) f32; the folded BN ``inv`` and
    ``shift`` (Co,) f32; the compute ``dtype``; ``s_out``, ``residual`` and
    ``s_res`` pick the epilogue (module docstring).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    _check(x_q, weight, inv, shift, stride, s_out, residual, s_res, dtype)
    w_q, sw = quant_weight(weight)
    s_act = _scale_tensor(s_in, x_q).clamp_min(EPS)
    scale = (s_act * sw * inv.float()).to(dtype)
    sh = shift.float().to(dtype)
    w_k = w_q.permute(0, 2, 3, 4, 1).contiguous()        # (Co, kT, kH, kW, Ci)
    if x_q.device.type == "cpu":
        return qconv_reference(x_q, w_k, scale, sh, stride, s_out, residual,
                               s_res)
    b, t, h, w = x_q.shape[:4]
    out_shape = (b, t, out_side(h, w_k.shape[2], stride),
                 out_side(w, w_k.shape[3], stride), w_k.shape[0])
    _check_card(x_q, w_k, {"s_out": s_out, "s_res": s_res}, residual,
                out_shape)
    return _launch(x_q, w_k, scale, sh, stride, s_out, residual, s_res)


qconv.launches = 0

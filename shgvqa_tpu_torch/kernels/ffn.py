"""Fused FFN block: ``y = LN(x + gelu(x W1 + b1) W2 + b2) * gamma + beta``.

Replaces ``shgvqa_tpu/kernels/ffn.py::_make_call``, the Pallas TPU kernel
behind the JAX ``fused_ffn``, with the hand-written CUDA C++ kernel in
``csrc/ffn.cu`` (sm_90a, built by ``kernels/_build.py`` and bound with
``ctypes``).  On the card the block is bound by the tensor cores (4*M*D*F
operations against ~4*M*D + 4*D*F bytes); the kernel keeps the (M, F)
intermediate on the chip and fuses bias, GeLU, residual and LayerNorm
around its two products.  ``ffn.cu`` describes its design.

- ``ffn_reference`` is the plain version, with the semantics of the JAX
  ``_reference``: products of the given operands in f32, h rounded to the
  weight dtype between them, two-pass LayerNorm in f32.
- ``fused_ffn`` runs the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; on the card it launches the kernel or raises.
  ``fused_ffn.launches`` counts the kernel's launches.
- The kernel's backward recomputes through autograd of the plain version,
  as the JAX ``_fused_bwd`` does; the TPU kernel has no backward kernel.

Weights come in ``nn.Linear`` layout: ``w1t`` is (F, D), ``w2t`` is (D, F).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from shgvqa_tpu_torch.kernels import _build


def ffn_reference(x2, w1t, b1, w2t, b2, gamma, beta, eps: float = 1e-12):
    """Plain PyTorch version: x2 (M, D); w1t (F, D); w2t (D, F); vectors f32.
    Returns (M, D) in x2's dtype."""
    u = torch.matmul(x2.float(), w1t.float().t()) + b1.float()
    h = (0.5 * u * (1.0 + torch.erf(u * 0.7071067811865476))).to(w2t.dtype)
    o = torch.matmul(h.float(), w2t.float().t()) + b2.float()
    r = o + x2.float()
    mean = r.mean(dim=-1, keepdim=True)
    var = (r - mean).square().mean(dim=-1, keepdim=True)
    y = (r - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x2.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/ffn.cu`` with its C signatures declared."""
    lib = _build.load("ffn")
    lib.shgvqa_fused_ffn_bf16.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    lib.shgvqa_fused_ffn_bf16.restype = ctypes.c_int
    lib.shgvqa_fused_ffn_max_d.argtypes = []
    lib.shgvqa_fused_ffn_max_d.restype = ctypes.c_int
    lib.shgvqa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.shgvqa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"fused_ffn: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"fused_ffn: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_ffn: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_ffn: {name} must be contiguous and "
                         "16-byte aligned")


def _launch(x2, w1t, b1, w2t, b2, gamma, beta, eps):
    """One launch of the CUDA kernel on the current stream."""
    m, d = x2.shape
    f = w1t.shape[0]
    if x2.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused_ffn on CUDA takes bfloat16 activations, got {x2.dtype} "
            "(set compute_dtype='bfloat16' or use_pallas_ffn=False)")
    if d % 16 or f % 16:
        raise ValueError(f"fused_ffn: D={d} and F={f} must be multiples of 16")
    lib = _lib()
    if d > lib.shgvqa_fused_ffn_max_d():
        raise ValueError(f"fused_ffn: D={d} exceeds the kernel's maximum "
                         f"{lib.shgvqa_fused_ffn_max_d()}")
    dev = x2.device
    _check("x", x2, (m, d), torch.bfloat16, dev)
    _check("w1t", w1t, (f, d), torch.bfloat16, dev)
    _check("w2t", w2t, (d, f), torch.bfloat16, dev)
    _check("b1", b1, (f,), torch.float32, dev)
    for name, t in (("b2", b2), ("gamma", gamma), ("beta", beta)):
        _check(name, t, (d,), torch.float32, dev)
    y = torch.empty_like(x2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shgvqa_fused_ffn_bf16(
            x2.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            m, d, f, float(eps), stream)
    if err:
        raise RuntimeError(
            f"fused_ffn kernel launch failed: CUDA error {err} "
            f"({lib.shgvqa_cuda_error_string(err).decode()})")
    fused_ffn.launches += 1
    return y


class _FusedFFN(torch.autograd.Function):
    """The kernel forward; the backward recomputes through autograd of
    ``ffn_reference``."""

    @staticmethod
    def forward(ctx, x2, w1t, b1, w2t, b2, gamma, beta, eps):
        ctx.save_for_backward(x2, w1t, b1, w2t, b2, gamma, beta)
        ctx.eps = eps
        return _launch(x2, w1t, b1, w2t, b2, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = ffn_reference(*inputs, ctx.eps)
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def fused_ffn(x, w1t, b1, w2t, b2, gamma, beta, eps: float = 1e-12):
    """x (..., D); w1t (F, D) and w2t (D, F) in nn.Linear layout, cast to
    x's dtype here; b1, b2, gamma, beta are read in f32.  Returns (..., D)
    in x's dtype.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    d = x.shape[-1]
    args = (x.reshape(-1, d), w1t.to(x.dtype), b1.float(), w2t.to(x.dtype),
            b2.float(), gamma.float(), beta.float())
    if x.device.type == "cpu":
        y = ffn_reference(*args, eps)
    elif x.device.type == "cuda":
        y = _FusedFFN.apply(*(a.contiguous() for a in args), float(eps))
    else:
        raise NotImplementedError(f"fused_ffn has no kernel for {x.device}")
    return y.reshape(x.shape)


fused_ffn.launches = 0

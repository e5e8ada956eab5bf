"""Fused FFN block: ``y = LN(x + dropout(gelu(x W1 + b1) W2 + b2)) * gamma
+ beta``, for inference and for training.

Inference replaces ``shgvqa_tpu/kernels/ffn.py::_make_call``, the Pallas TPU
kernel behind the JAX ``fused_ffn``, with the hand-written CUDA C++ kernel in
``csrc/ffn.cu``; training replaces ``_make_train_pair`` there (forward
``fwd_kernel``, backward ``bwd_kernel``, behind the JAX ``fused_ffn_train``)
with the kernels of ``csrc/ffn_train.cu``.  Both are sm_90a, built by
``kernels/_build.py`` and bound with ``ctypes``.  On the card the block is
bound by the tensor cores (4*M*D*F operations forward, 8*M*D*F backward,
against ~4*M*D + 4*D*F bytes); the kernels keep the (M, F) intermediate on
the chip in the forward and fuse bias, GeLU, dropout, residual and
LayerNorm around the products.  The ``.cu`` files describe their design.

- ``ffn_reference`` is the plain inference version, with the semantics of
  the JAX ``_reference``: products of the given operands in f32, h rounded
  to the weight dtype between them, two-pass LayerNorm in f32.
- ``fused_ffn`` runs the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; on the card it launches the kernel or raises.
  ``fused_ffn.launches`` counts the kernel's launches.  Its backward
  recomputes through autograd of the plain version, as the JAX
  ``_fused_bwd`` does; the TPU kernel has no backward kernel.
- ``ffn_train_reference`` is the plain training forward: the inference
  math with dropout on the output dense (bias included) before the
  residual, by an explicit keep mask, kept values scaled by 1/(1 - rate).
  ``ffn_train_backward_reference`` is the backward kernel's algorithm in
  torch (LayerNorm backward, do and du rounded to the weight dtype before
  their products) plus the weight-gradient products the caller runs after
  it.
- ``fused_ffn_train`` is differentiable: for a CPU tensor it runs
  ``ffn_train_reference`` with a keep mask drawn from the caller's
  generator (autograd through it); for a CUDA tensor it launches the
  forward kernel, and its backward launches the backward kernel (dx, du,
  do, h, dgamma, dbeta) and then the weight gradients ``du^T x``, ``do^T
  h`` and the bias sums as ``torch.matmul`` and ``sum`` (the JAX package
  left those to XLA too).  ``fused_ffn_train.launches`` and
  ``.bwd_launches`` count the kernel launches.
- ``keep_mask`` (card only) writes the keep mask the train kernels draw
  for a seed: one mask for the forward and the backward, whatever their
  tile heights, because it is keyed on (seed, row, column).

Weights come in ``nn.Linear`` layout: ``w1t`` is (F, D), ``w2t`` is (D, F).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import (
    _mask_ptr,
    _stream,
    _threshold,
    draw_seed,
)


def _phi(u):
    """Phi(u), the standard normal CDF: gelu(u) = u * Phi(u)."""
    return 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))


def _drop(o, keep, rate):
    return o if keep is None else torch.where(keep, o * (1.0 / (1.0 - rate)),
                                              0.0)


def _residual(x2, w1t, b1, w2t, b2, rate, keep):
    """(u, h, r) in f32 but h: u = x W1 + b1, h = gelu(u) in w2t's dtype,
    r = dropout(h W2 + b2) + x."""
    u = torch.matmul(x2.float(), w1t.float().t()) + b1.float()
    h = (u * _phi(u)).to(w2t.dtype)
    o = torch.matmul(h.float(), w2t.float().t()) + b2.float()
    return u, h, _drop(o, keep, rate) + x2.float()


def _normalize(r, eps):
    """(xhat, rstd) of a two-pass LayerNorm over the last dim, f32."""
    mean = r.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((r - mean).square().mean(dim=-1, keepdim=True) + eps)
    return (r - mean) * rstd, rstd


def ffn_reference(x2, w1t, b1, w2t, b2, gamma, beta, eps: float = 1e-12):
    """Plain PyTorch version: x2 (M, D); w1t (F, D); w2t (D, F); vectors f32.
    Returns (M, D) in x2's dtype."""
    return ffn_train_reference(x2, w1t, b1, w2t, b2, gamma, beta, 0.0, None,
                               eps)


def ffn_train_reference(x2, w1t, b1, w2t, b2, gamma, beta, rate: float = 0.0,
                        keep: Optional[torch.Tensor] = None,
                        eps: float = 1e-12):
    """Plain training forward: as ``ffn_reference`` with the output dense
    dropped by ``keep`` (bool (M, D), or None for no dropout) at ``rate``
    before the residual.  Returns (M, D) in x2's dtype."""
    _, _, r = _residual(x2, w1t, b1, w2t, b2, rate, keep)
    xhat, _ = _normalize(r, eps)
    return (xhat * gamma.float() + beta.float()).to(x2.dtype)


def _weight_grads(x2, du, do, h):
    """(dW1^T, db1, dW2^T, db2) from the backward kernel's spills, in the
    nn.Linear layout: du^T x, sum du, do^T h, sum do (bias sums in f32)."""
    return (torch.matmul(du.t(), x2), du.float().sum(0),
            torch.matmul(do.t(), h), do.float().sum(0))


def ffn_train_backward_reference(x2, w1t, b1, w2t, b2, gamma, rate, keep, dy,
                                 eps: float = 1e-12):
    """Plain version of the backward kernel and the weight-gradient products
    after it: (dx, dW1^T, db1, dW2^T, db2, dgamma, dbeta) of
    ``ffn_train_reference`` at cotangent ``dy`` with the same keep mask.
    do and du are rounded to the weights' dtype before their products, dy to
    x2's, dx is summed in f32."""
    dx, du, do, h, dgamma, dbeta = _backward_spills(
        x2, w1t, b1, w2t, b2, gamma, rate, keep, dy, eps)
    return (dx, *_weight_grads(x2, du, do, h), dgamma, dbeta)


def _backward_spills(x2, w1t, b1, w2t, b2, gamma, rate, keep, dy, eps):
    """What the backward kernel computes: (dx, du, do, h, dgamma, dbeta)."""
    u, h, r = _residual(x2, w1t, b1, w2t, b2, rate, keep)
    xhat, rstd = _normalize(r, eps)
    dy32 = dy.to(x2.dtype).float()
    dgamma, dbeta = (dy32 * xhat).sum(0), dy32.sum(0)
    a = dy32 * gamma.float()
    dr = (a - a.mean(-1, keepdim=True)
          - xhat * (a * xhat).mean(-1, keepdim=True)) * rstd
    do = _drop(dr, keep, rate).to(w2t.dtype)
    dh = torch.matmul(do.float(), w2t.float())
    gelu_grad = _phi(u) + u * torch.exp(-0.5 * u * u) * 0.3989422804014327
    du = (dh * gelu_grad).to(w1t.dtype)
    dx = (dr + torch.matmul(du.float(), w1t.float())).to(x2.dtype)
    return dx, du, do, h, dgamma, dbeta


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


def _check(name, t, shape, dtype, device, what="fused_ffn"):
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be contiguous and "
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


# ---------------------------------------------------------------------------
# Training: csrc/ffn_train.cu


@functools.lru_cache(maxsize=None)
def _train_lib() -> ctypes.CDLL:
    """The built ``csrc/ffn_train.cu`` with its C signatures declared."""
    lib = _build.load("ffn_train")
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
    lib.shgvqa_ffn_train_fwd_bf16.argtypes = (
        [ptr] * 9 + [i32] * 3 + [f32, u32, f32, i32, ptr])
    lib.shgvqa_ffn_train_bwd_bf16.argtypes = (
        [ptr] * 15 + [i32] * 3 + [f32, u32, f32, i32, ptr])
    lib.shgvqa_ffn_train_keep_mask.argtypes = [ptr, ptr, i32, i32, u32, ptr]
    for fn in (lib.shgvqa_ffn_train_fwd_bf16, lib.shgvqa_ffn_train_bwd_bf16,
               lib.shgvqa_ffn_train_keep_mask, lib.shgvqa_ffn_train_max_d,
               lib.shgvqa_ffn_train_bwd_rows):
        fn.restype = i32
    lib.shgvqa_ffn_train_max_d.argtypes = []
    lib.shgvqa_ffn_train_bwd_rows.argtypes = []
    lib.shgvqa_ffn_train_error_string.argtypes = [i32]
    lib.shgvqa_ffn_train_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({_train_lib().shgvqa_ffn_train_error_string(err).decode()})")


def _check_train(x2, w1t, b1, w2t, b2, gamma, beta=None):
    m, d = x2.shape
    f = w1t.shape[0]
    if x2.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused_ffn_train on CUDA takes bfloat16 activations, got "
            f"{x2.dtype} (set compute_dtype='bfloat16' or "
            "use_pallas_ffn_train=False)")
    lib = _train_lib()
    if d % 64 or f % 256 or d > lib.shgvqa_ffn_train_max_d():
        raise ValueError(f"fused_ffn_train: D={d} must be a multiple of 64 "
                         f"and at most {lib.shgvqa_ffn_train_max_d()}, "
                         f"F={f} a multiple of 256")
    dev = x2.device
    _check("x", x2, (m, d), torch.bfloat16, dev, "fused_ffn_train")
    _check("w1t", w1t, (f, d), torch.bfloat16, dev, "fused_ffn_train")
    _check("w2t", w2t, (d, f), torch.bfloat16, dev, "fused_ffn_train")
    _check("b1", b1, (f,), torch.float32, dev, "fused_ffn_train")
    for name, t in (("b2", b2), ("gamma", gamma), ("beta", beta)):
        if t is not None:
            _check(name, t, (d,), torch.float32, dev, "fused_ffn_train")
    return m, d, f


def _launch_train_fwd(x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps):
    """One launch of the forward kernel on the current stream."""
    m, d, f = _check_train(x2, w1t, b1, w2t, b2, gamma, beta)
    y = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = _train_lib().shgvqa_ffn_train_fwd_bf16(
            x2.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _mask_ptr(seed),
            y.data_ptr(), m, d, f, float(eps), _threshold(rate),
            1.0 / (1.0 - rate), int(rate > 0.0), _stream(x2.device))
    _raise_on(err, "fused_ffn_train forward")
    fused_ffn_train.launches += 1
    return y


def _launch_train_bwd(x2, w1t, b1, w2t, b2, gamma, seed, rate, eps, dy):
    """One launch of the backward kernel (and its dgamma/dbeta sum):
    (dx, du, do, h, dgamma, dbeta)."""
    m, d, f = _check_train(x2, w1t, b1, w2t, b2, gamma)
    dy = dy.to(torch.bfloat16).contiguous()
    _check("dy", dy, (m, d), torch.bfloat16, x2.device, "fused_ffn_train")
    lib = _train_lib()
    tiles = -(-m // lib.shgvqa_ffn_train_bwd_rows())

    def empty(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device=x2.device)

    dx, do, du, h = empty(m, d), empty(m, d), empty(m, f), empty(m, f)
    gd = empty(m, f, dtype=torch.float32)
    part = empty(tiles, 2 * d, dtype=torch.float32)
    dgb = empty(2 * d, dtype=torch.float32)
    with torch.cuda.device(x2.device):
        err = lib.shgvqa_ffn_train_bwd_bf16(
            x2.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), _mask_ptr(seed), dy.data_ptr(),
            dx.data_ptr(), du.data_ptr(), do.data_ptr(), h.data_ptr(),
            gd.data_ptr(), part.data_ptr(), dgb.data_ptr(), m, d, f,
            float(eps), _threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
            _stream(x2.device))
    _raise_on(err, "fused_ffn_train backward")
    fused_ffn_train.bwd_launches += 1
    return dx, du, do, h, dgb[:d], dgb[d:]


class _FusedFFNTrain(torch.autograd.Function):
    """The forward kernel; the backward kernel regenerates its dropout mask
    from the saved seed, then the weight gradients run as plain products."""

    @staticmethod
    def forward(ctx, x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps):
        ctx.save_for_backward(x2, w1t, b1, w2t, b2, gamma, seed)
        ctx.rate, ctx.eps = rate, eps
        return _launch_train_fwd(x2, w1t, b1, w2t, b2, gamma, beta, seed,
                                 rate, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, w1t, b1, w2t, b2, gamma, seed = ctx.saved_tensors
        dx, du, do, h, dgamma, dbeta = _launch_train_bwd(
            x2, w1t, b1, w2t, b2, gamma, seed, ctx.rate, ctx.eps, dy)
        dw1t, db1, dw2t, db2 = _weight_grads(x2, du, do, h)
        return (dx, dw1t, db1, dw2t, db2, dgamma, dbeta, None, None, None)


def fused_ffn_train(x, w1t, b1, w2t, b2, gamma, beta, dropout_rate: float,
                    generator: Optional[torch.Generator] = None,
                    eps: float = 1e-12):
    """x (..., D); w1t (F, D) and w2t (D, F) in nn.Linear layout, cast to
    x's dtype here; b1, b2, gamma, beta are read in f32.  Returns (..., D)
    in x's dtype, differentiable in every input.  With ``dropout_rate`` > 0
    the output dense is dropped with a mask drawn from ``generator`` (the
    device's default one when None) and the backward uses the same mask.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernels
    or raises."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    args = (x2, w1t.to(x.dtype), b1.float(), w2t.to(x.dtype), b2.float(),
            gamma.float(), beta.float())
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            keep = torch.rand(x2.shape, generator=generator) >= rate
        y = ffn_train_reference(*args, rate, keep, eps)
    elif x.device.type == "cuda":
        seed = draw_seed(generator, x.device) if rate > 0.0 else None
        y = _FusedFFNTrain.apply(*(a.contiguous() for a in args), seed, rate,
                                 float(eps))
    else:
        raise NotImplementedError(f"fused_ffn_train has no kernel for "
                                  f"{x.device}")
    return y.reshape(x.shape)


fused_ffn_train.launches = 0
fused_ffn_train.bwd_launches = 0


def keep_mask(seed: torch.Tensor, m: int, d: int, rate: float) -> torch.Tensor:
    """The bool (M, D) keep mask the train kernels draw from ``seed`` (a
    CUDA int64 tensor of 2 words) at ``rate``; card only."""
    if seed.device.type != "cuda":
        raise NotImplementedError("keep_mask runs on the card only")
    out = torch.empty(m, d, dtype=torch.uint8, device=seed.device)
    with torch.cuda.device(seed.device):
        err = _train_lib().shgvqa_ffn_train_keep_mask(
            seed.data_ptr(), out.data_ptr(), m, d, _threshold(rate),
            _stream(seed.device))
    _raise_on(err, "fused_ffn_train keep_mask")
    return out.bool()

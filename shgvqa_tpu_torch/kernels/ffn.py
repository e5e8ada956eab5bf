"""Fused FFN block: ``y = LN(x + dropout(gelu(x W1 + b1) W2 + b2)) * gamma
+ beta``, for inference and for training.

Inference replaces ``shgvqa_tpu/kernels/ffn.py::_make_call``, the Pallas TPU
kernel behind the JAX ``fused_ffn``, and training replaces
``_make_train_pair`` there (forward ``fwd_kernel``, backward ``bwd_kernel``,
behind the JAX ``fused_ffn_train``), with the hand-written CUDA C++ chains
of ``csrc/ffn_train.cu`` (sm_90a, built by ``kernels/_build.py`` and bound
with ``ctypes``): inference runs the training forward's chain at rate 0.
On the card the block is bound by the tensor cores (4*M*D*F operations
forward, 8*M*D*F backward, against ~4*M*D + 4*D*F bytes); the chains run
their products on wgmma fed by TMA and fuse bias, GeLU, dropout, residual
and LayerNorm around them.  ``ffn_train.cu`` describes the design.

- ``ffn_reference`` is the plain inference version, with the semantics of
  the JAX ``_reference``: products of the given operands in f32, h rounded
  to the weight dtype between them, two-pass LayerNorm in f32.
- ``fused_ffn`` runs the plain version for a tensor on the CPU and the
  forward's chain at rate 0 (no dropout, no seed) for a CUDA tensor; on
  the card it launches the chain or raises.  ``fused_ffn.launches`` counts
  its calls that launch (``fused_ffn_train``'s counts do not move).  Its
  backward recomputes through autograd of the plain version, as the JAX
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
  forward's chain of kernels (u with h out, o, and a row pass for the
  dropout, the residual and the LayerNorm; two wgmma products into the
  scratch h and o + b2 the wrapper allocates), and its backward runs the
  backward's chain of kernels
  (dx, du, do, h, dgamma, dbeta; four wgmma products, a LayerNorm row pass
  and the dgamma/dbeta sum) and then the weight gradients ``du^T x``,
  ``do^T h`` and the bias sums as ``torch.matmul`` and ``sum`` (the JAX
  package left those to XLA too).  ``fused_ffn_train.launches`` and
  ``.bwd_launches`` count the wrapper calls that launch (one each).
- ``keep_mask`` (card only) writes the keep mask the train kernels draw
  for a seed: one mask for the forward and the backward, whatever their
  tile heights, because it is keyed on (seed, row, column);
  ``keep_mask_reference`` is its plain version (Philox4x32-10 in int64).
  The row is the row offset plus the row of the call: in a data-parallel
  run the rank's first row of the global batch's B x L rows
  (``parallel/mesh.global_rows``), so each rank draws its rows of the
  global mask; the CPU path draws the global batch's mask from the
  generator and keeps the rank's rows.

Tensor parallelism (W1's columns and W2's rows split over the model group,
F / mp columns a rank): ``fused_ffn_split`` splits either chain at its
all-reduce, with the same kernels and four more C entries.  Forward: the
products (``_FFNProducts``: u, then h W2 with a zero b2, the rank's partial
in f32), the model group's all-reduce of the partials
(``distributed.reduce_from_model``), then + b2 once and the row pass
(``_FFNRows``: dropout, residual, LayerNorm).  Backward: the row pass on
the replicated dy (dr, do, dgamma, dbeta, and db2 = sum do), then the
products on do (h, du, the weight gradients, and dx without the residual
term: du W1^T, the rank's partial), whose all-reduce
(``distributed.copy_to_model``'s backward) dr joins once, through
autograd.  ``ffn_partial_reference`` and ``ffn_rows_reference`` are the
two halves' plain versions, ``ffn_rows_backward_reference`` and
``ffn_products_backward_reference`` their backward kernels'.  At mp = 1
nothing of this runs: the one-call chains are unchanged.  A split call
counts one forward and one backward launch a site in the wrapper's
counts, as the one-call chain does.

Weights come in ``nn.Linear`` layout: ``w1t`` is (F, D), ``w2t`` is (D, F).

The attention-output block ``y = LN(x W^T + b + residual) * gamma + beta``
replaces ``_make_out_ln`` there (behind the JAX ``fused_out_ln``) with the
kernel of ``csrc/out_ln.cu``: a cluster of CTAs per row tile, each owning a
column slab (wgmma + TMA), the LayerNorm's row sums exchanged through
distributed shared memory.  ``out_ln_plan`` mirrors its launch plan.

- ``out_ln_reference`` is its plain version, with the semantics of the JAX
  ``_out_ln_reference``: the product of the given operands accumulated in
  f32 and not rounded, the f32 bias and the residual added in f32,
  two-pass LayerNorm in f32, cast to x's dtype.
- ``fused_out_ln`` runs the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor (launch or raise); ``fused_out_ln.launches``
  counts the launches.  Its backward recomputes through autograd of the
  plain version, as the JAX custom VJP does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import (
    _MASK32,
    _mask_ptr,
    _stream,
    _threshold,
    draw_seed,
    philox4x32,
)
from shgvqa_tpu_torch.models.remat import replayable
from shgvqa_tpu_torch.parallel import distributed
from shgvqa_tpu_torch.parallel.mesh import global_rows


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


def ffn_partial_reference(x2, w1t, b1, w2t):
    """Plain version of the split chain's forward products: a rank's
    partial ``gelu(x W1 + b1) W2`` in f32, h rounded to w2t's dtype, no
    b2 (the model group's partials sum to ``ffn_train_reference``'s o
    less b2)."""
    u = torch.matmul(x2.float(), w1t.float().t()) + b1.float()
    h = (u * _phi(u)).to(w2t.dtype)
    return torch.matmul(h.float(), w2t.float().t())


def ffn_rows_reference(o, x2, b2, gamma, beta, rate: float = 0.0,
                       keep: Optional[torch.Tensor] = None,
                       eps: float = 1e-12):
    """Plain version of the split chain's forward row pass: o (M, D) f32
    the summed partials; ``LN(dropout(o + b2) + x)``, (M, D) in x2's
    dtype."""
    r = _drop(o.float() + b2.float(), keep, rate) + x2.float()
    xhat, _ = _normalize(r, eps)
    return (xhat * gamma.float() + beta.float()).to(x2.dtype)


def ffn_rows_backward_reference(ob, x2, gamma, rate, keep, dy,
                                eps: float = 1e-12):
    """Plain version of the split chain's backward row pass: (dr, do,
    dgamma, dbeta) at cotangent ``dy``, ob the forward's o + b2 (f32), do
    = dropout(dr) rounded to x2's dtype (the weights')."""
    r = _drop(ob.float(), keep, rate) + x2.float()
    xhat, rstd = _normalize(r, eps)
    dy32 = dy.to(x2.dtype).float()
    a = dy32 * gamma.float()
    dr = (a - a.mean(-1, keepdim=True)
          - xhat * (a * xhat).mean(-1, keepdim=True)) * rstd
    do = _drop(dr, keep, rate).to(x2.dtype)
    return dr, do, (dy32 * xhat).sum(0), dy32.sum(0)


def ffn_products_backward_reference(x2, w1t, b1, w2t, do):
    """Plain version of the split chain's backward products on ``do``:
    (dx, du, h), dx this rank's partial du W1^T (no residual term) in x2's
    dtype, du and h rounded to the weights' dtype."""
    u = torch.matmul(x2.float(), w1t.float().t()) + b1.float()
    h = (u * _phi(u)).to(w2t.dtype)
    dh = torch.matmul(do.float(), w2t.float())
    gelu_grad = _phi(u) + u * torch.exp(-0.5 * u * u) * 0.3989422804014327
    du = (dh * gelu_grad).to(w1t.dtype)
    dx = torch.matmul(du.float(), w1t.float()).to(x2.dtype)
    return dx, du, h


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
    """One call of the forward's chain of ``csrc/ffn_train.cu`` at rate 0
    (no dropout, no seed; one ctypes call, three launches) on the current
    stream: y."""
    y = _run_fwd_chain("fused_ffn", x2, w1t, b1, w2t, b2, gamma, beta, None,
                       0.0, eps)
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
    launches the forward's chain of ``csrc/ffn_train.cu`` at rate 0 or
    raises (it takes bfloat16 x, D a multiple of 64 up to 768 and F a
    multiple of 128)."""
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


# the forward's and the backward's kernels (csrc/ffn_train.cu), in launch
# order
FWD_STAGES = ("ffn_fwd_u_kernel", "ffn_o_kernel", "ffn_fwd_rows_kernel")
BWD_STAGES = ("ffn_bwd_u_kernel", "ffn_o_kernel", "ffn_bwd_rows_kernel",
              "ffn_bwd_dh_kernel", "ffn_bwd_dx_kernel", "sum_partials_kernel")


@functools.lru_cache(maxsize=None)
def _train_lib() -> ctypes.CDLL:
    """The built ``csrc/ffn_train.cu`` with its C signatures declared."""
    return declare_train(_build.load("ffn_train"))


def declare_train(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ffn_train.cu``) with its C signatures
    declared."""
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
    lib.shgvqa_ffn_train_fwd_bf16.argtypes = (
        [ptr] * 11 + [i32] * 3 + [f32, u32, f32, i32, i32, ptr])
    lib.shgvqa_ffn_train_bwd_bf16.argtypes = (
        [ptr] * 16 + [i32] * 3 + [f32, u32, f32, i32, i32, ptr])
    lib.shgvqa_ffn_train_keep_mask.argtypes = [ptr, ptr, i32, i32, u32, i32,
                                               ptr]
    lib.shgvqa_ffn_train_fwd_products_bf16.argtypes = [ptr] * 7 + [i32] * 3 \
        + [ptr]
    lib.shgvqa_ffn_train_fwd_rows_bf16.argtypes = (
        [ptr] * 6 + [i32] * 2 + [f32, u32, f32, i32, i32, ptr])
    lib.shgvqa_ffn_train_bwd_rows_bf16.argtypes = (
        [ptr] * 8 + [i32] * 2 + [f32, u32, f32, i32, i32, ptr])
    lib.shgvqa_ffn_train_bwd_products_bf16.argtypes = [ptr] * 10 \
        + [i32] * 3 + [ptr]
    for fn in (lib.shgvqa_ffn_train_fwd_bf16, lib.shgvqa_ffn_train_bwd_bf16,
               lib.shgvqa_ffn_train_keep_mask, lib.shgvqa_ffn_train_max_d,
               lib.shgvqa_ffn_train_bwd_rows,
               lib.shgvqa_ffn_train_fwd_products_bf16,
               lib.shgvqa_ffn_train_fwd_rows_bf16,
               lib.shgvqa_ffn_train_bwd_rows_bf16,
               lib.shgvqa_ffn_train_bwd_products_bf16):
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


# the switch that turns each wrapper's kernel off, for its error messages
_SWITCH = {"fused_ffn": "use_pallas_ffn", "fused_ffn_train":
           "use_pallas_ffn_train"}


def _check_train(x2, w1t, b1, w2t, b2, gamma, beta=None,
                 what="fused_ffn_train"):
    """(M, D, F) of operands both chains take; raises on the others."""
    m, d = x2.shape
    f = w1t.shape[0]
    if x2.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{what} on CUDA takes bfloat16 activations, got {x2.dtype} "
            f"(set compute_dtype='bfloat16' or {_SWITCH[what]}=False)")
    lib = _train_lib()
    if d % 64 or f % 128 or d > lib.shgvqa_ffn_train_max_d():
        raise ValueError(f"{what}: D={d} must be a multiple of 64 and at "
                         f"most {lib.shgvqa_ffn_train_max_d()}, F={f} a "
                         "multiple of 128")
    dev = x2.device
    _check("x", x2, (m, d), torch.bfloat16, dev, what)
    _check("w1t", w1t, (f, d), torch.bfloat16, dev, what)
    _check("w2t", w2t, (d, f), torch.bfloat16, dev, what)
    _check("b1", b1, (f,), torch.float32, dev, what)
    for name, t in (("b2", b2), ("gamma", gamma), ("beta", beta)):
        if t is not None:
            _check(name, t, (d,), torch.float32, dev, what)
    return m, d, f


def _fwd_buffers(m, d, f, device):
    """The forward's output and scratch, in the C entry's order: y (bf16),
    h (M, F) bf16 and o + b2 (M, D) f32."""
    return {"y": torch.empty(m, d, dtype=torch.bfloat16, device=device),
            "h": torch.empty(m, f, dtype=torch.bfloat16, device=device),
            "o": torch.empty(m, d, dtype=torch.float32, device=device)}


def _run_fwd_chain(what, x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps,
                   buffers=None, row0=0):
    """One call of the forward's chain of kernels (one ctypes call, three
    launches) on the current stream for the wrapper ``what``: y.
    ``buffers`` (``_fwd_buffers``, made here when None) receives y, h and
    o + b2; ``row0`` is the dropout counter's row offset."""
    m, d, f = _check_train(x2, w1t, b1, w2t, b2, gamma, beta, what)
    buf = _fwd_buffers(m, d, f, x2.device) if buffers is None else buffers
    with torch.cuda.device(x2.device):
        err = _train_lib().shgvqa_ffn_train_fwd_bf16(
            x2.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _mask_ptr(seed),
            *(t.data_ptr() for t in buf.values()), m, d, f, float(eps),
            _threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0), row0,
            _stream(x2.device))
    _raise_on(err, f"{what} forward")
    return buf["y"]


def _launch_train_fwd(x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps,
                      buffers=None, row0=0):
    """``_run_fwd_chain`` for ``fused_ffn_train``: y."""
    y = _run_fwd_chain("fused_ffn_train", x2, w1t, b1, w2t, b2, gamma, beta,
                       seed, rate, eps, buffers, row0)
    fused_ffn_train.launches += 1
    return y


def _bwd_buffers(m, d, f, rows, device):
    """The backward's outputs and scratch, in the C entry's order: dx, du,
    do, h (bf16), gelu'(u) (M, F) and o + b2, then dr (M, D) in f32, the
    dgamma/dbeta partials of each ``rows``-row tile and [dgamma | dbeta]
    (f32)."""
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = (("dx", (m, d), bf16), ("du", (m, f), bf16), ("do", (m, d), bf16),
              ("h", (m, f), bf16), ("gd", (m, f), f32), ("dr", (m, d), f32),
              ("part", (-(-m // rows), 2 * d), f32), ("dgb", (2 * d,), f32))
    return {name: torch.empty(shape, dtype=dtype, device=device)
            for name, shape, dtype in shapes}


def _launch_train_bwd(x2, w1t, b1, w2t, b2, gamma, seed, rate, eps, dy,
                      row0=0):
    """One call of the backward's chain of kernels (one ctypes call, six
    launches): (dx, du, do, h, dgamma, dbeta)."""
    m, d, f = _check_train(x2, w1t, b1, w2t, b2, gamma)
    dy = dy.to(torch.bfloat16).contiguous()
    _check("dy", dy, (m, d), torch.bfloat16, x2.device, "fused_ffn_train")
    lib = _train_lib()
    buf = _bwd_buffers(m, d, f, lib.shgvqa_ffn_train_bwd_rows(), x2.device)
    with torch.cuda.device(x2.device):
        err = lib.shgvqa_ffn_train_bwd_bf16(
            x2.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), _mask_ptr(seed), dy.data_ptr(),
            *(t.data_ptr() for t in buf.values()), m, d, f, float(eps),
            _threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0), row0,
            _stream(x2.device))
    _raise_on(err, "fused_ffn_train backward")
    fused_ffn_train.bwd_launches += 1
    dgb = buf["dgb"]
    return buf["dx"], buf["du"], buf["do"], buf["h"], dgb[:d], dgb[d:]


class _FusedFFNTrain(torch.autograd.Function):
    """The forward's chain of kernels; the backward's chain regenerates the
    dropout mask from the saved seed, then the weight gradients run as plain
    products."""

    @staticmethod
    def forward(ctx, x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps,
                row0):
        ctx.save_for_backward(x2, w1t, b1, w2t, b2, gamma, seed)
        ctx.rate, ctx.eps, ctx.row0 = rate, eps, row0
        return _launch_train_fwd(x2, w1t, b1, w2t, b2, gamma, beta, seed,
                                 rate, eps, row0=row0)

    @staticmethod
    def backward(ctx, dy):
        x2, w1t, b1, w2t, b2, gamma, seed = ctx.saved_tensors
        dx, du, do, h, dgamma, dbeta = _launch_train_bwd(
            x2, w1t, b1, w2t, b2, gamma, seed, ctx.rate, ctx.eps, dy,
            ctx.row0)
        dw1t, db1, dw2t, db2 = _weight_grads(x2, du, do, h)
        return (dx, dw1t, db1, dw2t, db2, dgamma, dbeta, None, None, None,
                None)


def fused_ffn_train(x, w1t, b1, w2t, b2, gamma, beta, dropout_rate: float,
                    generator: Optional[torch.Generator] = None,
                    eps: float = 1e-12):
    """x (..., D); w1t (F, D) and w2t (D, F) in nn.Linear layout, cast to
    x's dtype here; b1, b2, gamma, beta are read in f32.  Returns (..., D)
    in x's dtype, differentiable in every input.  With ``dropout_rate`` > 0
    the output dense is dropped with a mask drawn from ``generator`` (the
    device's default one when None) and the backward uses the same mask (in
    a data-parallel run the rank's rows of the global batch's mask).  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernels
    or raises."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    first, total = global_rows(x2.shape[0])
    args = (x2, w1t.to(x.dtype), b1.float(), w2t.to(x.dtype), b2.float(),
            gamma.float(), beta.float())
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            keep = replayable(lambda: torch.rand(
                (total, d), generator=generator)[
                    first:first + x2.shape[0]] >= rate)
        y = ffn_train_reference(*args, rate, keep, eps)
    elif x.device.type == "cuda":
        y = _card_ffn_train(args, rate, generator, eps, first)
    else:
        raise NotImplementedError(f"fused_ffn_train has no kernel for "
                                  f"{x.device}")
    return y.reshape(x.shape)


def _card_ffn_train(args, rate, generator, eps, first):
    """``fused_ffn_train``'s card path on its (M, D) operands: the seed
    drawn, the kernels launched."""
    seed = (replayable(lambda: draw_seed(generator, args[0].device))
            if rate > 0.0 else None)
    return _FusedFFNTrain.apply(*(a.contiguous() for a in args), seed, rate,
                                float(eps), first)


fused_ffn_train.launches = 0
fused_ffn_train.bwd_launches = 0


# -- the split chain (tensor parallelism) ------------------------------------

# the wrapper whose counts a split call moves
_WRAPPERS = {"fused_ffn": fused_ffn, "fused_ffn_train": fused_ffn_train}


def _launch_split(what, fn, *args):
    with torch.cuda.device(args[0].device):
        err = getattr(_train_lib(), fn)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], _stream(args[0].device))
    _raise_on(err, f"{what} ({fn})")


class _FFNProducts(torch.autograd.Function):
    """A rank's partial ``gelu(x W1 + b1) W2`` (f32, no b2): the split
    chain's forward products; backward its products on do: dx without the
    residual term, and the weight gradients."""

    @staticmethod
    def forward(ctx, x2, w1t, b1, w2t, what):
        m, d, f = _check_train(x2, w1t, b1, w2t, None, None, None, what)
        dev = x2.device
        h = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
        o = torch.empty(m, d, dtype=torch.float32, device=dev)
        zero = torch.zeros(d, dtype=torch.float32, device=dev)
        _launch_split(what, "shgvqa_ffn_train_fwd_products_bf16", x2, w1t,
                      b1, w2t, zero, h, o, m, d, f)
        ctx.save_for_backward(x2, w1t, b1, w2t)
        ctx.what = what
        return o

    @staticmethod
    def backward(ctx, d_o):
        x2, w1t, b1, w2t = ctx.saved_tensors
        m, d, f = x2.shape[0], x2.shape[1], w1t.shape[0]
        dev = x2.device
        do = d_o.to(torch.bfloat16).contiguous()
        dx = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
        du = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
        h = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
        gd = torch.empty(m, f, dtype=torch.float32, device=dev)
        zero = torch.zeros(m, d, dtype=torch.float32, device=dev)
        _launch_split(ctx.what, "shgvqa_ffn_train_bwd_products_bf16", x2,
                      w1t, b1, w2t, do, zero, dx, du, h, gd, m, d, f)
        _WRAPPERS[ctx.what].bwd_launches += 1
        dw1t, db1, dw2t, _ = _weight_grads(x2, du, do, h)
        return dx, dw1t, db1, dw2t, None


class _FFNRows(torch.autograd.Function):
    """The split chain's row pass on o (the summed partials, f32): + b2,
    dropout, residual, LayerNorm; backward its row pass: d o = do, dx =
    dr (the residual term), db2, dgamma, dbeta."""

    @staticmethod
    def forward(ctx, o, x2, b2, gamma, beta, seed, rate, eps, row0, what):
        m, d = x2.shape
        dev = x2.device
        _check("x", x2, (m, d), torch.bfloat16, dev, what)
        for name, t in (("b2", b2), ("gamma", gamma), ("beta", beta)):
            _check(name, t, (d,), torch.float32, dev, what)
        ob = (o + b2).contiguous()
        y = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
        _launch_split(what, "shgvqa_ffn_train_fwd_rows_bf16", x2, ob, gamma,
                      beta, seed, y, m, d,
                      float(eps), _threshold(rate), 1.0 / (1.0 - rate),
                      int(rate > 0.0), row0)
        _WRAPPERS[what].launches += 1
        ctx.save_for_backward(ob, x2, gamma, seed)
        ctx.rate, ctx.eps, ctx.row0, ctx.what = rate, eps, row0, what
        return y

    @staticmethod
    def backward(ctx, dy):
        ob, x2, gamma, seed = ctx.saved_tensors
        m, d = x2.shape
        dev = x2.device
        dy = dy.to(torch.bfloat16).contiguous()
        dr = ob.clone()
        do = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
        rows = _train_lib().shgvqa_ffn_train_bwd_rows()
        part = torch.empty(-(-m // rows), 2 * d, dtype=torch.float32,
                           device=dev)
        dgb = torch.empty(2 * d, dtype=torch.float32, device=dev)
        _launch_split(ctx.what, "shgvqa_ffn_train_bwd_rows_bf16", x2, gamma,
                      seed, dy, do, dr, part, dgb, m, d, float(ctx.eps),
                      _threshold(ctx.rate), 1.0 / (1.0 - ctx.rate),
                      int(ctx.rate > 0.0), ctx.row0)
        return (do.float(), dr.to(x2.dtype), do.float().sum(0), dgb[:d],
                dgb[d:], None, None, None, None, None)


def fused_ffn_split(x, w1t, b1, w2t, b2, gamma, beta,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    eps: float = 1e-12, what: str = "fused_ffn_train"):
    """The FFN block with W1's columns (w1t (F / mp, D), b1) and W2's rows
    (w2t (D, F / mp)) this rank's shards, b2, gamma, beta whole: the
    products, the model group's all-reduce of the partials, + b2 once and
    the row pass (dropout at ``dropout_rate`` from ``generator``, the
    one-process mask of the rank's rows, the same on every model index).
    ``what`` names the wrapper it stands in for (``fused_ffn`` at rate 0 or
    ``fused_ffn_train``), whose counts it moves.  Differentiable.  A CPU
    tensor takes the plain versions; a CUDA tensor launches the split
    chain or raises (F / mp a multiple of 128, as the chain's F)."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    first, total = global_rows(x2.shape[0])
    xin = distributed.copy_to_model(x2)
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            keep = replayable(lambda: torch.rand(
                (total, d), generator=generator)[
                    first:first + x2.shape[0]] >= rate)
        o = distributed.reduce_from_model(ffn_partial_reference(
            xin, w1t.to(x.dtype), b1.float(), w2t.to(x.dtype)))
        y = ffn_rows_reference(o, x2, b2, gamma, beta, rate, keep, eps)
    elif x.device.type == "cuda":
        y = _card_ffn_split(xin, x2, w1t.to(x.dtype), b1, w2t.to(x.dtype),
                            b2, gamma, beta, rate, generator, eps, first,
                            what)
    else:
        raise NotImplementedError(f"{what} has no kernel for {x.device}")
    return y.reshape(x.shape)


def _card_ffn_split(xin, x2, w1t, b1, w2t, b2, gamma, beta, rate,
                    generator, eps, first, what):
    """``fused_ffn_split``'s card path on its (M, D) operands (``xin`` the
    input of the products, ``x2`` the residual): the seed drawn, the
    products, the model group's all-reduce, the row pass."""
    seed = (replayable(lambda: draw_seed(generator, x2.device))
            if rate > 0.0 else None)
    o = distributed.reduce_from_model(_FFNProducts.apply(
        xin.contiguous(), w1t.contiguous(), b1.float().contiguous(),
        w2t.contiguous(), what))
    return _FFNRows.apply(o, x2.contiguous(), b2.float().contiguous(),
                          gamma.float().contiguous(),
                          beta.float().contiguous(), seed, rate, float(eps),
                          first, what)


def keep_mask(seed: torch.Tensor, m: int, d: int, rate: float,
              row0: int = 0) -> torch.Tensor:
    """The bool (M, D) keep mask the train kernels draw from ``seed`` (a
    CUDA int64 tensor of 2 words) at ``rate`` for rows ``row0`` ..
    ``row0 + M - 1``; card only."""
    if seed.device.type != "cuda":
        raise NotImplementedError("keep_mask runs on the card only")
    out = torch.empty(m, d, dtype=torch.uint8, device=seed.device)
    with torch.cuda.device(seed.device):
        err = _train_lib().shgvqa_ffn_train_keep_mask(
            seed.data_ptr(), out.data_ptr(), m, d, _threshold(rate), row0,
            _stream(seed.device))
    _raise_on(err, "fused_ffn_train keep_mask")
    return out.bool()


def keep_mask_reference(seed_words, m: int, d: int, rate: float,
                        row0: int = 0) -> torch.Tensor:
    """Plain version of ``keep_mask``: the bool (M, D) keep mask of the
    seed's two words (a tensor or a sequence of ints) for rows ``row0`` ..
    ``row0 + M - 1``: keep (row, col) where word col % 4 of Philox4x32-10
    at counter (col / 4, row, 0, 0) is at least the threshold, in int64 on
    the CPU."""
    if isinstance(seed_words, torch.Tensor):
        seed_words = seed_words.cpu().tolist()
    key = [int(w) & _MASK32 for w in seed_words]
    zero = torch.zeros(1, 1, dtype=torch.int64)
    words = torch.stack(torch.broadcast_tensors(*philox4x32((
        torch.arange((d + 3) // 4)[None, :],
        torch.arange(row0, row0 + m)[:, None], zero, zero), key)), -1)
    return words.reshape(m, -1)[:, :d] >= _threshold(rate)


# ---------------------------------------------------------------------------
# Attention output: csrc/out_ln.cu


def out_ln_reference(x2, w, b, res2, gamma, beta, eps: float = 1e-12):
    """Plain version: x2, res2 (M, D); w (D, D) in nn.Linear layout; b,
    gamma, beta f32.  Returns LN(x2 w^T + b + res2) (M, D) in x2's dtype."""
    o = torch.matmul(x2.float(), w.float().t()) + b.float()
    xhat, _ = _normalize(o + res2.float(), eps)
    return (xhat * gamma.float() + beta.float()).to(x2.dtype)


# Mirror of csrc/out_ln.cu's plan (kMaxCluster, kMaxSlab, kMaxD, the row
# tiles kGemmBM and kNarrowRows)
OUT_LN_MAX_CLUSTER, OUT_LN_MAX_SLAB = 4, 192
OUT_LN_MAX_D = OUT_LN_MAX_CLUSTER * OUT_LN_MAX_SLAB
OUT_LN_ROWS = (128, 64)


def out_ln_cluster(d: int) -> Optional[int]:
    """CTAs of a cluster at width ``d``: the largest c <= 4 that cuts D
    into slabs of a multiple of 64 columns and at most 192; None where
    there is none (D not a multiple of 64, above 768, or 320, 448, 640,
    704)."""
    if d <= 0 or d % 64 or d > OUT_LN_MAX_D:
        return None
    for c in range(OUT_LN_MAX_CLUSTER, 0, -1):
        if d % (64 * c) == 0 and d // c <= OUT_LN_MAX_SLAB:
            return c
    return None


def out_ln_plan(m: int, d: int, sms: int):
    """(cluster, slab, rows, row tiles) of an (M, D) call on ``sms`` SMs:
    the grid is cluster x row tiles CTAs, one CTA an SM; rows are 128 where
    the 128-row tiles' CTAs fill at least one wave and 3/4 of their waves,
    else 64."""
    c = out_ln_cluster(d)
    if c is None or m <= 0:
        raise ValueError(f"out_ln_plan: no plan for M={m}, D={d}")
    ctas = -(-m // OUT_LN_ROWS[0]) * c
    waves = -(-ctas // sms)
    wide = ctas >= sms and 4 * ctas >= 3 * waves * sms
    rows = OUT_LN_ROWS[0] if wide else OUT_LN_ROWS[1]
    return c, d // c, rows, -(-m // rows)


def declare_out_ln(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/out_ln.cu``, with its C signatures
    declared and its largest width read once (``max_d``)."""
    lib.shgvqa_out_ln_bf16.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_void_p])
    lib.shgvqa_out_ln_bf16.restype = ctypes.c_int
    lib.shgvqa_out_ln_max_d.argtypes = []
    lib.shgvqa_out_ln_max_d.restype = ctypes.c_int
    lib.shgvqa_out_ln_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.shgvqa_out_ln_plan.restype = ctypes.c_int
    lib.shgvqa_out_ln_error_string.argtypes = [ctypes.c_int]
    lib.shgvqa_out_ln_error_string.restype = ctypes.c_char_p
    lib.max_d = lib.shgvqa_out_ln_max_d()
    return lib


@functools.lru_cache(maxsize=None)
def _out_ln_lib() -> ctypes.CDLL:
    """The built ``csrc/out_ln.cu``, declared."""
    return declare_out_ln(_build.load("out_ln"))


def out_ln_kernel_plan(m: int, d: int, sms: int):
    """The built kernel's own plan of an (M, D) call on ``sms`` SMs, as
    ``out_ln_plan`` gives it (card builds only: it loads the library)."""
    plan = (ctypes.c_int * 4)()
    err = _out_ln_lib().shgvqa_out_ln_plan(m, d, sms, ctypes.addressof(plan))
    if err:
        raise ValueError(f"shgvqa_out_ln_plan: no plan for M={m}, D={d}")
    return tuple(plan)


def _launch_out_ln(x2, w, b, res2, gamma, beta, eps, lib=None):
    """One launch of the CUDA kernel (of ``lib``, a declared build, or of
    ``csrc/out_ln.cu``) on the current stream."""
    m, d = x2.shape
    what = "fused_out_ln"
    lib = lib or _out_ln_lib()
    if d > lib.max_d:
        raise ValueError(f"fused_out_ln: D={d} exceeds the kernel's maximum "
                         f"{lib.max_d}")
    dev = x2.device
    _check("x", x2, (m, d), torch.bfloat16, dev, what)
    _check("residual", res2, (m, d), torch.bfloat16, dev, what)
    _check("w", w, (d, d), torch.bfloat16, dev, what)
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        _check(name, t, (d,), torch.float32, dev, what)
    y = torch.empty_like(x2)
    with torch.cuda.device(dev):
        err = lib.shgvqa_out_ln_bf16(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), res2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), m, d,
            float(eps), _stream(dev))
    if err:
        raise RuntimeError(
            f"fused_out_ln kernel launch failed: CUDA error {err} "
            f"({lib.shgvqa_out_ln_error_string(err).decode()})")
    fused_out_ln.launches += 1
    return y


class _FusedOutLN(torch.autograd.Function):
    """The kernel forward; the backward recomputes through autograd of
    ``out_ln_reference``."""

    @staticmethod
    def forward(ctx, x2, w, b, res2, gamma, beta, eps):
        ctx.save_for_backward(x2, w, b, res2, gamma, beta)
        ctx.eps = eps
        return _launch_out_ln(x2, w, b, res2, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = out_ln_reference(*inputs, ctx.eps)
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def fused_out_ln(x, weight, bias, residual, gamma, beta, eps: float = 1e-12):
    """x, residual (..., D); weight (D, D) in nn.Linear layout, cast to x's
    dtype here; bias, gamma, beta are read in f32.  Returns LN(x weight^T +
    bias + residual) * gamma + beta, (..., D) in x's dtype, differentiable.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    d = x.shape[-1]
    if tuple(residual.shape) != tuple(x.shape):
        raise ValueError(f"fused_out_ln: residual {tuple(residual.shape)} "
                         f"and x {tuple(x.shape)} differ")
    args = (x.reshape(-1, d), weight.to(x.dtype), bias.float(),
            residual.to(x.dtype).reshape(-1, d), gamma.float(), beta.float())
    if x.device.type == "cpu":
        return out_ln_reference(*args, eps).reshape(x.shape)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused_out_ln's kernel takes bfloat16 activations, got "
            f"{x.dtype} (set compute_dtype='bfloat16' or leave the out_ln "
            "kernel off)")
    if out_ln_cluster(d) is None:
        raise ValueError(
            f"fused_out_ln: D={d} must be a multiple of 64 that splits into "
            f"at most {OUT_LN_MAX_CLUSTER} slabs of 64, 128 or 192 columns "
            "(64, 128, 192, 256, 384, 512, 576 or 768); leave "
            "set_out_ln_kernel off at this width")
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_out_ln has no kernel for "
                                  f"{x.device}")
    y = _FusedOutLN.apply(*(a.contiguous() for a in args), float(eps))
    return y.reshape(x.shape)


fused_out_ln.launches = 0

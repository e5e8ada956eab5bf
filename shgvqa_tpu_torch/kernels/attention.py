"""Fused attention with dropout on the probabilities, forward and backward.

Replaces ``shgvqa_tpu/kernels/attention.py::_make_core``, the Pallas TPU
kernels behind the JAX ``fused_attention`` (forward ``_fwd_kernel``,
backward ``_bwd_kernel``), with the hand-written CUDA C++ kernels in
``csrc/attention.cu`` (sm_90a, built by ``kernels/_build.py`` and bound
with ``ctypes``).  On the card both are bound by device memory at every
main-path shape (at most ~200 operations a byte, under the H100's ~295);
the (Lq, Lk) scores and probabilities never leave the chip, and the
backward regenerates the forward's dropout mask from the seed instead of
storing it.  ``attention.cu`` describes the design.

- ``decompose_mask`` splits an additive mask broadcastable to
  (B, H, Lq, Lk) into a per-batch key row (B, Lk) and a shared (Lq, Lk)
  pane, the only two shapes the model uses; any other shape raises
  ``ValueError``, as the JAX ``_decompose_mask`` contract does.
- ``attention_reference`` is the plain forward with the TPU kernel's
  numerics: products of the given operands in f32, f32 softmax, dropout
  on the normalized probabilities with an explicit keep mask (or none),
  scaled by 1/keep and then cast to v's dtype.
- ``attention_backward_reference`` is the plain backward with the kernel's
  algorithm: P recomputed from the saved logsumexp, one keep mask,
  ``delta = rowsum(dO * O)`` (equal to the JAX ``rowsum(dP * P)`` in exact
  arithmetic), dS rounded to the operands' dtype before the dQ, dK
  products.
- ``fused_attention`` runs the plain forward (and autograd through it) for
  tensors on the CPU, drawing its keep mask from the caller's generator,
  and the kernels for CUDA tensors; on the card it launches them or
  raises.  ``fused_attention.launches`` and ``.bwd_launches`` count the
  forward and backward calls that launch (one each, though a backward
  makes three CUDA launches).
- ``keep_mask`` (card only) writes the keep mask the kernels draw for a
  seed, so that the plain version can be given exactly that mask;
  ``keep_mask_reference`` is its plain version (Philox4x32-10 in int64).

Dropout: keep where a Philox4x32-10 word >= round(rate * 2^32) (the TPU
kernel's threshold).  The 64-bit seed is drawn from the caller's generator
on the tensors' device and stays there, so a call costs the host no sync.
One Philox call decides queries {q, q + 8} x keys {k, k + 8}
(``keep_counter``), a 2 x 2 block that one lane of the kernels' m16n8k16
tiles owns whether the rows of the tile are queries (forward) or keys
(backward).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from shgvqa_tpu_torch.kernels import _build

HEAD_DIM = 64


def decompose_mask(mask: Optional[torch.Tensor], b: int, h: int, lq: int,
                   lk: int) -> Tuple[Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Additive mask broadcastable to (B, H, Lq, Lk) -> (key row (B, Lk) or
    None, pane (Lq, Lk) or None), both f32 and contiguous."""
    if mask is None:
        return None, None
    m = mask.float()
    if m.dim() == 2:
        m = m[None, None]
    if m.dim() != 4 or (m.shape[1] != 1 and h != 1):
        raise ValueError(f"unsupported mask shape {tuple(mask.shape)} for "
                         "fused attention")
    mb, _, mq, _ = m.shape
    if mq == 1:
        return m[:, 0, 0, :].expand(b, lk).contiguous(), None
    if mb == 1:
        return None, m[0, 0].expand(lq, lk).contiguous()
    raise ValueError(f"unsupported mask shape {tuple(mask.shape)} for "
                     "fused attention")


def _scores(q, k, key, pane):
    """f32 scores of the given operands, scaled, plus the masks."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if key is not None:
        s = s + key[:, None, None, :]
    if pane is not None:
        s = s + pane
    return s


def _drop(p, keep, rate):
    return p if keep is None else torch.where(keep, p * (1.0 / (1.0 - rate)),
                                              0.0)


def attention_reference(q, k, v, mask=None, dropout_rate: float = 0.0,
                        keep: Optional[torch.Tensor] = None):
    """Plain version: q (B, H, Lq, D), k, v (B, H, Lk, D); mask additive,
    broadcastable to (B, H, Lq, Lk), or None; keep a bool (B, H, Lq, Lk)
    mask of the probabilities kept, or None for no dropout.  Returns
    (B, H, Lq, D) in q's dtype."""
    b, h, lq, _ = q.shape
    key, pane = decompose_mask(mask, b, h, lq, k.shape[2])
    p = torch.softmax(_scores(q, k, key, pane), dim=-1)
    pd = _drop(p, keep, dropout_rate).to(v.dtype)
    return torch.matmul(pd.float(), v.float()).to(q.dtype)


def attention_backward_reference(q, k, v, mask, dropout_rate, keep, o, do):
    """Plain version of the backward kernels: (dq, dk, dv) of
    ``attention_reference`` at cotangent ``do``, given its output ``o``."""
    b, h, lq, d = q.shape
    key, pane = decompose_mask(mask, b, h, lq, k.shape[2])
    s = _scores(q, k, key, pane)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    pd = _drop(p, keep, dropout_rate)
    do32 = do.float()
    dv = torch.matmul(pd.to(v.dtype).float().transpose(-1, -2), do32)
    dp = _drop(torch.matmul(do32, v.float().transpose(-1, -2)), keep,
               dropout_rate)
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    scale = 1.0 / math.sqrt(d)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _threshold(rate: float) -> int:
    return min(2 ** 32 - 1, int(round(rate * 2.0 ** 32)))


_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def keep_counter(q, k):
    """(first counter word, second counter word, index of the output word)
    of the Philox call that decides (query q, key k): one call covers
    queries {q, q + 8} x keys {k, k + 8} with q, k at an offset < 8 in their
    16-block.  Works on ints and on integer tensors."""
    return (((q >> 4) << 3) | (q & 7), ((k >> 4) << 3) | (k & 7),
            2 * ((q >> 3) & 1) + ((k >> 3) & 1))


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit halves of a * b, for a < 2^32 and b an int64
    tensor of values < 2^32, without overflowing int64."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(counter, key):
    """Philox4x32-10 of four int64 tensors holding uint32 counter words
    (broadcast together) under two uint32 key words: the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def keep_mask_reference(seed_words, groups: int, lq: int, lk: int,
                        rate: float) -> torch.Tensor:
    """Plain version of ``keep_mask``: the bool (groups, Lq, Lk) keep mask
    of the seed's two words (a tensor or a sequence of ints), Philox4x32-10
    under the kernels' counter layout, in int64 on the CPU."""
    if isinstance(seed_words, torch.Tensor):
        seed_words = seed_words.cpu().tolist()
    key = [int(w) & _MASK32 for w in seed_words]
    q, k = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    cq, ck, word = keep_counter(q, k)
    # every call of the (groups, Lq, Lk) block once, then each element's word
    calls_q, calls_k = (lq + 15) // 16 * 8, (lk + 15) // 16 * 8
    words = torch.stack(torch.broadcast_tensors(*philox4x32((
        torch.arange(calls_q)[None, :, None],
        torch.arange(calls_k)[None, None, :],
        torch.arange(groups)[:, None, None],
        torch.zeros(1, 1, 1, dtype=torch.int64)), key)), -1)
    bits = words[:, cq, ck, word]
    return bits >= _threshold(rate)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/attention.cu`` with its C signatures declared."""
    lib = _build.load("attention")
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
    lib.shgvqa_attention_fwd_bf16.argtypes = (
        [ptr] * 8 + [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 4
        + [f32, u32, f32, i32, ptr])
    lib.shgvqa_attention_bwd_bf16.argtypes = (
        [ptr] * 14 + [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 4
        + [f32, u32, f32, i32, ptr])
    lib.shgvqa_attention_keep_mask.argtypes = [ptr, ptr, i32, i32, i32, u32,
                                               ptr]
    for fn in (lib.shgvqa_attention_fwd_bf16, lib.shgvqa_attention_bwd_bf16,
               lib.shgvqa_attention_keep_mask):
        fn.restype = i32
    lib.shgvqa_attention_error_string.argtypes = [i32]
    lib.shgvqa_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({_lib().shgvqa_attention_error_string(err).decode()})")


def _operand(name, t, shape, device):
    """t as the kernel reads it: bf16 on ``device``, shape (B, H, L, 64),
    head dim contiguous, rows 16-byte aligned (copied only if not)."""
    if t.device != device:
        raise ValueError(f"fused_attention: {name} is on {t.device}, q on "
                         f"{device}")
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused_attention on CUDA takes bfloat16 operands, {name} is "
            f"{t.dtype} (set compute_dtype='bfloat16' or "
            "use_pallas_attention_train=False)")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_attention: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def _blhd(b, h, length, like):
    """A (B, L, H, 64) buffer seen as (B, H, L, 64): the layout the model's
    projections take and give without a copy."""
    return torch.empty(b, length, h, HEAD_DIM, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _mask_ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(q, k, v, key, pane, seed, rate):
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    o = _blhd(b, h, lq, q)
    lse = torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().shgvqa_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key),
            _mask_ptr(pane), _mask_ptr(seed), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), b, h, lq, lk, 1.0 / math.sqrt(HEAD_DIM),
            _threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
            _stream(q.device))
    _raise_on(err, "fused_attention forward")
    fused_attention.launches += 1
    return o, lse


def _launch_bwd(q, k, v, key, pane, seed, rate, o, lse, do):
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    do = _operand("do", do, tuple(o.shape), q.device)
    dq, dk, dv = _blhd(b, h, lq, q), _blhd(b, h, lk, k), _blhd(b, h, lk, v)
    delta = torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
    dq_acc = torch.empty(b * h, lq, HEAD_DIM, dtype=torch.float32,
                         device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().shgvqa_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key),
            _mask_ptr(pane), _mask_ptr(seed), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, o, do, dq, dk, dv), b, h, lq,
            lk, 1.0 / math.sqrt(HEAD_DIM), _threshold(rate),
            1.0 / (1.0 - rate), int(rate > 0.0), _stream(q.device))
    _raise_on(err, "fused_attention backward")
    fused_attention.bwd_launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """The forward kernel; the backward kernels regenerate its dropout mask
    from the saved seed and recompute P from the saved logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, key, pane, seed, rate):
        o, lse = _launch_fwd(q, k, v, key, pane, seed, rate)
        ctx.save_for_backward(q, k, v, key, pane, seed, o, lse)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key, pane, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, key, pane, seed, ctx.rate, o, lse,
                                 do)
        return dq, dk, dv, None, None, None, None


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """Two int64 seed words from ``generator`` (the device's default one
    when None), left on ``device``."""
    gdev = generator.device if generator is not None else device
    seed = torch.randint(0, 2 ** 62, (2,), generator=generator, device=gdev,
                         dtype=torch.int64)
    return seed.to(device, non_blocking=True)


def fused_attention(q, k, v, mask=None, dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """q (B, H, Lq, D), k, v (B, H, Lk, D); mask additive, broadcastable to
    (B, H, Lq, Lk) as a (B, 1, 1, Lk) key mask or an (Lq, Lk) pane, or None.
    Returns (B, H, Lq, D) in q's dtype.  Differentiable; with
    ``dropout_rate`` > 0 the probabilities are dropped with a mask drawn
    from ``generator`` and the backward uses the same mask.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels or
    raises."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    key, pane = decompose_mask(mask, b, h, lq, lk)
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if q.device.type == "cpu":
        keep = None
        if rate > 0.0:
            keep = torch.rand((b, h, lq, lk), generator=generator) >= rate
        return attention_reference(q, k, v, mask, rate, keep)
    if q.device.type != "cuda":
        raise NotImplementedError(f"fused_attention has no kernel for "
                                  f"{q.device}")
    if d != HEAD_DIM:
        raise ValueError(f"fused_attention on CUDA takes head dim "
                         f"{HEAD_DIM}, got {d}")
    dev = q.device
    q = _operand("q", q, (b, h, lq, d), dev)
    k = _operand("k", k, (b, h, lk, d), dev)
    v = _operand("v", v, (b, h, lk, d), dev)
    key = None if key is None else key.to(dev)
    pane = None if pane is None else pane.to(dev)
    seed = draw_seed(generator, dev) if rate > 0.0 else None
    return _FusedAttention.apply(q, k, v, key, pane, seed, rate)


fused_attention.launches = 0
fused_attention.bwd_launches = 0


def keep_mask(seed: torch.Tensor, groups: int, lq: int, lk: int,
              rate: float) -> torch.Tensor:
    """The bool (groups, Lq, Lk) keep mask the kernels draw from ``seed``
    (a CUDA int64 tensor of 2 words) at ``rate``; card only."""
    if seed.device.type != "cuda":
        raise NotImplementedError("keep_mask runs on the card only")
    out = torch.empty(groups, lq, lk, dtype=torch.uint8, device=seed.device)
    with torch.cuda.device(seed.device):
        err = _lib().shgvqa_attention_keep_mask(
            seed.data_ptr(), out.data_ptr(), groups, lq, lk,
            _threshold(rate), _stream(seed.device))
    _raise_on(err, "keep_mask")
    return out.bool()

"""Head-sliced attention on the projections' own (B, L, H*D) layout,
forward only, no dropout.

Replaces ``tools/proto_headsliced_attn.py::make_headsliced``, the Pallas TPU
prototype that slices each head's D-column pane inside the kernel instead
of transposing q, k, v to (B, H, L, D) and the output back.  On the card it
runs the fused attention forward kernel of ``csrc/attention.cu``
(``attn_fwd_kernel``, its rate-0 instance, sm_90a, built by
``kernels/_build.py`` and bound with ``ctypes``): that kernel reads its
operands through (batch, head, row) strides with the head dim contiguous,
and the (B, L, H*64) projections are one set of such strides (batch
L*H*64, head 64, row H*64), so the head panes are read in place and the
output is written into (B, Lq, H*64) with no copy or transpose.  It is
bound by device memory at every main-path shape; ``attention.cu`` describes
the design (one online-softmax pass, K, V and the key row streamed through
shared memory).

- ``headsliced_reference`` is the plain version with the prototype's
  numerics: per head, f32 scores of the given operands scaled by 1/sqrt(D),
  plus the key row and the pane, f32 softmax normalized, then cast to v's
  dtype for the product with v (f32 sums), output in q's dtype.
- ``headsliced_attention`` runs the plain version for a tensor on the CPU
  and the kernel for a CUDA tensor (launch or raise).  The mask contract is
  ``decompose_mask``'s: a (B, 1, 1, Lk) key row, an (Lq, Lk) pane, or None;
  any other shape raises ``ValueError``.  It records no gradient (forward
  only, as the prototype).  ``headsliced_attention.launches`` counts its
  launches (``fused_attention.launches`` does not move).
"""

from __future__ import annotations

import ctypes
import math

import torch

from shgvqa_tpu_torch.kernels import attention
from shgvqa_tpu_torch.kernels.attention import (
    HEAD_DIM,
    _mask_ptr,
    _stream,
    decompose_mask,
)


def _split(x, heads):
    """(B, L, H*D) -> (B, H, L, D) view."""
    b, length, hd = x.shape
    return x.view(b, length, heads, hd // heads).transpose(1, 2)


def headsliced_reference(q2, k2, v2, key=None, pane=None, *, heads: int):
    """Plain version: q2 (B, Lq, H*D), k2, v2 (B, Lk, H*D); key (B, Lk) and
    pane (Lq, Lk) f32 or None.  Returns (B, Lq, H*D) in q2's dtype."""
    q, k, v = (_split(x, heads) for x in (q2, k2, v2))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if key is not None:
        s = s + key.float()[:, None, None, :]
    if pane is not None:
        s = s + pane.float()
    p = torch.softmax(s, dim=-1).to(v2.dtype)
    o = torch.matmul(p.float(), v.float()).to(q2.dtype)
    return o.transpose(1, 2).reshape(q2.shape)


def _operand(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"headsliced_attention: {name} is on {t.device}, q "
                         f"on {device}")
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"headsliced_attention's kernel takes bfloat16 operands, {name} "
            f"is {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"headsliced_attention: {name} must have shape "
                         f"{shape}, got {tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"headsliced_attention: {name} must be 16-byte "
                         "aligned")
    return t


def _launch(q2, k2, v2, key, pane, heads):
    """One launch of the attention forward kernel at rate 0 on the
    projections' strides (batch L*H*64, head 64, row H*64)."""
    b, lq, hd = q2.shape
    lk = k2.shape[1]
    dev = q2.device
    q2 = _operand("q", q2, (b, lq, hd), dev)
    k2 = _operand("k", k2, (b, lk, hd), dev)
    v2 = _operand("v", v2, (b, lk, hd), dev)
    key, pane = (None if m is None else m.to(dev) for m in (key, pane))
    o = torch.empty_like(q2)
    # the C entry's logsumexp output, scratch here (< 1% of the bytes)
    lse = torch.empty(b * heads, lq, dtype=torch.float32, device=dev)
    # (batch, head, row) strides of q, k, v and o, the head dim contiguous
    q_strides, k_strides = (lq * hd, HEAD_DIM, hd), (lk * hd, HEAD_DIM, hd)
    strides = (ctypes.c_longlong * 12)(*q_strides, *k_strides, *k_strides,
                                       *q_strides)
    with torch.cuda.device(dev):
        err = attention._lib().shgvqa_attention_fwd_bf16(
            q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), _mask_ptr(key),
            _mask_ptr(pane), None, o.data_ptr(), lse.data_ptr(), strides, b,
            heads, lq, lk, 1.0 / math.sqrt(HEAD_DIM), 0, 1.0, 0, 0, heads, 0,
            _stream(dev))
    attention._raise_on(err, "headsliced_attention")
    headsliced_attention.launches += 1
    return o


def headsliced_attention(q2, k2, v2, mask=None, num_heads: int = 12):
    """q2 (B, Lq, H*D), k2, v2 (B, Lk, H*D): the projections as they come;
    mask additive, broadcastable to (B, H, Lq, Lk) as a (B, 1, 1, Lk) key
    row or an (Lq, Lk) pane, or None.  Returns (B, Lq, H*D) in q2's dtype.
    Forward only.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    b, lq, hd = q2.shape
    lk = k2.shape[1]
    if hd % num_heads:
        raise ValueError(f"headsliced_attention: width {hd} is not a "
                         f"multiple of {num_heads} heads")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q2, k2, v2)):
        raise RuntimeError("headsliced_attention is forward only (as the "
                           "TPU prototype): run it under torch.no_grad() or "
                           "inference_mode")
    key, pane = decompose_mask(mask, b, num_heads, lq, lk)
    if q2.device.type == "cpu":
        return headsliced_reference(q2, k2, v2, key, pane, heads=num_heads)
    if q2.dtype != torch.bfloat16:
        raise NotImplementedError(f"headsliced_attention's kernel takes "
                                  f"bfloat16 operands, got {q2.dtype}")
    if hd // num_heads != HEAD_DIM:
        raise ValueError(f"headsliced_attention's kernel takes head dim "
                         f"{HEAD_DIM}, got {hd // num_heads}")
    if q2.device.type != "cuda":
        raise NotImplementedError(f"headsliced_attention has no kernel for "
                                  f"{q2.device}")
    return _launch(q2, k2, v2, key, pane, num_heads)


headsliced_attention.launches = 0

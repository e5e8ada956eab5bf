"""DETR-style hypergraph decoder: the port of ``shgvqa_tpu/models/decoder.py``
(post-norm, unscanned).

Per layer: self-attention over the queries under the situation-causal
additive mask, cross-attention into the visual memory, ReLU FFN; residual +
LayerNorm(eps 1e-5) after each.  The learned queries are added to q/k at
every layer and the first target is zeros.  ``in_proj`` is torch's packed
[q; k; v] weight (xavier-uniform), applied slice by slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.models.layers import Dense, LayerNorm, attend


class TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention math: packed in_proj, f32 scores, additive
    f32 mask, plain matmuls and softmax."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_proj = Dense(d_model, 3 * d_model, dtype, init="xavier")
        self.out_proj = Dense(d_model, d_model, dtype)
        self.num_heads = num_heads
        self.dtype = dtype

    def _project(self, x, part: int):
        d = x.shape[-1]
        dt = self.dtype
        w = self.in_proj.weight[part * d:(part + 1) * d].to(dt)
        b = self.in_proj.bias[part * d:(part + 1) * d].to(dt)
        return F.linear(x.to(dt), w, b)

    def forward(self, query, key, value, attn_mask=None):
        b, lq, d = query.shape
        lk = key.shape[1]
        h = self.num_heads
        hd = d // h
        q = self._project(query, 0).view(b, lq, h, hd).transpose(1, 2)
        k = self._project(key, 1).view(b, lk, h, hd).transpose(1, 2)
        v = self._project(value, 2).view(b, lk, h, hd).transpose(1, 2)
        out = attend(q, k, v, attn_mask, self.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, d))


class LayerNormT(LayerNorm):
    """LayerNorm with torch's default eps 1e-5 (the decoder's norms)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, dtype=dtype)


class DecoderLayer(nn.Module):
    """Post-norm DETR decoder layer."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads, dtype)
        self.norm1 = LayerNormT(d_model, dtype)
        self.multihead_attn = TorchMHA(d_model, num_heads, dtype)
        self.norm2 = LayerNormT(d_model, dtype)
        self.linear1 = Dense(d_model, ffn_dim, dtype)
        self.linear2 = Dense(ffn_dim, d_model, dtype)
        self.norm3 = LayerNormT(d_model, dtype)

    def forward(self, tgt, memory, query_pos, tgt_mask=None, memory_mask=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt, tgt_mask))
        ca = self.multihead_attn(tgt + query_pos, memory, memory, memory_mask)
        tgt = self.norm2(tgt + ca)
        h = self.linear2(torch.relu(self.linear1(tgt)))
        return self.norm3(tgt + h)


class HGDecoder(nn.Module):
    """Untied stack ``layer_{i}`` run from a zero target."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 ffn_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = [f"layer_{i}" for i in range(num_layers)]
        for name in self.names:
            setattr(self, name, DecoderLayer(d_model, num_heads, ffn_dim,
                                             dtype))

    def forward(self, query_pos, memory, tgt_mask=None, memory_mask=None):
        """query_pos (B, Q, D) learned queries; memory (B, L, D)."""
        tgt = torch.zeros_like(query_pos)
        for name in self.names:
            tgt = getattr(self, name)(tgt, memory, query_pos, tgt_mask,
                                      memory_mask)
        return tgt

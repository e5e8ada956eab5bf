"""DETR-style hypergraph decoder: the port of ``shgvqa_tpu/models/decoder.py``
(post-norm; the scanned stack of ``--scanLayers`` runs as these layers, its
stacked parameters mapped by ``models/scan_stacks.py``).

Per layer: self-attention over the queries under the situation-causal
additive mask, cross-attention into the visual memory, ReLU FFN; residual +
LayerNorm(eps 1e-5) after each.  The learned queries are added to q/k at
every layer and the first target is zeros.  ``in_proj`` is torch's packed
[q; k; v] weight (xavier-uniform), applied slice by slice.

In training every site of the JAX layer drops at the decoder's rate: the
attention probabilities (through the fused kernels with ``kernel_train``,
as the JAX ``TorchMHA`` does), both attention outputs, the FFN after its
ReLU and its output.  Outside training ``kernel_eval`` (the JAX
``is_decoder_enabled()``, on with ``--pallasAttention``) runs the fused
forward kernel at rate 0, and ``headsliced`` (``set_headsliced_kernel``)
the head-sliced kernel on the projections as they are.

Tensor parallelism (``parallel/mesh.shard_model_``, ``tp`` = (model index,
mp)): ``TorchMHA`` projects this rank's H / mp heads of each of q, k and v
(its packed ``in_proj`` split head-aligned: rows ``part * D + m * D / mp``
.. of the (3D, D) weight and bias, where JAX cuts its 3D columns
contiguously) and ``out_proj`` runs over those rows (``layers.row_split``:
the reduce, then the bias); the layer's FFN runs ``linear1`` over columns,
its dropout on the one-process mask's columns, and ``linear2`` over rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.kernels.headsliced import headsliced_attention
from shgvqa_tpu_torch.models.layers import (
    Dense,
    Dropout,
    LayerNorm,
    attention_core,
    copy_to_model,
    kernels_allowed,
    row_split,
    tp_inputs,
)
from shgvqa_tpu_torch.models.remat import check_policy, remat_call


class TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention math: packed in_proj, f32 scores, additive
    f32 mask, dropout on the probabilities in training."""

    TP_SPLITS = {"in_proj.weight": (0, 3), "in_proj.bias": (0, 3),
                 "out_proj.weight": (1, 1)}
    TP_HEADS = True

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 kernel_train: bool = False):
        super().__init__()
        self.in_proj = Dense(d_model, 3 * d_model, dtype, init="xavier")
        self.out_proj = Dense(d_model, d_model, dtype)
        self.probs_dropout = Dropout(dropout)
        self.num_heads = num_heads
        self.dtype = dtype
        self.kernel_train = kernel_train
        self.kernel_eval = False
        self.headsliced = False
        self.tp = None

    def _project(self, x, part: int):
        n = self.in_proj.weight.shape[0] // 3
        dt = self.dtype
        w = self.in_proj.weight[part * n:(part + 1) * n].to(dt)
        b = self.in_proj.bias[part * n:(part + 1) * n].to(dt)
        return F.linear(x.to(dt), w, b)

    def _out(self, x):
        return self.out_proj(x) if self.tp is None else row_split(
            self.out_proj, x)

    def forward(self, query, key, value, attn_mask=None, g=None):
        b, lq, d = query.shape
        lk = key.shape[1]
        h = self.num_heads
        hd = d // h
        heads = None
        if self.tp is not None:
            index, count = self.tp
            h //= count
            heads = (index * h, self.num_heads)
            query, key, value = tp_inputs(query, key, value)
        q, k, v = (self._project(query, 0), self._project(key, 1),
                   self._project(value, 2))
        if self.headsliced and not self.training and kernels_allowed():
            return self._out(headsliced_attention(q, k, v, attn_mask, h))
        out = attention_core(q.view(b, lq, h, hd).transpose(1, 2),
                             k.view(b, lk, h, hd).transpose(1, 2),
                             v.view(b, lk, h, hd).transpose(1, 2), attn_mask,
                             self.dtype, self.probs_dropout,
                             self.kernel_train, g, self.kernel_eval,
                             heads=heads)
        return self._out(out.transpose(1, 2).reshape(b, lq, h * hd))


class LayerNormT(LayerNorm):
    """LayerNorm with torch's default eps 1e-5 (the decoder's norms)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, dtype=dtype)


class DecoderLayer(nn.Module):
    """Post-norm DETR decoder layer; split (``tp``), its FFN runs on
    ffn_dim / mp columns."""

    TP_SPLITS = {"linear1.weight": (0, 1), "linear1.bias": (0, 1),
                 "linear2.weight": (1, 1)}

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.15,
                 kernel_train: bool = False):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads, dtype, dropout,
                                  kernel_train)
        self.norm1 = LayerNormT(d_model, dtype)
        self.multihead_attn = TorchMHA(d_model, num_heads, dtype, dropout,
                                       kernel_train)
        self.norm2 = LayerNormT(d_model, dtype)
        self.linear1 = Dense(d_model, ffn_dim, dtype)
        self.linear2 = Dense(ffn_dim, d_model, dtype)
        self.norm3 = LayerNormT(d_model, dtype)
        self.dropout = Dropout(dropout)
        self.tp = None

    def forward(self, tgt, memory, query_pos, tgt_mask=None, memory_mask=None,
                g=None):
        drop = self.dropout
        q = tgt + query_pos
        sa = self.self_attn(q, q, tgt, tgt_mask, g)
        tgt = self.norm1(tgt + drop(sa, g))
        ca = self.multihead_attn(tgt + query_pos, memory, memory, memory_mask,
                                 g)
        tgt = self.norm2(tgt + drop(ca, g))
        if self.tp is None:
            h = self.linear2(drop(torch.relu(self.linear1(tgt)), g))
        else:
            index, count = self.tp
            h = torch.relu(self.linear1(copy_to_model(tgt)))
            n = h.shape[-1]
            h = row_split(self.linear2, drop(h, g, (-1, index * n, n * count)))
        return self.norm3(tgt + drop(h, g))


class HGDecoder(nn.Module):
    """Untied stack ``layer_{i}`` run from a zero target; under ``remat`` (a
    ``models/remat.py`` policy) each layer is rematerialized, scanned or not,
    as JAX's ``HGDecoder`` does."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 ffn_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.15, kernel_train: bool = False,
                 remat: Optional[str] = None):
        super().__init__()
        if remat is not None:
            check_policy(remat)
        self.remat = remat
        self.names = [f"layer_{i}" for i in range(num_layers)]
        for name in self.names:
            setattr(self, name, DecoderLayer(d_model, num_heads, ffn_dim,
                                             dtype, dropout, kernel_train))

    def forward(self, query_pos, memory, tgt_mask=None, memory_mask=None,
                g=None):
        """query_pos (B, Q, D) learned queries; memory (B, L, D)."""
        tgt = torch.zeros_like(query_pos)
        for name in self.names:
            tgt = remat_call(getattr(self, name), self.remat, tgt, memory,
                             query_pos, tgt_mask, memory_mask, g)
        return tgt

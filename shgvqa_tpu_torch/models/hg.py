"""Hypergraph query embeddings and the HG<->question cross encoder: the port
of ``shgvqa_tpu/models/hg.py``.

- ``HGEmbeddings``: the WHOLE (num_queries, D) table is the batch's learned
  queries, plus situation type embeddings, then LayerNorm(1e-12) and, in
  training, dropout.  Both tables zero row 0 at init (torch
  ``padding_idx=0``).  In GT-HG mode (``gt_hg``) given ``token_ids`` (the
  ground-truth labels) it embeds those instead; without them it takes the
  whole table as the JAX module does, whose (classes + 1) rows must then
  match the type ids' length (a ``TypeError`` otherwise, as JAX's).
- ``HGQCrossEncoder``: act/rel type tokens added per situation slot (act
  slots first), a CLS token prepended, the tied cross layer ``x_tied`` of
  ``cross_attn_type`` run ``x_layers`` times against the question (under
  'self' the joint stream carries the concatenated mask from the second
  step on), then ``Pooler2(hg, lang)`` under 'cross', else ``Pooler(hg)``.
  With an ``hg_mask`` (``--useHGMask``: 1 on the slots that hold a label),
  a 1 for the CLS token is prepended and it becomes the additive -10000
  key mask, in the compute dtype, of every attention over the hg tokens.
  With ``output_attentions`` it also returns each x-step's probabilities
  (the cross layer's dict), as the JAX encoder's list.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import EncoderConfig
from shgvqa_tpu_torch.models.cross import CROSS_LAYER_TYPES, _cat_masks
from shgvqa_tpu_torch.models.layers import (
    Dropout,
    Embed,
    LayerNorm,
    Pooler,
    Pooler2,
    empty_param,
    extend_mask,
)


class HGEmbeddings(nn.Module):
    def __init__(self, num_queries: int, hidden_size: int,
                 type_vocab_size: int = 16, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.word_embeddings = Embed(num_queries, hidden_size, dtype,
                                     zero_init_pad=True)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size, dtype,
                                           zero_init_pad=True)
        self.ln = LayerNorm(hidden_size, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, token_type_ids: torch.Tensor, g=None,
                token_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """token_type_ids (B, Q) situation indices -> (B, Q, D); with
        ``token_ids`` (B, Q) the rows of those ids (GT-HG mode)."""
        types = self.token_type_embeddings(token_type_ids)
        if token_ids is not None:
            words = self.word_embeddings(token_ids)
        else:
            words = self.word_embeddings()[None]
            if words.shape[1] != types.shape[1]:
                raise TypeError(
                    f"add got incompatible shapes for broadcasting: "
                    f"{(types.shape[0],) + tuple(words.shape[1:])}, "
                    f"{tuple(types.shape)}")
        x = self.ln(words + types)
        return self.dropout(x, g)


class HGQCrossEncoder(nn.Module):
    """The question cross-attended over the predicted hypergraph tokens."""

    def __init__(self, cfg: EncoderConfig, num_max_act: int = 3,
                 num_max_rel: int = 8, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, kernel_train: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.act_token = empty_param(1, 1, d)
        self.rel_token = empty_param(1, 1, d)
        self.cls_token = empty_param(1, 1, d)
        cat = cfg.cross_attn_type
        self.x_tied = CROSS_LAYER_TYPES[cat](
            d, cfg.num_heads, cfg.head_dim, cfg.intermediate_size, dtype,
            use_kernel, cfg.attention_dropout, cfg.hidden_dropout,
            kernel_train)
        self.pooler = Pooler2(d, dtype) if cat == "cross" else Pooler(d, dtype)
        self.joint = cat == "self"
        self.num_max_act = num_max_act
        self.num_max_rel = num_max_rel
        self.x_layers = cfg.x_layers
        self.dtype = dtype

    def init_params(self, g):
        self.act_token.zero_()
        self.rel_token.zero_()
        self.cls_token.zero_()

    def forward(self, lang_feats, lang_ext_mask, hg_feats, g=None,
                hg_mask=None, output_attentions: bool = False):
        """lang_feats (B, Lt, D); lang_ext_mask additive (B,1,1,Lt);
        hg_feats (B, S*(A+R), D); hg_mask {0,1} (B, S, A+R) or (B,
        S*(A+R)), or None.  Returns the pooled (B, D), and with
        ``output_attentions`` the list of each x-step's probabilities."""
        b, total, d = hg_feats.shape
        slots = self.num_max_act + self.num_max_rel
        type_tokens = torch.cat(
            [self.act_token.expand(1, self.num_max_act, d),
             self.rel_token.expand(1, self.num_max_rel, d)],
            dim=1).to(self.dtype)
        hg = (hg_feats.reshape(b, total // slots, slots, d)
              + type_tokens[None]).reshape(b, total, d)
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        hg = torch.cat([cls, hg], dim=1)
        hg_ext = None
        if hg_mask is not None:
            full = torch.cat([hg_mask.new_ones(b, 1),
                              hg_mask.reshape(b, -1)], dim=1)
            hg_ext = extend_mask(full, self.dtype)
        lang = lang_feats
        attn = []
        for step in range(self.x_layers):
            out = self.x_tied(lang, lang_ext_mask, hg, hg_ext, g, step,
                              output_attentions)
            lang, hg = out[:2]
            attn.extend(out[2:])
            if self.joint and step == 0:
                hg_ext = _cat_masks(hg_ext, lang_ext_mask,
                                    hg.shape[1] - lang.shape[1],
                                    lang.shape[1])
        pooled = (self.pooler(hg, lang) if isinstance(self.pooler, Pooler2)
                  else self.pooler(hg))
        return (pooled, attn) if output_attentions else pooled

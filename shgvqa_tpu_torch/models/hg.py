"""Hypergraph query embeddings and the HG<->question cross encoder: the port
of ``shgvqa_tpu/models/hg.py`` (GT-HG mode and ``--useHGMask`` are not
ported yet).

- ``HGEmbeddings``: the WHOLE (num_queries, D) table is the batch's learned
  queries, plus situation type embeddings, then LayerNorm(1e-12).  Both
  tables zero row 0 at init (torch ``padding_idx=0``).
- ``HGQCrossEncoder``: act/rel type tokens added per situation slot (act
  slots first), a CLS token prepended, the tied cross layer ``x_tied`` run
  ``x_layers`` times against the question, then ``Pooler2(hg, lang)``.
"""

from __future__ import annotations

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import EncoderConfig
from shgvqa_tpu_torch.models.cross import CrossLayer
from shgvqa_tpu_torch.models.layers import Embed, LayerNorm, Pooler2, empty_param


class HGEmbeddings(nn.Module):
    def __init__(self, num_queries: int, hidden_size: int,
                 type_vocab_size: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.word_embeddings = Embed(num_queries, hidden_size, dtype,
                                     zero_init_pad=True)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size, dtype,
                                           zero_init_pad=True)
        self.ln = LayerNorm(hidden_size, dtype=dtype)

    def forward(self, token_type_ids: torch.Tensor) -> torch.Tensor:
        """token_type_ids (B, Q) situation indices -> (B, Q, D)."""
        words = self.word_embeddings()[None]
        return self.ln(words + self.token_type_embeddings(token_type_ids))


class HGQCrossEncoder(nn.Module):
    """The question cross-attended over the predicted hypergraph tokens."""

    def __init__(self, cfg: EncoderConfig, num_max_act: int = 3,
                 num_max_rel: int = 8, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.act_token = empty_param(1, 1, d)
        self.rel_token = empty_param(1, 1, d)
        self.cls_token = empty_param(1, 1, d)
        self.x_tied = CrossLayer(d, cfg.num_heads, cfg.head_dim,
                                 cfg.intermediate_size, dtype, use_kernel)
        self.pooler = Pooler2(d, dtype)
        self.num_max_act = num_max_act
        self.num_max_rel = num_max_rel
        self.x_layers = cfg.x_layers
        self.dtype = dtype

    def init_params(self, g):
        self.act_token.zero_()
        self.rel_token.zero_()
        self.cls_token.zero_()

    def forward(self, lang_feats, lang_ext_mask, hg_feats):
        """lang_feats (B, Lt, D); lang_ext_mask additive (B,1,1,Lt);
        hg_feats (B, S*(A+R), D).  Returns the pooled (B, D)."""
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
        lang = lang_feats
        for _ in range(self.x_layers):
            lang, hg = self.x_tied(lang, lang_ext_mask, hg, None)
        return self.pooler(hg, lang)

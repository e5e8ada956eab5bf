"""Tri-stream LXMERT-style encoder: the port of ``TriStreamEncoder`` and
``LXRTModel`` in ``shgvqa_tpu/models/encoder.py`` (no-caps, unscanned path).

- ``l_{i}`` layers on text, ``r_{i}`` layers on the visual tokens, then the
  cross-modal layer ``x_tied``: ONE module called ``x_layers`` times, as the
  published model ties its cross layers.
- The hypergraph decoders read the PRE-cross snapshots, returned explicitly.
- Masks are additive -10000, built in the compute dtype by ``extend_mask``.
"""

from __future__ import annotations

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import EncoderConfig
from shgvqa_tpu_torch.models.cross import CrossLayer
from shgvqa_tpu_torch.models.layers import (
    BertEmbeddings,
    BertLayer,
    Pooler2,
    extend_mask,
)
from shgvqa_tpu_torch.models.visual import VisualTokenizer


class TriStreamEncoder(nn.Module):
    """l_layers on text, r_layers on visual tokens, x_layers cross-modal."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        c = cfg
        kw = dict(hidden_size=c.hidden_size, num_heads=c.num_heads,
                  head_dim=c.head_dim, intermediate_size=c.intermediate_size,
                  dtype=dtype, use_kernel=use_kernel)
        self.visual_tokenizer = VisualTokenizer(
            c.visual_feat_dim, c.hidden_size, c.visual_seq_length, dtype)
        self.l_names = [f"l_{i}" for i in range(c.l_layers)]
        self.r_names = [f"r_{i}" for i in range(c.r_layers)]
        for name in self.l_names + self.r_names:
            setattr(self, name, BertLayer(**kw))
        self.x_tied = CrossLayer(**kw)
        self.x_layers = c.x_layers

    def forward(self, lang_emb, lang_mask, visual_feats, visn_mask=None):
        """lang_emb (B, Lt, D); lang_mask additive (B,1,1,Lt) or None;
        visual_feats (B, T, H, W, C).  Returns (lang, visn, lang_snapshot,
        visn_snapshot)."""
        visn = self.visual_tokenizer(visual_feats)
        lang = lang_emb
        for name in self.l_names:
            lang = getattr(self, name)(lang, lang_mask)
        for name in self.r_names:
            visn = getattr(self, name)(visn, visn_mask)
        lang_snapshot, visn_snapshot = lang, visn
        for _ in range(self.x_layers):
            lang, visn = self.x_tied(lang, lang_mask, visn, visn_mask)
        return lang, visn, lang_snapshot, visn_snapshot


class LXRTModel(nn.Module):
    """Text + video encoder: embeddings -> tri-stream -> Pooler2(visn, lang)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        self.embeddings = BertEmbeddings(
            cfg.vocab_size, cfg.hidden_size, cfg.max_position_embeddings,
            cfg.type_vocab_size, dtype)
        self.encoder = TriStreamEncoder(cfg, dtype, use_kernel)
        self.pooler = Pooler2(cfg.hidden_size, dtype)
        self.dtype = dtype

    def forward(self, input_ids, input_mask, segment_ids, visual_feats,
                visual_mask=None):
        """visual_mask: {0,1} (B, Lv) over the visual tokens, or None.
        Returns (pooled, lang, visn, lang_snapshot, visn_snapshot,
        lang_ext_mask)."""
        lang_ext = extend_mask(input_mask, self.dtype)
        visn_ext = (extend_mask(visual_mask, self.dtype)
                    if visual_mask is not None else None)
        emb = self.embeddings(input_ids, segment_ids)
        lang, visn, lang_snap, visn_snap = self.encoder(
            emb, lang_ext, visual_feats, visn_ext)
        pooled = self.pooler(visn, lang)
        return pooled, lang, visn, lang_snap, visn_snap, lang_ext

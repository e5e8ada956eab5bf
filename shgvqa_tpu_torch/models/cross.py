"""Cross-modal layer: the port of ``CrossLayer`` in
``shgvqa_tpu/models/cross.py`` (--crossAttnType cross).  The 'self' and
'cross_self' variants are not ported yet (ROADMAP queue A item 15)."""

from __future__ import annotations

import torch
from torch import nn

from shgvqa_tpu_torch.models.layers import FFN, CrossAttLayer


class CrossLayer(nn.Module):
    """Bidirectional cross-attention with ONE shared attention block (it
    serves lang<-visn and visn<-lang), then per-stream FFNs."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 intermediate_size: int, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, attn_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, kernel_train: bool = False):
        super().__init__()
        self.visual_attention = CrossAttLayer(
            hidden_size, num_heads, head_dim, dtype, attn_dropout,
            hidden_dropout, kernel_train)
        self.lang_ffn = FFN(hidden_size, intermediate_size, dtype, use_kernel,
                            hidden_dropout)
        self.visn_ffn = FFN(hidden_size, intermediate_size, dtype, use_kernel,
                            hidden_dropout)

    def forward(self, lang, lang_mask, visn, visn_mask, g=None):
        lang_att = self.visual_attention(lang, visn, visn_mask, g)
        visn_att = self.visual_attention(visn, lang, lang_mask, g)
        return self.lang_ffn(lang_att, g), self.visn_ffn(visn_att, g)

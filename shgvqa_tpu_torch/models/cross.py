"""Cross-modal layer variants (--crossAttnType): the port of
``shgvqa_tpu/models/cross.py``.

- 'cross' (the published default) and 'old': ``CrossLayer``, bidirectional
  cross-attention through ONE shared attention block (it serves lang<-visn
  and visn<-lang), then per-stream FFNs;
- 'self': ``SelfCrossLayer``, joint self-attention over [visn; lang] and
  one FFN.  The first x-layer (``step`` 0) concatenates the streams; later
  layers receive the joint sequence as ``visn`` (the encoders concatenate
  the masks after step 0).  The language output is the joint output's last
  ``Lt`` tokens;
- 'cross_self': ``CrossAndSelfLayer``, the shared cross-attention, then
  joint self-attention over [visn; lang] and one FFN, split back into
  (lang, visn).

Every attention goes through the port's ``SelfAttLayer`` / ``CrossAttLayer``
and every FFN through ``FFN``, so the kernel switches reach every site.
Masks are ADDITIVE (already extended) or None.  With ``return_probs`` a
layer also returns its attention probabilities as the JAX layers key them:
``{"xl", "xv"}`` (lang<-visn, visn<-lang) for ``CrossLayer``, ``{"vl"}``
(the joint self-attention) for the other two."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from shgvqa_tpu_torch.models.layers import FFN, CrossAttLayer, SelfAttLayer


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

    def forward(self, lang, lang_mask, visn, visn_mask, g=None, step=0,
                return_probs: bool = False):
        if return_probs:
            lang_att, p_xl = self.visual_attention(lang, visn, visn_mask, g,
                                                   True)
            visn_att, p_xv = self.visual_attention(visn, lang, lang_mask, g,
                                                   True)
            return (self.lang_ffn(lang_att, g), self.visn_ffn(visn_att, g),
                    {"xl": p_xl, "xv": p_xv})
        lang_att = self.visual_attention(lang, visn, visn_mask, g)
        visn_att = self.visual_attention(visn, lang, lang_mask, g)
        return self.lang_ffn(lang_att, g), self.visn_ffn(visn_att, g)


class SelfCrossLayer(nn.Module):
    """Joint self-attention over concat([visn; lang]), one FFN."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 intermediate_size: int, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, attn_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, kernel_train: bool = False):
        super().__init__()
        self.cross_att = SelfAttLayer(hidden_size, num_heads, head_dim, dtype,
                                      attn_dropout, hidden_dropout,
                                      kernel_train)
        self.vl_ffn = FFN(hidden_size, intermediate_size, dtype, use_kernel,
                          hidden_dropout)

    def forward(self, lang, lang_mask, visn, visn_mask, g=None, step=0,
                return_probs: bool = False):
        if step == 0:
            joint = torch.cat([visn, lang], dim=1)
            joint_mask = _cat_masks(visn_mask, lang_mask, visn.shape[1],
                                    lang.shape[1])
        else:
            # later layers receive the already-joint sequence as `visn`
            joint, joint_mask = visn, visn_mask
        att = self.cross_att(joint, joint_mask, g, return_probs)
        if return_probs:
            att, probs = att
        out = self.vl_ffn(att, g)
        if return_probs:
            return out[:, -lang.shape[1]:], out, {"vl": probs}
        return out[:, -lang.shape[1]:], out


class CrossAndSelfLayer(nn.Module):
    """Shared cross-attention, then joint self-attention; splits the
    output back into (lang, visn)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 intermediate_size: int, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, attn_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, kernel_train: bool = False):
        super().__init__()
        self.visual_attention = CrossAttLayer(
            hidden_size, num_heads, head_dim, dtype, attn_dropout,
            hidden_dropout, kernel_train)
        self.self_att_layer = SelfAttLayer(
            hidden_size, num_heads, head_dim, dtype, attn_dropout,
            hidden_dropout, kernel_train)
        self.vl_ffn = FFN(hidden_size, intermediate_size, dtype, use_kernel,
                          hidden_dropout)

    def forward(self, lang, lang_mask, visn, visn_mask, g=None, step=0,
                return_probs: bool = False):
        lang_att = self.visual_attention(lang, visn, visn_mask, g)
        visn_att = self.visual_attention(visn, lang, lang_mask, g)
        joint = torch.cat([visn_att, lang_att], dim=1)
        joint_mask = _cat_masks(visn_mask, lang_mask, visn_att.shape[1],
                                lang_att.shape[1])
        att = self.self_att_layer(joint, joint_mask, g, return_probs)
        if return_probs:
            att, probs = att
        out = self.vl_ffn(att, g)
        visn_len = visn.shape[1]
        if return_probs:
            return out[:, visn_len:], out[:, :visn_len], {"vl": probs}
        return out[:, visn_len:], out[:, :visn_len]


def _cat_masks(visn_mask: Optional[torch.Tensor],
               lang_mask: Optional[torch.Tensor],
               visn_len: Optional[int] = None,
               lang_len: Optional[int] = None) -> Optional[torch.Tensor]:
    """Concatenate additive (B,1,1,L) masks along the key axis.  A None side
    means "attend to everything": it becomes zeros when the other side is
    masked (its length must then be given)."""
    if visn_mask is None and lang_mask is None:
        return None
    if visn_mask is None:
        assert visn_len is not None, "need visn_len to fill missing mask"
        visn_mask = lang_mask.new_zeros(lang_mask.shape[0], 1, 1, visn_len)
    if lang_mask is None:
        assert lang_len is not None, "need lang_len to fill missing mask"
        lang_mask = visn_mask.new_zeros(visn_mask.shape[0], 1, 1, lang_len)
    return torch.cat([visn_mask, lang_mask], dim=-1)


CROSS_LAYER_TYPES = {
    "cross": CrossLayer,
    "old": CrossLayer,
    "self": SelfCrossLayer,
    "cross_self": CrossAndSelfLayer,
}

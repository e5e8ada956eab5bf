"""Visual token embedder: the port of ``shgvqa_tpu/models/visual.py``.

Two Conv3d(5, 3, 3) + GeLU stages, valid in time and zero-padded by 1 in
space, turn (B, 16, 7, 7, 2048) trunk features into (B, 8, 7, 7, D); the
tokens are flattened in (t, h, w) order with channels last, a zero-init CLS
token is prepended, learned positions are added (393 tokens at the
published geometry) and, in training, dropout follows.  The public layout
is channels-last (B, T, H, W, C) as in the JAX package; the convs run on its
NCDHW view, which is ``channels_last_3d`` in memory, so no copy is made.

With ``use_kernel`` (``set_tok_kernel``; off by default, as the JAX package
has no such path) and not training, each conv + GeLU is one call of
``kernels.tok_conv``'s ``fused_tok_conv`` on the channels-last features
(forward only; its bias is added in f32 where the plain conv adds it in
the compute dtype).
"""

from __future__ import annotations

import torch
from torch import nn

from shgvqa_tpu_torch.data.featurize import uniform_subsample_indices
from shgvqa_tpu_torch.kernels.tok_conv import fused_tok_conv
from shgvqa_tpu_torch.models.layers import (
    BERT_STD,
    Conv3d,
    Dense,
    Dropout,
    empty_param,
    gelu,
)


def patchify_clip(frames: torch.Tensor, visual_t: int, hw: int
                  ) -> torch.Tensor:
    """(B, T, S, S, C) frames -> (B, visual_t, hw, hw, (S // hw)**2 * C):
    ``visual_t`` frames by ``uniform_subsample_indices``, each cut into
    hw x hw non-overlapping patches flattened as (row, column, channel)."""
    b, t, s, _, c = frames.shape
    if s % hw:
        raise ValueError(f"image size {s} not divisible by patch grid {hw}")
    p = s // hw
    idx = torch.as_tensor(uniform_subsample_indices(t, visual_t),
                          device=frames.device)
    x = frames.index_select(1, idx).reshape(b, visual_t, hw, p, hw, p, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, visual_t, hw, hw,
                                                  p * p * c)


class VisualTokenizer(nn.Module):
    def __init__(self, feat_dim: int, hidden_size: int, seq_length: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 patches: bool = False):
        super().__init__()
        if patches:
            self.linear_encoding = Dense(feat_dim, hidden_size, dtype)
        else:
            conv = lambda cin: Conv3d(  # noqa: E731
                cin, hidden_size, (5, 3, 3), padding=(0, 1, 1), dtype=dtype)
            self.conv1 = conv(feat_dim)
            self.conv2 = conv(hidden_size)
        self.patches = patches
        self.cls_token = empty_param(1, 1, hidden_size)
        self.pos_embedding = empty_param(seq_length, hidden_size)
        self.dropout = Dropout(dropout)
        self.dtype = dtype
        self.use_kernel = False

    def init_params(self, g):
        self.cls_token.zero_()
        self.pos_embedding.normal_(0.0, BERT_STD, generator=g)

    def forward(self, feats: torch.Tensor, g=None) -> torch.Tensor:
        """feats (B, T, H, W, C) -> (B, 1 + (T-8)*H*W, D) tokens; with
        ``patches``, patchified frames (B, t, hw, hw, 3072) -> (B, 1 +
        t*hw*hw, D)."""
        if self.patches:
            x = self.linear_encoding(feats)
        elif self.use_kernel and not self.training:
            x = feats.to(self.dtype)
            for conv in (self.conv1, self.conv2):
                x = fused_tok_conv(x, conv.weight, conv.bias)
        else:
            x = feats.permute(0, 4, 1, 2, 3)              # NCDHW view
            x = gelu(self.conv2(gelu(self.conv1(x))))
            x = x.permute(0, 2, 3, 4, 1)
        b, c = x.shape[0], x.shape[-1]
        tokens = x.reshape(b, -1, c)
        cls = self.cls_token.to(self.dtype).expand(b, 1, c)
        x = torch.cat([cls, tokens], dim=1)
        return self.dropout(x + self.pos_embedding.to(self.dtype)[None], g)


def set_tok_kernel(model: nn.Module, on: bool) -> None:
    """Route the visual tokenizer's two convs of ``model`` (outside
    training) through ``fused_tok_conv`` (on) or the plain Conv3d + GeLU
    (off).  A model without the conv tokenizer (the capsule or patch
    path) has nothing to route."""
    for m in model.modules():
        if isinstance(m, VisualTokenizer):
            m.use_kernel = on

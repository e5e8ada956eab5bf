"""Visual token embedder: the port of ``shgvqa_tpu/models/visual.py`` (conv
path; ``--patches`` is not ported yet).

Two Conv3d(5, 3, 3) + GeLU stages, valid in time and zero-padded by 1 in
space, turn (B, 16, 7, 7, 2048) trunk features into (B, 8, 7, 7, D); the
tokens are flattened in (t, h, w) order with channels last, a zero-init CLS
token is prepended and learned positions are added (393 tokens at the
published geometry).  The public layout is channels-last (B, T, H, W, C) as
in the JAX package; the convs run on its NCDHW view, which is
``channels_last_3d`` in memory, so no copy is made.
"""

from __future__ import annotations

import torch
from torch import nn

from shgvqa_tpu_torch.models.layers import BERT_STD, Conv3d, empty_param, gelu


class VisualTokenizer(nn.Module):
    def __init__(self, feat_dim: int, hidden_size: int, seq_length: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = lambda cin: Conv3d(cin, hidden_size, (5, 3, 3),  # noqa: E731
                                  padding=(0, 1, 1), dtype=dtype)
        self.conv1 = conv(feat_dim)
        self.conv2 = conv(hidden_size)
        self.cls_token = empty_param(1, 1, hidden_size)
        self.pos_embedding = empty_param(seq_length, hidden_size)
        self.dtype = dtype

    def init_params(self, g):
        self.cls_token.zero_()
        self.pos_embedding.normal_(0.0, BERT_STD, generator=g)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (B, T, H, W, C) -> (B, 1 + (T-8)*H*W, D) tokens."""
        x = feats.permute(0, 4, 1, 2, 3)                  # NCDHW view
        x = gelu(self.conv2(gelu(self.conv1(x))))
        b, c = x.shape[:2]
        tokens = x.permute(0, 2, 3, 4, 1).reshape(b, -1, c)
        cls = self.cls_token.to(self.dtype).expand(b, 1, c)
        x = torch.cat([cls, tokens], dim=1)
        return x + self.pos_embedding.to(self.dtype)[None]

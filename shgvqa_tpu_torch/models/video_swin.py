"""Video Swin-B trunk (``swin_base_patch244_window877``, registered as
``video_swin_impl``; plain 'video_swin' raises, as the reference does):
the port of ``shgvqa_tpu/models/video_swin.py``.  Module and parameter
names are the JAX ones, so ``convert.py`` maps the trees.

- patch embed: conv (2, 4, 4) / stride (2, 4, 4) to C = 128, LayerNorm
  (``patch_norm``);
- 4 stages, depths (2, 2, 18, 2), heads (4, 8, 16, 32); PatchMerging after
  stages 0-2: the 2x2 spatial concat in the order [0::2, 0::2], [1::2,
  0::2], [0::2, 1::2], [1::2, 1::2], LayerNorm, a bias-free Linear(4C, 2C);
- blocks: window attention (window (8, 7, 7), cyclic shift (4, 3, 3) on odd
  blocks, ``torch.roll``) with the 3-D relative-position bias table and
  the shifted windows' boundary masks (-100), then LN -> MLP (fc1 4x, exact
  GELU, fc2); pre-norm residuals;
- ``_adjust``: a dim no larger than the window takes window = dim and shift
  0 (the official ``get_window_size``);
- a final LayerNorm ``norm``.

The attention stays plain PyTorch (head width 32, a bias and window masks:
no kernel of the port takes it), scores in f32 as JAX's
``preferred_element_type``.  (B, T, H, W, 3) -> (B, T/2, H/32, W/32, 8C).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.configs.config import trunk_steps
from shgvqa_tpu_torch.models.backbone import Trunk, halve
from shgvqa_tpu_torch.models.layers import (
    Conv3d,
    Dense,
    LayerNorm,
    empty_param,
    gelu,
    trunc_normal_,
)


@functools.lru_cache(maxsize=None)
def _rel_pos_index(wt: int, wh: int, ww: int) -> np.ndarray:
    """(N, N) index into the (2wt-1)(2wh-1)(2ww-1) bias table (the official
    ``get_position_index``)."""
    coords = np.stack(np.meshgrid(
        np.arange(wt), np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]          # (3, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wt - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= (2 * ww - 1)
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_mask(tp: int, hp: int, wp: int, window: Tuple[int, int, int],
                shift: Tuple[int, int, int]) -> np.ndarray:
    """(nW, N, N) additive mask, -100 across the shifted windows' region
    boundaries (the official ``compute_mask``)."""
    img = np.zeros((tp, hp, wp))
    cnt = 0

    def parts(w, s):
        return ((slice(-w), slice(-w, -s), slice(-s, None)) if s
                else (slice(None),))

    for t in parts(window[0], shift[0]):
        for h in parts(window[1], shift[1]):
            for w in parts(window[2], shift[2]):
                img[t, h, w] = cnt
                cnt += 1
    wt, wh, ww = window
    win = img.reshape(tp // wt, wt, hp // wh, wh, wp // ww, ww)
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wt * wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _adjust(size, window, shift):
    """The official ``get_window_size``: a dim no larger than the window
    takes window = dim and shift 0."""
    w, s = list(window), list(shift)
    for i in range(3):
        if size[i] <= window[i]:
            w[i] = size[i]
            s[i] = 0
    return tuple(w), tuple(s)


class WindowAttention3D(nn.Module):
    """Window MSA with the 3-D relative-position bias.  The table is sized
    by the construction window; a clamped runtime window slices the full
    index's [:N, :N], as the official model does."""

    def __init__(self, dim: int, num_heads: int,
                 window: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        wt, wh, ww = window
        self.num_heads, self.window, self.dtype = num_heads, window, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.relative_position_bias_table = empty_param(
            (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads)
        self.proj = Dense(dim, dim, dtype)

    def init_params(self, g):
        trunc_normal_(self.relative_position_bias_table, 0.02, g)

    def forward(self, x, mask=None):
        """x (nB, N, C) windows; mask (nW, N, N) additive f32 or None."""
        nb, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(nb, n, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        idx = torch.as_tensor(_rel_pos_index(*self.window)[:n, :n],
                              device=x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)]
        bias = bias.reshape(n, n, h).permute(2, 0, 1).float()
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd) + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.reshape(nb // nw, nw, h, n, n)
                      + mask[None, :, None]).reshape(nb, h, n, n)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(nb, n, c)
        return self.proj(out)


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 window: Tuple[int, int, int] = (8, 7, 7),
                 shifted: bool = False, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.shifted = tuple(window), shifted
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.attn = WindowAttention3D(dim, num_heads, self.window, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x):
        b, t, hh, ww_, c = x.shape
        window, shift = _adjust(
            (t, hh, ww_), self.window,
            tuple(w // 2 for w in self.window) if self.shifted
            else (0, 0, 0))
        wt, wh, ww = window
        pt, ph, pw = (-t % wt), (-hh % wh), (-ww_ % ww)
        tp, hp, wp = t + pt, hh + ph, ww_ + pw

        h = self.norm1(x)
        if pt or ph or pw:
            h = F.pad(h, (0, 0, 0, pw, 0, ph, 0, pt))
        mask = None
        if any(shift):
            h = torch.roll(h, (-shift[0], -shift[1], -shift[2]), (1, 2, 3))
            mask = torch.as_tensor(_shift_mask(tp, hp, wp, window, shift),
                                   device=x.device)
        # window partition
        h = h.reshape(b, tp // wt, wt, hp // wh, wh, wp // ww, ww, c)
        h = h.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)
        h = self.attn(h, mask)
        # window reverse
        h = h.reshape(b, tp // wt, hp // wh, wp // ww, wt, wh, ww, c)
        h = h.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, tp, hp, wp, c)
        if any(shift):
            h = torch.roll(h, shift, (1, 2, 3))
        if pt or ph or pw:
            h = h[:, :t, :hh, :ww_]
        x = x + h
        m = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))
        return x + m


class VideoSwin(Trunk):
    """SwinTransformer3D trunk (swin_base_patch244_window877 dims); the
    width and depth overrides run the same topology at toy size in tests."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (4, 8, 16, 32),
                 window: Tuple[int, int, int] = (8, 7, 7)):
        super().__init__()
        self.dtype = dtype
        self.merges = len(depths) - 1
        self.patch_embed = Conv3d(3, embed_dim, (2, 4, 4), (2, 4, 4),
                                  bias=True, dtype=dtype, init="he_normal")
        self.patch_norm = LayerNorm(embed_dim, 1e-5, dtype)
        self.names = []
        c = embed_dim
        for i, depth in enumerate(depths):
            for j in range(depth):
                name = f"layer_{i}_block_{j}"
                setattr(self, name, SwinBlock3D(c, heads[i], window,
                                                j % 2 == 1, dtype=dtype))
                self.names.append(name)
            if i < self.merges:
                setattr(self, f"downsample_{i}_norm",
                        LayerNorm(4 * c, 1e-5, dtype))
                setattr(self, f"downsample_{i}_reduction",
                        Dense(4 * c, 2 * c, dtype, bias=False))
                self.names.append(f"downsample_{i}")
                c *= 2
        self.norm = LayerNorm(c, 1e-5, dtype)
        self.out_channels = c

    def spatial_out(self, size: int) -> int:
        """The patch embed's stride 4 (VALID), then each PatchMerging's
        2x2, rounding up."""
        return halve(size // 4, self.merges)

    @staticmethod
    def temporal_out(frames: int) -> int:
        """The patch embed's temporal stride 2 (``trunk_steps``)."""
        return trunk_steps("video_swin_impl", frames)

    def _merge(self, i: int, x):
        """PatchMerging: pad an odd side, the 2x2 concat, LN, reduction."""
        _, _, hh, ww, _ = x.shape
        if hh % 2 or ww % 2:
            x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        x = getattr(self, f"downsample_{i}_norm")(x)
        return getattr(self, f"downsample_{i}_reduction")(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalized frames -> (B, T/2, H/32, W/32, C)."""
        x = self.patch_embed(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        x = self.patch_norm(x.permute(0, 2, 3, 4, 1))
        for name in self.names:
            if name.startswith("downsample_"):
                x = self._merge(int(name.split("_")[1]), x)
            else:
                x = getattr(self, name)(x)
        return self.norm(x)

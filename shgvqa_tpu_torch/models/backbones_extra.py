"""ResNeXt-101 (per-frame 2-D) and SlowFast-R50/R101: the port of
``shgvqa_tpu/models/backbones_extra.py``.  Module and parameter names are
the JAX ones, so ``convert.py`` maps the trees.

- ``ResNeXt101`` (the reference's timm ``resnext101_32x8d`` run per frame):
  T folded into the batch, a 7x7/s2 stem, a 3x3/s2 max-pool, four stages of
  ``BottleneckX`` (1x1, grouped 3x3 with ``groups=32``, 1x1), then T
  restored: (B, T, H, W, 3) -> (B, T, H/32, W/32, 2048).  Its BatchNorm is
  ``FrozenBatchNorm`` on NCHW.
- ``SlowFastR50`` (pytorchvideo ``create_slowfast``, alpha 4, beta 1/8):
  the slow pathway takes every alpha-th frame; ``FuseFastToSlow`` (a
  (7, 1, 1) conv of stride (alpha, 1, 1), BN, ReLU, concatenated onto slow)
  runs after the stem and after stages 1-3; at the end slow is repeated
  alpha times along time and concatenated with fast:
  (B, T, H/32, W/32, 2048 + 256).  The stages are ``backbone.ResStage``
  blocks, so ``set_block_kernel`` reaches them: slow res_2 blocks 1-2 and
  res_3 blocks 1-3 fit the kernel (5 a forward); slow res_2 block 0 takes
  64 + 16 fused channels and every fast block has temporal kernel 3.

Both run with stored BatchNorm statistics, frozen or trained, as
``SlowR50`` does.  On the card ``entry.channels_last_convs`` makes
ResNeXt's 4-D weights ``channels_last`` and its frames are channels-last
NCHW views.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.models.backbone import (
    FrozenBatchNorm,
    ResStage,
    Trunk,
    _conv,
)
from shgvqa_tpu_torch.models.layers import Conv2d


def _conv2d(cin: int, cout: int, kernel, stride, dtype,
            groups: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, tuple(k // 2 for k in kernel),
                  bias=False, dtype=dtype, init="he_normal", groups=groups)


class BottleneckX(nn.Module):
    """ResNeXt bottleneck on NCHW frames: 1x1 -> grouped 3x3 (stride) ->
    1x1, each with frozen BN, and a projected residual when the width or
    the stride changes."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1,
                 groups: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv2d(cin, mid, (1, 1), (1, 1), dtype)
        self.bn1 = FrozenBatchNorm(mid, dtype=dtype)
        self.conv2 = _conv2d(mid, mid, (3, 3), (stride, stride), dtype,
                             groups=groups)
        self.bn2 = FrozenBatchNorm(mid, dtype=dtype)
        self.conv3 = _conv2d(mid, out, (1, 1), (1, 1), dtype)
        self.bn3 = FrozenBatchNorm(out, dtype=dtype)
        self.has_proj = cin != out or stride != 1
        if self.has_proj:
            self.downsample_conv = _conv2d(cin, out, (1, 1), (stride, stride),
                                           dtype)
            self.downsample_bn = FrozenBatchNorm(out, dtype=dtype)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_proj else x)
        return torch.relu(h + residual)


class ResNeXt101(Trunk):
    """ResNeXt-101 32x8d applied per frame; the width overrides run the
    same topology at toy size in tests."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 depths: Sequence[int] = (3, 4, 23, 3), groups: int = 32,
                 width_per_group: int = 8, stem_width: int = 64,
                 outs: Sequence[int] = (256, 512, 1024, 2048)):
        super().__init__()
        self.stem_conv = _conv2d(3, stem_width, (7, 7), (2, 2), dtype)
        self.stem_bn = FrozenBatchNorm(stem_width, dtype=dtype)
        self.names = []
        cin = stem_width
        for si in range(4):
            mid = groups * width_per_group * (2 ** si)
            for bi in range(depths[si]):
                name = f"layer{si + 1}_block{bi}"
                setattr(self, name, BottleneckX(
                    cin, mid, outs[si], 2 if (bi == 0 and si > 0) else 1,
                    groups, dtype))
                self.names.append(name)
                cin = outs[si]
        self.out_channels = cin
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalized frames -> (B, T, H/32, W/32, C)."""
        b, t, h, w, c = x.shape
        out = x.to(self.dtype).reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        out = torch.relu(self.stem_bn(self.stem_conv(out)))
        out = F.max_pool2d(out, 3, 2, 1)
        for name in self.names:
            out = getattr(self, name)(out)
        _, cc, hh, ww = out.shape
        return out.permute(0, 2, 3, 1).reshape(b, t, hh, ww, cc)


class SlowFastR50(Trunk):
    """Two-pathway SlowFast (module docstring); ``depths=(3, 4, 23, 3)`` is
    slowfast_r101.  Fast widths are the slow ones // ``beta_inv``."""

    def __init__(self, dtype: torch.dtype = torch.float32, alpha: int = 4,
                 beta_inv: int = 8, fusion_ratio: int = 2,
                 fusion_kernel: int = 7,
                 depths: Sequence[int] = (3, 4, 6, 3), stem_width: int = 64,
                 mids: Sequence[int] = (64, 128, 256, 512),
                 outs: Sequence[int] = (256, 512, 1024, 2048)):
        super().__init__()
        self.alpha = alpha
        self.dtype = dtype
        fast_w = stem_width // beta_inv
        self.slow_stem_conv = _conv(3, stem_width, (1, 7, 7), (1, 2, 2), dtype)
        self.slow_stem_bn = FrozenBatchNorm(stem_width, dtype=dtype)
        self.fast_stem_conv = _conv(3, fast_w, (5, 7, 7), (1, 2, 2), dtype)
        self.fast_stem_bn = FrozenBatchNorm(fast_w, dtype=dtype)
        fk = fusion_kernel

        def fuse(idx, fast_ch):
            out = fast_ch * fusion_ratio
            conv = _conv(fast_ch, out, (fk, 1, 1), (alpha, 1, 1), dtype)
            setattr(self, f"fuse_{idx}_conv", conv)
            setattr(self, f"fuse_{idx}_bn", FrozenBatchNorm(out, dtype=dtype))
            return out

        slow_c = stem_width + fuse(0, fast_w)
        fast_c = fast_w
        slow_tk = (1, 1, 3, 3)
        for i in range(4):
            stride = 1 if i == 0 else 2
            setattr(self, f"slow_res_{i + 2}", ResStage(
                slow_c, depths[i], mids[i], outs[i], slow_tk[i], stride,
                dtype))
            setattr(self, f"fast_res_{i + 2}", ResStage(
                fast_c, depths[i], mids[i] // beta_inv, outs[i] // beta_inv,
                3, stride, dtype))
            slow_c, fast_c = outs[i], outs[i] // beta_inv
            if i < 3:
                slow_c += fuse(i + 1, fast_c)
        self.out_channels = slow_c + fast_c

    def _fuse(self, idx: int, slow, fast):
        """FuseFastToSlow on NCDHW tensors: [slow, relu(bn(conv(fast)))]."""
        conv = getattr(self, f"fuse_{idx}_conv")
        lat = torch.relu(getattr(self, f"fuse_{idx}_bn")(conv(fast)))
        return torch.cat([slow, lat], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalized frames -> (B, T, H/32, W/32, C)."""
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)           # NCDHW view
        slow = torch.relu(self.slow_stem_bn(self.slow_stem_conv(
            x[:, :, ::self.alpha])))
        slow = F.max_pool3d(slow, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        fast = torch.relu(self.fast_stem_bn(self.fast_stem_conv(x)))
        fast = F.max_pool3d(fast, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        slow = self._fuse(0, slow, fast)
        for i in range(4):
            slow = getattr(self, f"slow_res_{i + 2}")(slow)
            fast = getattr(self, f"fast_res_{i + 2}")(fast)
            if i < 3:
                slow = self._fuse(i + 1, slow, fast)
        t = fast.shape[2]
        slow_up = slow.repeat_interleave(self.alpha, dim=2)[:, :, :t]
        return torch.cat([slow_up, fast], dim=1).permute(0, 2, 3, 4, 1)

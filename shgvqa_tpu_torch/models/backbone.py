"""slow_r50 video trunk: the port of ``SlowR50`` in
``shgvqa_tpu/models/backbone.py`` (bf16/f32 path; the int8 trunk and the
other backbones are not ported yet).

Slow-pathway 3D ResNet-50 with its head removed: stem conv (1,7,7)/s(1,2,2)
-> frozen BN -> ReLU -> max-pool (1,3,3)/s(1,2,2); four bottleneck stages,
depths (3,4,6,3), widths (256,512,1024,2048), temporal kernel 3 on conv_a
only in res_4/res_5, spatial stride 2 on conv_b and conv_proj of the first
block of res_3..res_5.  BatchNorm always uses its stored statistics.

The public layout is the JAX one, (B, T, H, W, C) in and out.  Inside, the
trunk runs on the NCDHW view of that tensor, which is ``channels_last_3d``
in memory; move the module with ``.to(memory_format=torch.channels_last_3d)``
on the card so cuDNN sees channels-last weights as well.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.models.layers import Conv3d, empty_param


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics: fold (inv, shift) in f32, cast to
    the compute dtype, apply to an NCDHW tensor."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = empty_param(features)
        self.bias = empty_param(features)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.dtype = dtype

    def init_params(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def fold(self):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self.fold()
        shape = (1, -1, 1, 1, 1)
        return (x * inv.to(self.dtype).view(shape)
                + shift.to(self.dtype).view(shape))


def _conv(cin: int, cout: int, kernel, stride, dtype) -> Conv3d:
    return Conv3d(cin, cout, kernel, stride, tuple(k // 2 for k in kernel),
                  bias=False, dtype=dtype, init="he_normal")


class Bottleneck3D(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, temporal_kernel: int = 1,
                 spatial_stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        ss = spatial_stride
        self.conv_a = _conv(cin, mid, (temporal_kernel, 1, 1), (1, 1, 1), dtype)
        self.bn_a = FrozenBatchNorm(mid, dtype=dtype)
        self.conv_b = _conv(mid, mid, (1, 3, 3), (1, ss, ss), dtype)
        self.bn_b = FrozenBatchNorm(mid, dtype=dtype)
        self.conv_c = _conv(mid, out, (1, 1, 1), (1, 1, 1), dtype)
        self.bn_c = FrozenBatchNorm(out, dtype=dtype)
        self.has_proj = cin != out or ss != 1
        if self.has_proj:
            self.conv_proj = _conv(cin, out, (1, 1, 1), (1, ss, ss), dtype)
            self.bn_proj = FrozenBatchNorm(out, dtype=dtype)

    def forward(self, x):
        h = torch.relu(self.bn_a(self.conv_a(x)))
        h = torch.relu(self.bn_b(self.conv_b(h)))
        h = self.bn_c(self.conv_c(h))
        residual = self.bn_proj(self.conv_proj(x)) if self.has_proj else x
        return torch.relu(h + residual)


class ResStage(nn.Module):
    def __init__(self, cin: int, depth: int, mid: int, out: int,
                 temporal_kernel: int, spatial_stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = [f"block_{i}" for i in range(depth)]
        for i, name in enumerate(self.names):
            setattr(self, name, Bottleneck3D(
                cin if i == 0 else out, mid, out, temporal_kernel,
                spatial_stride if i == 0 else 1, dtype))

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class SlowR50(nn.Module):
    """Slow-pathway 3D ResNet-50 feature extractor (head removed).  The width
    overrides run the same topology at toy size in tests."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 depths: Sequence[int] = (3, 4, 6, 3),
                 temporal_kernels: Sequence[int] = (1, 1, 3, 3),
                 stem_width: int = 64,
                 mids: Sequence[int] = (64, 128, 256, 512),
                 outs: Sequence[int] = (256, 512, 1024, 2048)):
        super().__init__()
        self.stem_conv = _conv(3, stem_width, (1, 7, 7), (1, 2, 2), dtype)
        self.stem_bn = FrozenBatchNorm(stem_width, dtype=dtype)
        cin = stem_width
        for i in range(4):
            setattr(self, f"res_{i + 2}", ResStage(
                cin, depths[i], mids[i], outs[i], temporal_kernels[i],
                1 if i == 0 else 2, dtype))
            cin = outs[i]
        self.out_channels = cin
        self.dtype = dtype

    @staticmethod
    def spatial_out(size: int) -> int:
        """Feature-map side for frames of side ``size``: the stem conv, the
        max-pool and three stride-2 stages each halve it, rounding up."""
        for _ in range(5):
            size = (size + 1) // 2
        return size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalized frames -> (B, T, H/32, W/32, C)."""
        h = x.to(self.dtype).permute(0, 4, 1, 2, 3)         # NCDHW view
        h = torch.relu(self.stem_bn(self.stem_conv(h)))
        h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for i in range(4):
            h = getattr(self, f"res_{i + 2}")(h)
        return h.permute(0, 2, 3, 4, 1)


def make_backbone(name: str, dtype: torch.dtype = torch.float32) -> SlowR50:
    """Backbone registry; only slow_r50 (every published recipe) is ported."""
    if name != "slow_r50":
        raise NotImplementedError(
            f"backbone '{name}' is not ported yet (ROADMAP queue A item 17); "
            "the port has slow_r50")
    return SlowR50(dtype=dtype)

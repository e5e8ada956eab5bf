"""Video trunks: the port of ``shgvqa_tpu/models/backbone.py``: ``SlowR50``
(the bf16/f32 path and the int8 frozen trunk, ``--quantBackbone int8``),
the trunk interface every trunk has, and the registry ``make_backbone``
over every trunk of the JAX ``BACKBONES`` (``models/backbones_extra.py``:
resnext101, slowfast_r50/r101; ``models/mvit.py``: mvit_B;
``models/video_swin.py``: video_swin_impl).

The trunk interface (``Trunk``): ``out_channels`` (the tokenizer's input
width), ``spatial_out(image_size)`` (the feature map's side),
``temporal_out(frames)`` (the feature map's steps: mvit_B and
video_swin_impl halve time), and the int8 flags ``quant`` and
``calibrated`` (only slow_r50 has an int8 path).

Slow-pathway 3D ResNet-50 with its head removed: stem conv (1,7,7)/s(1,2,2)
-> frozen BN -> ReLU -> max-pool (1,3,3)/s(1,2,2); four bottleneck stages,
depths (3,4,6,3), widths (256,512,1024,2048), temporal kernel 3 on conv_a
only in res_4/res_5, spatial stride 2 on conv_b and conv_proj of the first
block of res_3..res_5.  BatchNorm always uses its stored statistics.

The public layout is the JAX one, (B, T, H, W, C) in and out.  Inside, the
trunk runs on the NCDHW view of that tensor, which is ``channels_last_3d``
in memory; move the module with ``.to(memory_format=torch.channels_last_3d)``
on the card so cuDNN sees channels-last weights as well.

The trunk trains (``freeze_backbone`` off, the published AGQA recipe) or
is frozen (under ``torch.no_grad()`` in the model).  Either way its
BatchNorm uses the stored statistics: ``weight`` and ``bias`` are
parameters that train with the convs, ``running_mean`` and
``running_var`` are buffers that nothing but ``calibrate_frozen_bn``
writes.

A block of stride 1 and temporal kernel 1 whose widths the kernel takes
(``kernels.bottleneck.takes``: Cm 64 or 128, Ci a multiple of 64, Co of
128; slow_r50's res_2 blocks 0-2 and res_3 blocks 1-3, 6 of the 16;
slowfast's slow res_2 blocks 1-2 and res_3 blocks 1-3, 5, as its res_2
block 0 takes 64 + 16 fused channels) runs as one call of
``kernels.bottleneck``'s ``fused_bottleneck`` on its frames when its
``use_kernel`` is set (``set_block_kernel``; off by default, as the JAX
package has no such path) and no gradient is required: autograd off, or
neither the block's input nor its parameters require one.  On the CPU the
plain version takes any widths, so there the widths do not decide.  The
kernel is forward only (the JAX ``_make_block`` has no backward), so a
block in a trained trunk runs on the convs; so do the other blocks always.

The int8 trunk (``SlowR50(quant=True)``, the JAX ``quant`` path): the stem
stays in the compute dtype and is quantized after its ReLU with the static
scale ``s_stem`` (then the int8 max-pool, ``kernels.qconv.max_pool_i8``);
every block takes ``(x_q, s_in)`` and returns ``(y_q, s_out)``, its four
convs on ``kernels.qconv.qconv`` (weights quantized per output channel on
the device every call, BN folded into the dequantize, ReLU, the residual
and the requantize in the epilogue; 3 + 1 launches a block, 52 a
forward); the last output is dequantized to the compute dtype.  The scales
``s_stem`` and each block's ``s_a``, ``s_b``, ``s_out`` are f32 scalar
buffers on the device that nothing reads on the host.  ``calibrate_quant``
sets them, as a JAX apply with ``mutable=["quant_stats"]`` does: the
full-precision forward of the plain path, each scale ``max(old,
amax(|t|).float() / 127)``.  A quantized forward before any calibration or
load of scales raises; the check is the host flag ``calibrated``, which
calibration and ``load_state_dict`` set (on a state dict without the
scales, a load zeroes them and clears the flag).  A trunk without ``quant``
drops scales it is given, so a checkpoint crosses the flag both ways.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.convert import QUANT_STATS, is_quant_scale
from shgvqa_tpu_torch.kernels.bottleneck import fused_bottleneck, takes
from shgvqa_tpu_torch.kernels.qconv import (
    EPS,
    _div,
    max_pool_i8,
    qconv,
    quant_sym,
)
from shgvqa_tpu_torch.models.layers import Conv3d, empty_param


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics: fold (inv, shift) in f32, cast to
    the compute dtype, apply to an NCDHW tensor.  ``weight`` and ``bias``
    take gradients; the statistics are buffers and never change here."""

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
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * inv.to(self.dtype).view(shape)
                + shift.to(self.dtype).view(shape))


def _conv(cin: int, cout: int, kernel, stride, dtype) -> Conv3d:
    return Conv3d(cin, cout, kernel, stride, tuple(k // 2 for k in kernel),
                  bias=False, dtype=dtype, init="he_normal")


def _observe(scale: torch.Tensor, t: torch.Tensor) -> None:
    """Calibration: scale <- max(scale, amax(|t|) in t's dtype, as f32,
    / 127)."""
    scale.copy_(torch.maximum(scale, _div(t.abs().amax().float(), 127.0)))


class Bottleneck3D(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, temporal_kernel: int = 1,
                 spatial_stride: int = 1, dtype: torch.dtype = torch.float32,
                 quant: bool = False):
        super().__init__()
        ss = spatial_stride
        self.temporal_kernel, self.spatial_stride = temporal_kernel, ss
        self.use_kernel = False
        self.observing = False
        self.conv_a = _conv(cin, mid, (temporal_kernel, 1, 1), (1, 1, 1), dtype)
        self.bn_a = FrozenBatchNorm(mid, dtype=dtype)
        self.conv_b = _conv(mid, mid, (1, 3, 3), (1, ss, ss), dtype)
        self.bn_b = FrozenBatchNorm(mid, dtype=dtype)
        self.conv_c = _conv(mid, out, (1, 1, 1), (1, 1, 1), dtype)
        self.bn_c = FrozenBatchNorm(out, dtype=dtype)
        self.has_proj = cin != out or ss != 1
        # the kernel's own limits on the block's widths (on the card)
        self.fits_kernel = (temporal_kernel == 1 and ss == 1
                            and takes(cin, mid, out))
        if self.has_proj:
            self.conv_proj = _conv(cin, out, (1, 1, 1), (1, ss, ss), dtype)
            self.bn_proj = FrozenBatchNorm(out, dtype=dtype)
        if quant:
            for name in QUANT_STATS[1:]:
                self.register_buffer(name, torch.zeros(()))

    def forward(self, x):
        """The plain path on NCDHW x; while ``observing``, it records the
        int8 scales on the way."""
        if (self.use_kernel and not self.observing
                and self.temporal_kernel == 1 and self.spatial_stride == 1
                and (self.fits_kernel or x.device.type == "cpu")
                and not self._needs_grad(x)):
            return self._fused(x)
        h = torch.relu(self.bn_a(self.conv_a(x)))
        if self.observing:
            _observe(self.s_a, h)
        h = torch.relu(self.bn_b(self.conv_b(h)))
        if self.observing:
            _observe(self.s_b, h)
        h = self.bn_c(self.conv_c(h))
        residual = self.bn_proj(self.conv_proj(x)) if self.has_proj else x
        y = torch.relu(h + residual)
        if self.observing:
            _observe(self.s_out, y)
        return y

    def quant_forward(self, x_q, s_in):
        """The int8 path: x_q (B, T, H, W, Ci) int8 with its scale s_in ->
        (y_q (B, T, Ho, Wo, Co) int8, s_out), four ``qconv`` launches with
        a projection, three without."""
        dt, ss = self.conv_a.dtype, self.spatial_stride
        a_q = qconv(x_q, s_in, self.conv_a.weight, *self.bn_a.fold(), 1,
                    self.s_a, dtype=dt)
        b_q = qconv(a_q, self.s_a, self.conv_b.weight, *self.bn_b.fold(), ss,
                    self.s_b, dtype=dt)
        if self.has_proj:
            r = qconv(x_q, s_in, self.conv_proj.weight, *self.bn_proj.fold(),
                      ss, dtype=dt)
            y_q = qconv(b_q, self.s_b, self.conv_c.weight, *self.bn_c.fold(),
                        1, self.s_out, residual=r, dtype=dt)
        else:
            y_q = qconv(b_q, self.s_b, self.conv_c.weight, *self.bn_c.fold(),
                        1, self.s_out, residual=x_q, s_res=s_in, dtype=dt)
        return y_q, self.s_out

    def _needs_grad(self, x) -> bool:
        """Whether this forward must record a graph, which the fused kernel
        cannot."""
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def kernel_operands(self):
        """What ``fused_bottleneck`` takes after the frames: the conv
        weights in the compute dtype without their unit dimensions and the
        folded BN (scale, shift) pairs cast to it, as ``FrozenBatchNorm``
        applies them; the projection as (weight, scale, shift) or None."""
        dt = self.conv_a.dtype
        mid, cin = self.conv_a.weight.shape[:2]
        out = self.conv_c.weight.shape[0]

        def folded(bn):
            inv, shift = bn.fold()
            return inv.to(dt), shift.to(dt)

        proj = None
        if self.has_proj:
            proj = (self.conv_proj.weight.to(dt).reshape(out, cin),
                    *folded(self.bn_proj))
        return (self.conv_a.weight.to(dt).reshape(mid, cin),
                *folded(self.bn_a), self.conv_b.weight.to(dt)[:, :, 0],
                *folded(self.bn_b), self.conv_c.weight.to(dt).reshape(out, mid),
                *folded(self.bn_c), proj)

    def _fused(self, x):
        """x (B, C, T, H, W) -> ``fused_bottleneck`` on its (B*T, H, W, C)
        frames (a view when x is channels-last in memory) -> back."""
        b, c, t, h, w = x.shape
        frames = x.to(self.conv_a.dtype).permute(0, 2, 3, 4, 1)
        y = fused_bottleneck(frames.reshape(b * t, h, w, c),
                             *self.kernel_operands())
        return y.reshape(b, t, h, w, -1).permute(0, 4, 1, 2, 3)


def set_block_kernel(model: nn.Module, on: bool) -> None:
    """Route every bottleneck block of ``model``'s trunk that the fused
    kernel covers (stride 1, temporal kernel 1, widths it takes) through
    ``fused_bottleneck`` (on) or the convs (off)."""
    for m in model.modules():
        if isinstance(m, Bottleneck3D):
            m.use_kernel = on


class ResStage(nn.Module):
    def __init__(self, cin: int, depth: int, mid: int, out: int,
                 temporal_kernel: int, spatial_stride: int,
                 dtype: torch.dtype = torch.float32, quant: bool = False):
        super().__init__()
        self.names = [f"block_{i}" for i in range(depth)]
        for i, name in enumerate(self.names):
            setattr(self, name, Bottleneck3D(
                cin if i == 0 else out, mid, out, temporal_kernel,
                spatial_stride if i == 0 else 1, dtype, quant))

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x

    def quant_forward(self, x_q, s):
        for name in self.names:
            x_q, s = getattr(self, name).quant_forward(x_q, s)
        return x_q, s


def halve(size: int, times: int) -> int:
    """``size`` halved ``times`` times, rounding up (a stride-2 conv or
    pool with padding k // 2)."""
    for _ in range(times):
        size = (size + 1) // 2
    return size


class Trunk(nn.Module):
    """What the model reads of a trunk (module docstring).  The defaults
    are the 3-D ResNets': five halvings of the side (the stem conv, the
    max-pool and three stride-2 stages) and every frame kept.  Only
    slow_r50 has an int8 path."""

    quant = False
    calibrated = False
    out_channels: int

    @staticmethod
    def spatial_out(size: int) -> int:
        return halve(size, 5)

    @staticmethod
    def temporal_out(frames: int) -> int:
        return frames


class SlowR50(Trunk):
    """Slow-pathway 3D ResNet-50 feature extractor (head removed).  The width
    overrides run the same topology at toy size in tests; ``quant`` selects
    the int8 frozen trunk (module docstring)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 depths: Sequence[int] = (3, 4, 6, 3),
                 temporal_kernels: Sequence[int] = (1, 1, 3, 3),
                 stem_width: int = 64,
                 mids: Sequence[int] = (64, 128, 256, 512),
                 outs: Sequence[int] = (256, 512, 1024, 2048),
                 quant: bool = False):
        super().__init__()
        self.stem_conv = _conv(3, stem_width, (1, 7, 7), (1, 2, 2), dtype)
        self.stem_bn = FrozenBatchNorm(stem_width, dtype=dtype)
        cin = stem_width
        for i in range(4):
            setattr(self, f"res_{i + 2}", ResStage(
                cin, depths[i], mids[i], outs[i], temporal_kernels[i],
                1 if i == 0 else 2, dtype, quant))
            cin = outs[i]
        self.out_channels = cin
        self.dtype = dtype
        self.quant = quant
        self.calibrated = False
        self.plain = False             # the plain path even when int8
        self.observing = False
        if quant:
            self.register_buffer("s_stem", torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalized frames -> (B, T, H/32, W/32, C)."""
        h = x.to(self.dtype).permute(0, 4, 1, 2, 3)         # NCDHW view
        h = torch.relu(self.stem_bn(self.stem_conv(h)))
        stages = [getattr(self, f"res_{i + 2}") for i in range(4)]
        if self.quant and not self.plain:
            if not self.calibrated:
                raise RuntimeError(
                    "the int8 trunk (--quantBackbone int8) has no scales: "
                    "calibrate it (models.backbone.calibrate_quant) or load "
                    "a state dict that carries them first")
            h_q = quant_sym(h, self.s_stem).permute(0, 2, 3, 4, 1)
            h_q = max_pool_i8(h_q)
            s = self.s_stem
            for stage in stages:
                h_q, s = stage.quant_forward(h_q, s)
            return h_q.to(self.dtype) * s.clamp_min(EPS).to(self.dtype)
        if self.observing:
            _observe(self.s_stem, h)
        h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for stage in stages:
            h = stage(h)
        return h.permute(0, 2, 3, 4, 1)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        """Before the trunk's own tensors load: take its scales out of a
        state dict that a trunk without ``quant`` is given; for an int8
        trunk, a state dict with every scale sets ``calibrated``, one
        without any gets zeros and clears it, one with some raises."""
        scales = [k for k in state_dict
                  if k.startswith(prefix) and is_quant_scale(k)]
        if not self.quant:
            for k in scales:
                del state_dict[k]
        else:
            want = [prefix + name for name, _ in self.named_buffers()
                    if is_quant_scale(name)]
            if scales and sorted(scales) != sorted(want):
                raise KeyError(f"the int8 trunk's scales are incomplete: "
                               f"missing {sorted(set(want) - set(scales))}, "
                               f"unknown {sorted(set(scales) - set(want))}")
            if not scales:
                for k in want:
                    state_dict[k] = torch.zeros(())
            self.calibrated = bool(scales)
        super()._load_from_state_dict(state_dict, prefix, *args)


@contextlib.contextmanager
def plain_trunk(trunk: Trunk, observe: bool = False):
    """Run ``trunk``'s plain path: the int8 trunk's float path, and every
    bottleneck block on its convs; with ``observe`` the int8 scales are
    recorded on the way."""
    observers = [m for m in trunk.modules()
                 if isinstance(m, (SlowR50, Bottleneck3D))]
    trunk.plain = True
    for m in observers:
        m.observing = observe
    try:
        yield
    finally:
        trunk.plain = False
        for m in observers:
            m.observing = False


@torch.no_grad()
def calibrate_frozen_bn(trunk: Trunk, x: torch.Tensor) -> None:
    """Set the statistics of every ``FrozenBatchNorm`` of ``trunk`` to the
    per-channel mean and variance of its input on ``x`` (normalized frames),
    layer after layer in one forward of the plain path, so that each
    normalizes its activations as a pretrained trunk's do.  With random
    weights the init's identity statistics (0, 1) let the activations grow
    about 1e4-fold through slow_r50's 16 blocks, and every softmax
    downstream saturates.  A trunk without BatchNorm (mvit_B,
    video_swin_impl) is left as it is."""

    def set_stats(bn, args):
        h = args[0].float()
        dims = [d for d in range(h.dim()) if d != 1]
        bn.running_mean.copy_(h.mean(dims))
        bn.running_var.copy_(h.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(set_stats)
               for m in trunk.modules() if isinstance(m, FrozenBatchNorm)]
    if not handles:
        return
    try:
        with plain_trunk(trunk):
            trunk(x)
    finally:
        for h in handles:
            h.remove()


@torch.no_grad()
def calibrate_quant(trunk: SlowR50, x: torch.Tensor) -> None:
    """Record the int8 trunk's scales on ``x`` (normalized frames): the
    full-precision forward of the plain path, each scale ``max(old,
    amax(|t|).float() / 127)`` (the JAX apply with
    ``mutable=["quant_stats"]``; the scales start at 0), then set
    ``calibrated``."""
    if not trunk.quant:
        raise ValueError("calibrate_quant needs the int8 trunk (quant=True)")
    with plain_trunk(trunk, observe=True):
        trunk(x)
    trunk.calibrated = True


def _slowfast(depths):
    def make(dtype):
        from shgvqa_tpu_torch.models.backbones_extra import SlowFastR50

        return SlowFastR50(dtype, depths=depths)
    return make


def _resnext(dtype):
    from shgvqa_tpu_torch.models.backbones_extra import ResNeXt101

    return ResNeXt101(dtype)


def _mvit(dtype, frames: int = 32, image_size: int = 224):
    from shgvqa_tpu_torch.models.mvit import MViTB

    return MViTB(dtype, frames=frames, image_size=image_size)


def _video_swin(dtype):
    from shgvqa_tpu_torch.models.video_swin import VideoSwin

    return VideoSwin(dtype)


BACKBONES = {
    "slow_r50": lambda dtype, quant=False: SlowR50(dtype=dtype, quant=quant),
    "resnext101": _resnext,
    "slowfast_r50": _slowfast((3, 4, 6, 3)),
    "slowfast_r101": _slowfast((3, 4, 23, 3)),
    "mvit_B": _mvit,
    # the reference's 'video_swin' raises; the implemented Swin-B trunk
    # registers under an _impl suffix, as in the JAX package
    "video_swin_impl": _video_swin,
}

# trunks whose parameters depend on the clip's geometry (MViT's positional
# embeddings): the model passes them ``frames`` and ``image_size``
GEOMETRY_TRUNKS = ("mvit_B",)


def make_backbone(name: str, dtype: torch.dtype = torch.float32,
                  quant: str = "", **geometry) -> Trunk:
    """Backbone registry (the JAX ``make_backbone``): slow_r50 (every
    published recipe), resnext101 (per-frame 2-D), slowfast_r50/r101
    (two-pathway), mvit_B (multiscale ViT; ``frames`` and ``image_size``
    size its positional embeddings), video_swin_impl (Video Swin-B).
    'video_swin' raises NotImplementedError as the reference does.
    ``quant='int8'`` selects the int8 frozen trunk (slow_r50 only, as in
    the JAX package)."""
    if name not in BACKBONES:
        raise NotImplementedError(
            f"backbone '{name}' not implemented; available: "
            f"{sorted(BACKBONES)}"
            + (" ('video_swin_impl' provides the implemented Swin trunk)"
               if name == "video_swin" else ""))
    if quant:
        if quant != "int8":
            raise ValueError(f"unknown quant mode '{quant}' (use 'int8')")
        if name != "slow_r50":
            raise NotImplementedError(
                "--quantBackbone int8 is implemented for slow_r50 (the "
                f"flagship trunk); got backbone '{name}'")
        return BACKBONES[name](dtype, quant=True)
    return BACKBONES[name](dtype, **geometry)

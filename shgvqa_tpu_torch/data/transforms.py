"""Clip normalization and batched RandAugment / AugMix on the device: the
port of ``shgvqa_tpu/data/transforms.py`` (``NORM_STATS``,
``normalize_clip``, the RandAugment ops, ``op_equalize_batch``,
``rand_augment_batch`` and ``aug_mix_batch``).

Every op takes a batch of clips (B, T, H, W, C) in [0, 1] in the frames'
dtype and a per-clip level ``v`` (B,) in that dtype, and computes what the
JAX op computes on each clip:
- the photometric ops (``_blend``, ``_gray``, autocontrast, contrast, color,
  posterize, solarize, brightness, sharpness) and the 256-bin histogram
  equalize, whose histogram may be taken on every ``stride``-th row;
- the geometric ops as 1-D row shears (``_row_shear``): shear and translate
  one pass each, rotate the Paeth three-shear composition
  (``_geo_passes``), zero fill.

RandAugment: two layers a clip, magnitude 9/31, each applied with
probability 0.5; one (op, apply, sign) draw a clip and layer, shared by its
frames.  The draws come from an explicit ``torch.Generator`` on the frames'
device (op uniform over the 14, apply with ``prob``, sign +-1; AugMix's
Dirichlet and Beta weights from the same generator).  The two packages'
random streams differ, so the port is held to JAX at fixed draws.

``apply_layer_batch`` runs one layer over the batch, on one of three paths
(``AUG_PATHS``) that give the same bits in the same (contiguous) layout:
each op computes every clip alone (the means in f64, the histograms as
integer counts, the blur in f32 element by element).
- ``"select"``, the select tree: every op on the whole batch, a select
  picks each clip's result.  No host read, static shapes.
- ``"subbatch"``, the sub-batch path (the default): each op class runs
  only on the clips that drew it, gathered by index and copied back; the
  geometry runs as its three passes, each on the clips that need it.  That
  needs the drawn ops on the host: one host sync a ``rand_augment_batch``
  or ``aug_mix_batch`` call (the index copies to the device go through
  pinned memory and do not wait), and shapes that change from call to call.
- ``"capacity"``, the fixed-capacity path, the JAX gathered path: each
  heavy class (autocontrast, contrast, equalize,
  sharpness and the three shear passes) runs on ``_class_cap`` rows, the
  clips that drew it first (a stable argsort on the device) and others
  after them, whose results are not kept; the elementwise ops stay on the
  select tree.  When a class drew more clips than its capacity, the layer
  takes the select tree instead: ``kernels/cond.branch``, which a CUDA
  graph of the train step (``--stepsPerLoop``, ``train/graph.py``) captures
  as conditional nodes.  No host read, static shapes, and the work of the
  sub-batch path plus the padding rows.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from shgvqa_tpu_torch.kernels import cond

NORM_STATS: Dict[str, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {
    "slow_r50": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "slowfast_r50": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "slowfast_r101": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "resnext101": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "mvit_B": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "video_swin_impl": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}

# the augmentation types that augment in training
AUGMENT_TYPES = ("rand_aug", "rand_aug_slowfast", "aug_mix")


def normalize_clip(frames01: torch.Tensor, mean, std) -> torch.Tensor:
    """(..., 3) frames in [0, 1] -> (x - mean) / std over the channel axis,
    in the frames' dtype."""
    mean, std = (_stats(tuple(v), frames01.dtype, frames01.device)
                 for v in (mean, std))
    return (frames01 - mean) / std


@functools.lru_cache(maxsize=None)
def _stats(values: Tuple[float, ...], dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once per device and dtype:
    a copy enqueued from temporary pinned memory on every call would, in a
    captured CUDA graph, read that memory again at each replay after it was
    freed."""
    return _to_device(torch.tensor(values, dtype=dtype), device)


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device`` without a stream sync (through
    pinned memory to a card)."""
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Ops on (B, T, H, W, C) frames in [0, 1]; v is a (B,) level per clip.
# ---------------------------------------------------------------------------

def _clip(v: torch.Tensor) -> torch.Tensor:
    """A (B,) per-clip value as a (B, 1, 1, 1, 1) one."""
    return v.reshape(-1, 1, 1, 1, 1)


def _blend(a, b, factor):
    return torch.clamp(b + factor * (a - b), 0.0, 1.0)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 1) luma, summed in f32 and rounded to x's dtype."""
    xf = x.float()
    g = xf[..., 0] * 0.299 + xf[..., 1] * 0.587 + xf[..., 2] * 0.114
    return g.to(x.dtype)[..., None]


def op_identity(x, _v):
    return x


def op_brightness(x, v):
    return _blend(x, torch.zeros_like(x), _clip(1.0 + v))


def op_contrast(x, v):
    # each frame's mean luma, summed in f64: the same bits at any batch size
    mean = _gray(x).double().mean(dim=(2, 3, 4), keepdim=True)
    return _blend(x, mean.to(x.dtype).expand_as(x), _clip(1.0 + v))


def op_color(x, v):
    return _blend(x, _gray(x).expand_as(x), _clip(1.0 + v))


def op_sharpness(x, v):
    """Blend with the 3x3 [[1,1,1],[1,5,1],[1,1,1]]/13 smoothing of each
    frame and channel (summed in f32); the border stays unsmoothed, as
    torchvision keeps it."""
    xf = x.float()
    acc = 5.0 * xf[:, :, 1:-1, 1:-1]
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) != (1, 1):
                acc = acc + xf[:, :, dy:dy + x.shape[2] - 2,
                               dx:dx + x.shape[3] - 2]
    blurred = x.clone()
    blurred[:, :, 1:-1, 1:-1] = (acc / 13.0).to(x.dtype)
    return _blend(x, blurred, _clip(1.0 + v))


def op_posterize(x, v):
    bits = torch.clamp(8 - v.to(torch.int32), 1, 8)
    q = torch.floor(x * 255.0).to(torch.int32)
    shift = _clip(8 - bits)
    q = torch.bitwise_left_shift(torch.bitwise_right_shift(q, shift), shift)
    return q.to(x.dtype) / 255.0


def op_solarize(x, v):
    return torch.where(x >= _clip(1.0 - v), 1.0 - x, x)


def op_autocontrast(x, _v):
    lo = torch.amin(x, dim=(2, 3), keepdim=True)
    hi = torch.amax(x, dim=(2, 3), keepdim=True)
    spread = hi > lo
    scale = torch.where(spread, 1.0 / (hi - lo), torch.ones_like(hi))
    off = torch.where(spread, lo, torch.zeros_like(lo))
    return torch.clamp((x - off) * scale, 0.0, 1.0)


def op_equalize_batch(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Per clip and channel 256-bin histogram equalization over the whole
    clip, the JAX LUT formula (torchvision's step).  The histogram counts
    every ``stride``-th H-row (1: every pixel, the exact op); the LUT maps
    every pixel."""
    b, _, _, _, c = x.shape
    q = torch.clamp(torch.floor(x * 255.0), 0, 255).to(torch.int64)
    base = (torch.arange(b, device=x.device).view(b, 1, 1, 1, 1) * c
            + torch.arange(c, device=x.device)) * 256
    sub = ((q if stride == 1 else q[:, :, ::stride]) + base).reshape(-1)
    # integer counts below 2^24 sum exactly in f32 in any order, and
    # index_add_ needs no host sync (torch.bincount reads its input's max)
    hist = torch.zeros(b * c * 256, device=x.device).index_add_(
        0, sub, torch.ones(sub.shape, device=x.device)).view(b, c, 256)
    cdf = torch.cumsum(hist, dim=-1)
    nz_min = torch.amin(torch.where(hist > 0, cdf,
                                    torch.full_like(cdf, math.inf)),
                        dim=-1, keepdim=True)
    denom = torch.clamp(cdf[..., -1:] - nz_min, min=1.0)
    lut = torch.clamp(torch.round((cdf - nz_min) / denom * 255.0), 0, 255)
    return lut.reshape(-1)[q + base].to(x.dtype) / 255.0


def op_equalize(x, _v):
    return op_equalize_batch(x, stride=1)


# Geometric ops run as 1-D row shears: a shear or translate's inverse map
# keeps one coordinate integral, so a 1-D lerp along the other axis is the
# exact bilinear result; rotate is the Paeth composition
# R = X(tan(t/2)) Y(-sin t) X(tan(t/2)), three 1-D lerps (the JAX package's
# documented divergence from 2-D bilinear rotation).

_GEO_PAD = 128   # covers the largest shift at magnitude 31


def _row_shear(planes: torch.Tensor, shift: torch.Tensor,
               pad: int = _GEO_PAD) -> torch.Tensor:
    """planes (R, C, L) -> out[r, c] = planes[r, c + shift[r]], 1-D
    bilinear along C, zero fill.  A start out of the padded range is
    clamped, as ``lax.gather`` clamps it (``pad`` must exceed the shifts)."""
    r, c, _ = planes.shape
    xp = F.pad(planes, (0, 0, pad, pad + 1))
    k = torch.floor(shift)
    f = (shift - k).to(planes.dtype)[:, None, None]
    start = torch.clamp(k.to(torch.int64) + pad, 0, 2 * pad)
    cols = start[:, None] + torch.arange(c + 1, device=planes.device)
    g = xp[torch.arange(r, device=planes.device)[:, None], cols]
    return (1.0 - f) * g[:, :c] + f * g[:, 1:]


def _shear_rows(x: torch.Tensor, shift: torch.Tensor, pad: int
                ) -> torch.Tensor:
    """x (B, T, H, W, C), shift (B, H): each row h of clip b moves along W
    by shift[b, h]."""
    b, t, h, w, c = x.shape
    planes = x.permute(0, 2, 3, 1, 4).reshape(b * h, w, t * c)
    out = _row_shear(planes, shift.reshape(-1), pad)
    return out.view(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def _shear_cols(x: torch.Tensor, shift: torch.Tensor, pad: int
                ) -> torch.Tensor:
    """x (B, T, H, W, C), shift (B, W): each column w of clip b moves along
    H by shift[b, w]."""
    b, t, h, w, c = x.shape
    planes = x.permute(0, 3, 2, 1, 4).reshape(b * w, h, t * c)
    out = _row_shear(planes, shift.reshape(-1), pad)
    return out.view(b, w, h, t, c).permute(0, 3, 2, 1, 4)


def _centered(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0


def _per_clip_f32(v, b, device) -> torch.Tensor:
    """A scalar or (B,) value as a (B, 1) f32 column."""
    if not torch.is_tensor(v):
        return torch.full((b, 1), float(v), device=device)
    return v.float().expand(b).reshape(b, 1)


def _geo_passes(x, lam1=0.0, beta=0.0, lam3=0.0, t1=0.0, t2=0.0,
                pad: int = _GEO_PAD) -> torch.Tensor:
    """x-shear(lam1) + translate(t1) -> y-shear(beta) + translate(t2) ->
    x-shear(lam3), each about the image center; each argument a scalar or
    a (B,) tensor."""
    b, _, h, w, _ = x.shape
    ys, xs = _centered(h, x.device), _centered(w, x.device)
    col = lambda v: _per_clip_f32(v, b, x.device)    # noqa: E731
    x = _shear_rows(x, col(lam1) * ys + col(t1), pad)
    x = _shear_cols(x, col(beta) * xs + col(t2), pad)
    return _shear_rows(x, col(lam3) * ys + torch.zeros_like(ys), pad)


def _geo_pad_bound(magnitude: int, h: int, w: int) -> int:
    """The largest |shift| any geometry op makes at ``magnitude``, plus 2
    (at most ``_GEO_PAD``)."""
    m = magnitude / 31.0
    dim = max(h, w)
    rad = math.radians(30.0 * m)
    shear = max(math.tan(rad / 2.0), math.sin(rad), 0.3 * m) * (dim - 1) / 2.0
    translate = 0.45 * m * dim
    return min(_GEO_PAD, int(math.ceil(max(shear, translate))) + 2)


def op_shear_x(x, v):
    return _geo_passes(x, lam1=v)


def op_shear_y(x, v):
    return _geo_passes(x, beta=v)


def op_translate_x(x, v):
    return _geo_passes(x, t1=v * x.shape[3])


def op_translate_y(x, v):
    return _geo_passes(x, t2=v * x.shape[2])


def op_rotate(x, v):
    rad = v * math.pi / 180.0
    a = torch.tan(rad / 2.0)
    return _geo_passes(x, lam1=a, beta=-torch.sin(rad), lam3=a)


# (fn, max_magnitude_value, signed)
RAND_AUGMENT_OPS: Tuple[Tuple[Callable, float, bool], ...] = (
    (op_identity, 0.0, False),
    (op_autocontrast, 0.0, False),
    (op_equalize, 0.0, False),
    (op_rotate, 30.0, True),
    (op_solarize, 1.0, False),
    (op_color, 0.9, True),
    (op_posterize, 4.0, False),
    (op_contrast, 0.9, True),
    (op_brightness, 0.9, True),
    (op_sharpness, 0.9, True),
    (op_shear_x, 0.3, True),
    (op_shear_y, 0.3, True),
    (op_translate_x, 0.45, True),
    (op_translate_y, 0.45, True),
)

_GEO_ROT, _GEO_SHX, _GEO_SHY, _GEO_TRX, _GEO_TRY = 3, 10, 11, 12, 13
_OP_EQUALIZE, _OP_SHARPNESS = 2, 9
# the ops a layer runs on the whole batch or on gathered clips, in the JAX
# select tree's order (the geometry after them, in its own passes)
_PLAIN_OPS = (1, 7, 4, 5, 6, 8, _OP_EQUALIZE, _OP_SHARPNESS)
_ELEMENTWISE_OPS = (4, 5, 6, 8)
# the layer's paths, one switch (module docstring)
AUG_PATHS = ("select", "subbatch", "capacity")
# the classes gathered by the sub-batch and fixed-capacity paths beside the
# elementwise ops, in the JAX gathered path's order: (name, ops)
_GATHERED = ((1, (1,)), (7, (7,)), (_OP_EQUALIZE, (_OP_EQUALIZE,)),
             (_OP_SHARPNESS, (_OP_SHARPNESS,)),
             ("x1", (_GEO_ROT, _GEO_SHX, _GEO_TRX)),
             ("y", (_GEO_ROT, _GEO_SHY, _GEO_TRY)), ("rot", (_GEO_ROT,)))


def sample_rand_augment(n: int, num_layers: int, prob: float,
                        generator: torch.Generator, device
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per clip and layer: the op (uniform over the 14), whether it applies
    (with ``prob``) and the sign of a signed op (+-1), each (n, num_layers)
    on ``device``, drawn from ``generator``."""
    shape = (n, num_layers)
    op = torch.randint(0, len(RAND_AUGMENT_OPS), shape, generator=generator,
                       device=device)
    apply = torch.rand(shape, generator=generator, device=device) < prob
    sign = torch.where(
        torch.rand(shape, generator=generator, device=device) < 0.5,
        -1.0, 1.0)
    return op, apply, sign


def _class_cap(b: int, p_class: float, sigmas: float = 3.0) -> int:
    """The fixed capacity of one op class in a layer of ``b`` clips: the
    mean + ``sigmas``-sigma tail of the Binomial(b, p_class) count, + 1, at
    most b (the JAX package's ``_class_cap``: overflow ~1e-3 a layer at 3
    sigma, which the select tree then serves)."""
    mean = b * p_class
    sd = (b * p_class * (1.0 - p_class)) ** 0.5
    return min(b, int(math.ceil(mean + sigmas * sd)) + 1)


def apply_layer_batch(x: torch.Tensor, op: torch.Tensor, apply: torch.Tensor,
                      sign: torch.Tensor, magnitude: int = 9,
                      eq_stride: int = 8, path: str = "subbatch",
                      host_ops: Optional[Sequence[int]] = None,
                      apply_prob: float = 1.0) -> torch.Tensor:
    """One RandAugment layer over the batch: clip i gets op ``op[i]`` (the
    identity where ``apply[i]`` is False) at ``magnitude``/31 of its
    largest level, signed by ``sign[i]``, on ``path`` (module docstring):
    ``"capacity"`` sizes its rows for ``apply_prob``, the probability that
    a layer applies; ``host_ops`` are the effective ops on the host for
    ``"subbatch"``, read from the device when None."""
    if path not in AUG_PATHS:
        raise ValueError(f"augmentation path {path!r}, not one of "
                         f"{AUG_PATHS}")
    b, _, h, w, _ = x.shape
    op = torch.where(apply, op, torch.zeros_like(op))

    def lvl(i):
        _, maxval, signed = RAND_AUGMENT_OPS[i]
        v = (magnitude / 31.0) * maxval
        return (v * sign if signed else torch.full_like(sign, v)).to(x.dtype)

    rad = lvl(_GEO_ROT).float() * math.pi / 180.0
    a = torch.tan(rad / 2.0)
    zero = torch.zeros_like(sign)
    lam1 = torch.where(op == _GEO_ROT, a, torch.where(
        op == _GEO_SHX, lvl(_GEO_SHX).float(), zero))
    beta = torch.where(op == _GEO_ROT, -torch.sin(rad), torch.where(
        op == _GEO_SHY, lvl(_GEO_SHY).float(), zero))
    lam3 = torch.where(op == _GEO_ROT, a, zero)
    t1 = torch.where(op == _GEO_TRX, (lvl(_GEO_TRX) * w).float(), zero)
    t2 = torch.where(op == _GEO_TRY, (lvl(_GEO_TRY) * h).float(), zero)
    pad = _geo_pad_bound(magnitude, h, w)
    ys, xs = _centered(h, x.device), _centered(w, x.device)

    def run(i, clips, rows=None):
        """Op class i on ``clips``: the batch's ``rows`` (all when None)."""
        if i == "x1":
            return _shear_rows(clips, lam1[rows, None] * ys + t1[rows, None],
                               pad)
        if i == "y":
            return _shear_cols(clips, beta[rows, None] * xs + t2[rows, None],
                               pad)
        if i == "rot":
            return _shear_rows(clips, lam3[rows, None] * ys
                               + torch.zeros_like(ys), pad)
        if i == _OP_EQUALIZE:
            return op_equalize_batch(clips, stride=eq_stride)
        v = lvl(i)
        return RAND_AUGMENT_OPS[i][0](clips, v if rows is None else v[rows])

    def select_tree(ops=_PLAIN_OPS, geometry=True):
        out = x
        for i in ops:
            out = torch.where(_clip(op == i), run(i, x), out)
        if not geometry:
            return out
        is_geo = (op == _GEO_ROT) | (op >= _GEO_SHX)
        warped = _geo_passes(x, lam1, beta, lam3, t1, t2, pad)
        # the geometry's passes leave a permuted layout: give the trunk the
        # sub-batch path's contiguous one, or its convs' gradients round
        # differently
        return torch.where(_clip(is_geo), warped, out).contiguous()

    if path == "select":
        return select_tree()
    if path == "capacity":
        caps = {n: _class_cap(b, apply_prob * len(ids) / 14.0)
                for n, ids in _GATHERED}
        if min(caps.values()) >= b:
            return select_tree()                   # tiny batches: no win
        masks = {n: functools.reduce(torch.logical_or,
                                     [op == i for i in ids])
                 for n, ids in _GATHERED}

        def gathered():
            out = select_tree(_ELEMENTWISE_OPS, geometry=False)
            for name, _ in _GATHERED:
                # the class's clips first, then others to fill the rows;
                # ops read OUT, so the geometry's passes chain
                rows = torch.argsort((~masks[name]).to(torch.uint8),
                                     stable=True)[:caps[name]]
                sub = out.index_select(0, rows)
                y = run(name, sub, rows)
                out.index_copy_(0, rows, torch.where(
                    _clip(masks[name][rows]), y, sub))
            return out

        overflow = torch.stack([masks[n].sum() > caps[n]
                                for n, _ in _GATHERED]).any()
        return cond.branch(overflow, select_tree, gathered,
                           torch.empty_like(x))

    if host_ops is None:
        host_ops = op.tolist()
    # the clips of each class, in one index tensor copied to the device
    classes = [(i, (i,)) for i in _ELEMENTWISE_OPS] + list(_GATHERED)
    members = [[n for n, o in enumerate(host_ops) if o in ids]
               for _, ids in classes]
    if not any(members):
        return x
    flat = _to_device(torch.tensor([n for m in members for n in m],
                                   dtype=torch.int64), x.device)
    out = x.clone()
    start = 0
    for (name, _), m in zip(classes, members):
        if not m:
            continue
        rows = flat[start:start + len(m)]
        start += len(m)
        out.index_copy_(0, rows, run(name, out.index_select(0, rows), rows))
    return out


def _augment(frames01, op, apply, sign, magnitude, eq_stride, path,
             apply_prob=1.0):
    """Every layer of (B, num_layers) draws over the batch."""
    host = (torch.where(apply, op, torch.zeros_like(op)).tolist()
            if path == "subbatch" else None)
    x = frames01
    for layer in range(op.shape[1]):
        x = apply_layer_batch(
            x, op[:, layer], apply[:, layer], sign[:, layer], magnitude,
            eq_stride, path,
            None if host is None else [row[layer] for row in host],
            apply_prob)
    return x


def rand_augment_batch(frames01: torch.Tensor, generator: torch.Generator,
                       num_layers: int = 2, magnitude: int = 9,
                       prob: float = 0.5, eq_stride: int = 8,
                       path: str = "subbatch") -> torch.Tensor:
    """Video-consistent RandAugment of (B, T, H, W, C) frames in [0, 1]:
    per clip and layer one op draw from ``generator``."""
    op, apply, sign = sample_rand_augment(frames01.shape[0], num_layers, prob,
                                          generator, frames01.device)
    return _augment(frames01, op, apply, sign, magnitude, eq_stride, path,
                    prob)


def _exponential(shape, generator, device) -> torch.Tensor:
    """Exponential(1) = Gamma(1) draws in f32 from ``generator``."""
    return -torch.log1p(-torch.rand(shape, generator=generator,
                                    device=device))


def aug_mix_weights(b: int, width: int, generator: torch.Generator, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per clip the chains' Dirichlet(1, ..., 1) weights (b, width) and the
    Beta(1, 1) weight of the mix (b,), from normalized exponentials (the
    JAX ``aug_mix_batch`` at its alpha, 1.0, the only one it is called
    with)."""
    e = _exponential((b, width), generator, device)
    x = _exponential((2, b), generator, device)
    return e / e.sum(dim=1, keepdim=True), x[0] / (x[0] + x[1])


def aug_mix_batch(frames01: torch.Tensor, generator: torch.Generator,
                  severity: int = 3, width: int = 3, depth: int = 2,
                  eq_stride: int = 8, path: str = "subbatch",
                  fold_chains: bool = True) -> torch.Tensor:
    """AugMix: ``width`` RandAugment chains of ``depth`` layers at
    ``severity`` (every layer applied) mixed with ``aug_mix_weights``,
    then blended with the clean clip, all drawn per clip.
    ``fold_chains`` runs the chains as one (width * B) batch, row w * B + i
    carrying chain w of clip i; the same bits as ``width`` calls on B
    clips."""
    b, dev, dt = frames01.shape[0], frames01.device, frames01.dtype
    ws, m = aug_mix_weights(b, width, generator, dev)
    op, apply, sign = sample_rand_augment(width * b, depth, 1.0, generator,
                                          dev)
    if fold_chains:
        tiled = frames01.repeat(width, 1, 1, 1, 1)
        chains = _augment(tiled, op, apply, sign, severity, eq_stride,
                          path).view((width, b) + frames01.shape[1:])
    else:
        rows = lambda i: slice(i * b, (i + 1) * b)   # noqa: E731
        chains = [_augment(frames01, op[rows(i)], apply[rows(i)],
                           sign[rows(i)], severity, eq_stride, path)
                  for i in range(width)]
    mixed = torch.zeros_like(frames01)
    for i in range(width):
        mixed = mixed + _clip(ws[:, i].to(dt)) * chains[i]
    mb = _clip(m.to(dt))
    return (1.0 - mb) * frames01 + mb * mixed


def augment_clips(frames01: torch.Tensor, augment_type: str,
                  generator: torch.Generator, path: str = "subbatch",
                  fold_chains: bool = True) -> torch.Tensor:
    """The training augmentation of ``augment_type`` (``AUGMENT_TYPES``)
    at the JAX defaults on ``path`` (``AUG_PATHS``): RandAugment for
    'rand_aug' and 'rand_aug_slowfast', AugMix for 'aug_mix'."""
    if augment_type == "aug_mix":
        return aug_mix_batch(frames01, generator, path=path,
                             fold_chains=fold_chains)
    if augment_type in ("rand_aug", "rand_aug_slowfast"):
        return rand_augment_batch(frames01, generator, path=path)
    raise ValueError(f"augment_type {augment_type!r} does not augment")

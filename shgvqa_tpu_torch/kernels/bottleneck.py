"""The fused slow_r50 bottleneck block of stride 1 and temporal kernel 1:
``relu(BN_c(conv_c(relu(BN_b(conv_b(relu(BN_a(conv_a(x)))))))) + r)`` with
``r = x`` or ``BN_p(conv_proj(x))``, on frames (N = B*T, H, W, Ci).

Replaces ``tools/proto_block_kernel.py::_make_block``, the Pallas TPU
prototype written for the trunk's res_2 and res_3 blocks, with the
hand-written CUDA C++ kernel in ``csrc/bottleneck.cu`` (sm_90a, built by
``kernels/_build.py`` and bound with ``ctypes``).  On the card the block is
bound by device memory once its intermediates stay on the chip (x read
once, y written once); the kernel takes bands of rows of a frame with a
one-row halo, since a whole frame does not fit in shared memory.
``bottleneck.cu`` describes the design.

- ``bottleneck_reference`` is the plain version with the rounding points of
  the TPU kernel and the JAX ``Bottleneck3D``: each conv summed in f32 and
  rounded to x's dtype, BN applied in x's dtype (folded scale and shift,
  cast as ``FrozenBatchNorm`` does), ReLU; the residual sum in x's dtype.
- ``fused_bottleneck`` runs the plain version for a tensor on the CPU and
  the kernel for a CUDA tensor; on the card it launches the kernel or
  raises.  It is forward only, as ``_make_block`` is, and raises when a
  gradient is required (``Bottleneck3D`` then runs its convs).  ``fused_bottleneck.launches`` counts the kernel's
  launches.

Weights come in the port's conv layouts with the unit kernel dimensions
dropped: ``wa`` (Cm, Ci), ``wb`` (Cm, Cm, 3, 3), ``wc`` (Co, Cm), and the
projection ``(wp (Co, Ci), sp, bp)``; every scale and shift is a (C,)
vector in x's dtype.  The kernel reads ``wb`` as (Cm, 3, 3, Cm), its memory
under ``channels_last_3d`` (a copy is made otherwise).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import _stream


def _conv1x1(x, w):
    """x (..., Ci) . w (Co, Ci)^T summed in f32, rounded to x's dtype."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def bottleneck_reference(x, wa, sa, ba, wb, sb, bb, wc, sc, bc, proj=None):
    """Plain PyTorch version: x (N, H, W, Ci); returns (N, H, W, Co) in x's
    dtype."""
    a = torch.relu(_conv1x1(x, wa) * sa + ba)
    b = F.conv2d(a.float().permute(0, 3, 1, 2), wb.float(), padding=1)
    b = torch.relu(b.permute(0, 2, 3, 1).to(x.dtype) * sb + bb)
    c = _conv1x1(b, wc) * sc + bc
    if proj is not None:
        wp, sp, bp = proj
        r = _conv1x1(x, wp) * sp + bp
    else:
        r = x
    return torch.relu(c + r)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/bottleneck.cu`` with its C signatures declared."""
    return declare(_build.load("bottleneck"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/bottleneck.cu``) with its C signatures
    declared."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shgvqa_bottleneck_bf16.argtypes = [ptr] * 14 + [i32] * 6 + [ptr]
    lib.shgvqa_bottleneck_bf16.restype = i32
    lib.shgvqa_bottleneck_error_string.argtypes = [i32]
    lib.shgvqa_bottleneck_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, wa, wb, wc, proj, vectors):
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck: x must be (N, H, W, Ci), got "
                         f"{tuple(x.shape)}")
    ci = x.shape[-1]
    cm, co = wa.shape[0], wc.shape[0]
    want = {"wa": (cm, ci), "wb": (cm, cm, 3, 3), "wc": (co, cm)}
    got = {"wa": wa, "wb": wb, "wc": wc}
    if proj is not None:
        want["wp"] = (co, ci)
        got["wp"] = proj[0]
    elif ci != co:
        raise ValueError(f"fused_bottleneck: without a projection Ci={ci} "
                         f"must equal Co={co}")
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_bottleneck: {name} must have shape "
                             f"{want[name]}, got {tuple(t.shape)}")
    for name, (t, c) in vectors.items():
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_bottleneck: {name} must have shape "
                             f"({c},), got {tuple(t.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *got.values()]
            + [v for v, _ in vectors.values()]):
        raise RuntimeError("fused_bottleneck is forward only: run it "
                           "under torch.no_grad() or inference_mode")


def takes(ci: int, cm: int, co: int) -> bool:
    """Whether the kernel takes a block of these widths: Cm 64 or 128, Ci a
    multiple of 64, Co of 128."""
    return cm in (64, 128) and ci % 64 == 0 and co % 128 == 0


def fused_bottleneck(x, wa, sa, ba, wb, sb, bb, wc, sc, bc, proj=None):
    """x (N, H, W, Ci) channels-last frames; weights and BN vectors as in
    the module docstring, cast to x's dtype here.  Returns (N, H, W, Co) in
    x's dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    cm, co = wa.shape[0], wc.shape[0]
    vectors = {"sa": (sa, cm), "ba": (ba, cm), "sb": (sb, cm), "bb": (bb, cm),
               "sc": (sc, co), "bc": (bc, co)}
    if proj is not None:
        vectors.update(sp=(proj[1], co), bp=(proj[2], co))
    _check(x, wa, wb, wc, proj, vectors)
    dt = x.dtype
    args = [t.to(dt) for t in (x, wa, sa, ba, wb, sb, bb, wc, sc, bc)]
    pr = None if proj is None else tuple(t.to(dt) for t in proj)
    if x.device.type == "cpu":
        return bottleneck_reference(*args, pr)
    if dt != torch.bfloat16:
        raise NotImplementedError(f"fused_bottleneck's kernel takes bfloat16 "
                                  f"frames, got {dt}")
    ci = x.shape[-1]
    if not takes(ci, cm, co):
        raise ValueError(f"fused_bottleneck: Cm={cm} must be 64 or 128, "
                         f"Ci={ci} a multiple of 64, Co={co} of 128")
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_bottleneck has no kernel for "
                                  f"{x.device}")
    y = launch(_lib(), args, pr)
    fused_bottleneck.launches += 1
    return y


fused_bottleneck.launches = 0


def launch(lib, args, proj):
    """One call of ``lib``'s ``shgvqa_bottleneck_bf16`` (a build of
    ``csrc/bottleneck.cu``) on the current stream: ``args`` (x, wa, sa, ba,
    wb, sb, bb, wc, sc, bc) and ``proj`` (wp, sp, bp) or None, bf16 on one
    card; returns y (N, H, W, Co)."""
    x = args[0]
    n, h, w, ci = x.shape
    cm, co = args[1].shape[0], args[7].shape[0]
    args = list(args)
    args[4] = args[4].permute(0, 2, 3, 1)            # wb -> (Cm, 3, 3, Cm)
    ops = [t.contiguous() for t in args] + (
        [None] * 3 if proj is None else [t.contiguous() for t in proj])
    for t in ops:
        if t is not None and (t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"fused_bottleneck: every operand must be on "
                             f"{x.device} and 16-byte aligned")
    y = torch.empty(n, h, w, co, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.shgvqa_bottleneck_bf16(
            *(None if t is None else t.data_ptr() for t in ops), y.data_ptr(),
            n, h, w, ci, cm, co, _stream(x.device))
    if err:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA error "
                           f"{err} ({lib.shgvqa_bottleneck_error_string(err).decode()})")
    return y

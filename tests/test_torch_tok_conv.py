"""The port's tokenizer conv (shgvqa_tpu_torch/kernels/tok_conv.py) against
the JAX Pallas prototype it replaces (tools/proto_tok_kernel.py, interpret
mode on the CPU, and its XLA reference) and the switched VisualTokenizer
against the JAX module.  The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against ``tok_conv_reference`` there); on the CPU
the wrapper takes the plain version, which is what these tests hold.

The kernel's plan is held here through a numpy mirror of csrc/tok_conv.cu
(constants read from the source): each K step's A tile as its TMA load in
im2col mode lands it (the tile's coordinates and the tap's offsets walked
across rows, frames and clips inside the bounding box of the output
positions, zeros in the padding and past the last clip), the work items of
``tile_plan`` (whole tiles, then K splits of the tail) and the sum of the
splits' partials in split order, emulated in f32 against
``tok_conv_reference``; and the wrapper's card path on CPU tensors with
its C entry replaced by that emulation.

Tolerances: f32 1e-5 (the prototype's erf is the A-S polynomial, within
1.5e-7 of ``torch.erf``); bf16 2e-2 of max |ref| (the prototype's own
check, proto_tok_kernel.py:166); the module 1e-4 (as the other layers)."""

import contextlib
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.models import visual as jvis
from shgvqa_tpu_torch.kernels import tok_conv
from shgvqa_tpu_torch.models import visual
from shgvqa_tpu_torch.models.layers import init_weights
from test_torch_common import close, jax_variables, load_port, t, tensor_at

REPO = Path(__file__).resolve().parent.parent


def _proto():
    spec = importlib.util.spec_from_file_location(
        "proto_tok_kernel", REPO / "tools" / "proto_tok_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(bsz, seed=0, t_len=8, s=7, ci=256, co=128):
    """numpy f32 operands; w in the prototype's (kT, 3, 3, Ci, Co)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, t_len, s, s, ci).astype(np.float32) * 0.1,
            rng.randn(5, 3, 3, ci, co).astype(np.float32) * 0.01,
            rng.randn(co).astype(np.float32) * 0.1)


def _port_weight(w):
    """(kT, 3, 3, Ci, Co) -> the port's Conv3d layout (Co, Ci, kT, 3, 3)."""
    return np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("bsz", [1, 2])
def test_plain_version_matches_prototype_f32(bsz):
    proto = _proto()
    x, w, b = _data(bsz, seed=bsz)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    want = np.asarray(proto.fused_tok_conv(jx, jw, jb, interpret=True))
    got = tok_conv.tok_conv_reference(t(x), t(_port_weight(w)), t(b))
    assert got.shape == (bsz, 4, 7, 7, 128) and got.dtype == torch.float32
    close(got, want, 1e-5)
    close(got, proto._xla_reference(jx, jw, jb), 1e-5)


def test_plain_version_matches_prototype_bf16():
    proto = _proto()
    x, w, b = _data(2, seed=3)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = proto.fused_tok_conv(jx, jw, jnp.asarray(b), interpret=True)
    args = (t(x, torch.bfloat16), t(_port_weight(w), torch.bfloat16), t(b))
    got = tok_conv.tok_conv_reference(*args)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want) <= 2e-2
    assert _rel_err(got.float(), proto._xla_reference(jx, jw, jnp.asarray(b))
                    ) <= 2e-2
    # the wrapper casts the weight to x's dtype and takes the plain version
    close(tok_conv.fused_tok_conv(*args), got.float(), 0.0)


def test_plain_version_without_gelu_matches_xla_reference():
    proto = _proto()
    x, w, b = _data(1, seed=4, t_len=6, s=5, ci=64, co=32)
    want = proto._xla_reference(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), gelu=False)
    close(tok_conv.fused_tok_conv(t(x), t(_port_weight(w)), t(b), gelu=False),
          want, 1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_visual_tokenizer_switch_matches_jax(use_kernel):
    feats = np.random.RandomState(10).randn(2, 10, 3, 3, 16).astype(
        np.float32)
    mod = jvis.VisualTokenizer(hidden_size=32)
    v = jax_variables(mod, feats)
    port = load_port(visual.VisualTokenizer(16, 32, 2 * 9 + 1), v)
    visual.set_tok_kernel(port, use_kernel)
    assert port.use_kernel is use_kernel
    with torch.no_grad():
        got = port(t(feats))
    assert got.shape == (2, 19, 32)
    close(got, mod.apply(v, feats), 1e-4)


def test_tokenizer_takes_the_kernel_only_outside_training(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return tok_conv.tok_conv_reference(args[0], args[1].to(args[0].dtype),
                                           args[2])

    monkeypatch.setattr(visual, "fused_tok_conv", counted)
    tok = init_weights(visual.VisualTokenizer(64, 32, 2 * 9 + 1)).eval()
    visual.set_tok_kernel(tok, True)
    feats = torch.randn(2, 10, 3, 3, 64)
    with torch.no_grad():
        tok(feats)
    assert calls == [(2, 10, 3, 3, 64), (2, 6, 3, 3, 32)]
    tok.train()
    tok(feats)
    assert len(calls) == 2


def test_wrapper_raises_on_bad_shapes_dtypes_and_grad():
    x = torch.randn(1, 8, 7, 7, 64)
    w = torch.randn(32, 64, 5, 3, 3)
    b = torch.randn(32)
    with pytest.raises(ValueError, match="do not fit"):
        tok_conv.fused_tok_conv(x, w[:, :32], b)
    with pytest.raises(ValueError, match="do not fit"):
        tok_conv.fused_tok_conv(x[:, :4], w, b)
    with pytest.raises(ValueError, match=r"\(Co, Ci, kT, 3, 3\)"):
        tok_conv.fused_tok_conv(x, w[..., :2], b)
    with pytest.raises(RuntimeError, match="forward only"):
        tok_conv.fused_tok_conv(x, w.requires_grad_(True), b)
    w.requires_grad_(False)
    # the card's checks, reached before any launch on a device that is not
    # the CPU
    def meta(a, dtype=torch.float32):
        return a.to(device="meta", dtype=dtype)

    bf16 = torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tok_conv.fused_tok_conv(meta(x), meta(w), meta(b))
    with pytest.raises(ValueError, match="multiple of 64"):
        tok_conv.fused_tok_conv(meta(x[..., :32], bf16), meta(w[:, :32]),
                                meta(b))
    with pytest.raises(ValueError, match="Co=32 of 256"):
        tok_conv.fused_tok_conv(meta(x, bf16), meta(w), meta(b))
    w, b = torch.randn(256, 64, 5, 3, 3), torch.randn(256)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        tok_conv.fused_tok_conv(meta(x, bf16), meta(w), meta(b))


# ---------------------------------------------------------------------------
# Mirror of csrc/tok_conv.cu (with csrc/wgmma_gemm.cuh's tile height and
# step depth)

CSRC = REPO / "shgvqa_tpu_torch" / "csrc"


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_constants_are_the_kernels():
    src, hdr = ((CSRC / n).read_text() for n in ("tok_conv.cu",
                                                 "wgmma_gemm.cuh"))
    assert (_constant(hdr, "kGemmBM"), _constant(src, "kBN"),
            _constant(hdr, "kGemmBK"), _constant(src, "kMaxSplits")) == (
        tok_conv.TILE_M, tok_conv.TILE_N, tok_conv.STEP_K,
        tok_conv.MAX_SPLITS)
    # the im2col map's bounding box, in (W, H, T)
    assert "const int lower[3] = {-1, -1, 0};" in src
    assert "const int upper[3] = {-1, -1, -(kt - 1)};" in src


def _a_tile(x, row0, step, kt):
    """The 128 x 64 A tile that the kernel's im2col TMA load of K step
    ``step`` lands for the tile whose first output row is ``row0``: the
    kernel's coordinates (the first position's (w - 1, h - 1, t, b)) and
    offsets (the tap's (dx, dy, dt)); the hardware walks 128 positions from
    the coordinates' place in the bounding box of the output positions (W
    fastest, then H, T, B), loads each one's input pixel at box position +
    lower corner + offset, and fills zeros outside the tensor.  Also
    returns the rows' input (b, t, h, w) and which are zeros."""
    bsz, t, h, w, ci = x.shape
    lower = np.array([-1, -1, 0])                       # (W, H, T)
    upper = np.array([-1, -1, -(kt - 1)])
    extent = np.array([w, h, t]) + upper - lower        # (W, H, T')
    kc = step * tok_conv.STEP_K
    tap, c0 = divmod(kc, ci)
    offsets = np.array([tap % 3, tap // 3 % 3, tap // 9])
    # the kernel's coordinates of the tile's first output position
    wo, ho = row0 % w, row0 // w % h
    frame = row0 // (w * h)
    to, b0 = frame % extent[2], frame // extent[2]
    coords = np.array([wo - 1, ho - 1, to])
    # the traversal from the coordinates' place in the bounding box
    start = coords - lower
    first = ((b0 * extent[2] + start[2]) * extent[1] + start[1]) * extent[0] \
        + start[0]
    lin = first + np.arange(tok_conv.TILE_M)
    pw, ph = lin % extent[0], lin // extent[0] % extent[1]
    pt, pb = lin // (extent[0] * extent[1]) % extent[2], \
        lin // (extent[0] * extent[1] * extent[2])
    iw, ih, it = (pw + lower[0] + offsets[0], ph + lower[1] + offsets[1],
                  pt + lower[2] + offsets[2])
    inside = ((iw >= 0) & (iw < w) & (ih >= 0) & (ih < h) & (it >= 0)
              & (it < t) & (pb < bsz))
    rows = np.zeros((tok_conv.TILE_M, tok_conv.STEP_K), np.float32)
    rows[inside] = x[pb[inside], it[inside], ih[inside], iw[inside],
                     c0:c0 + tok_conv.STEP_K]
    return rows, (pb, it, ih, iw), ~inside


def _gelu(v):
    return np.asarray(tok_conv._gelu_f32(torch.from_numpy(v)))


def _emulate(x, w, b, sms, gelu=True):
    """The kernel's work on f32 numpy operands (x channels-last, w (Co, kT,
    3, 3, Ci)): each work item of tile_plan over its K steps, whole tiles
    stored with the bias and the GeLU, split tiles' partials summed in
    split order by the second kernel.  Returns y (B, T', H, W, Co) and the
    plan."""
    bsz, t, h, wd, ci = x.shape
    co, kt = w.shape[:2]
    m, k = bsz * (t - kt + 1) * h * wd, kt * 9 * ci
    nk, bm, bn = k // tok_conv.STEP_K, tok_conv.TILE_M, tok_conv.TILE_N
    wk = w.reshape(co, k)
    tiles, full, splits = tok_conv.tile_plan(m, co, k, sms)
    col_tiles = co // bn
    y = np.full((m, co), np.nan, np.float32)
    part = np.zeros(((tiles - full) * splits, bm, bn), np.float32)
    for item in range(full + (tiles - full) * splits):
        tile, k0, k1 = item, 0, nk
        if item >= full:
            j = item - full
            tile, split = full + j // splits, j % splits
            k0, k1 = nk * split // splits, nk * (split + 1) // splits
        row0, col0 = tile // col_tiles * bm, tile % col_tiles * bn
        acc = np.zeros((bm, bn), np.float32)
        for step in range(k0, k1):
            a, _, _ = _a_tile(x, row0, step, kt)
            acc += a @ wk[col0:col0 + bn, step * tok_conv.STEP_K:
                          (step + 1) * tok_conv.STEP_K].T
        rows = row0 + np.arange(bm)
        kept = rows < m
        if item < full:
            v = acc[kept] + b[col0:col0 + bn]
            y[rows[kept], col0:col0 + bn] = _gelu(v) if gelu else v
        else:
            part[item - full][kept] = acc[kept]
    for tt in range(tiles - full):
        tile = full + tt
        row0, col0 = tile // col_tiles * bm, tile % col_tiles * bn
        total = part[tt * splits].copy()
        for i in range(1, splits):
            total += part[tt * splits + i]
        rows = row0 + np.arange(bm)
        kept = rows < m
        v = total[kept] + b[col0:col0 + bn]
        y[rows[kept], col0:col0 + bn] = _gelu(v) if gelu else v
    return y.reshape(bsz, t - kt + 1, h, wd, co), (tiles, full, splits)


def _mirror_data(ci, seed):
    """Two clips of T = 6 frames of 7 x 7, Co = 512 (two column tiles)."""
    x, w, b = _data(2, seed=seed, t_len=6, ci=ci, co=512)
    return x, np.ascontiguousarray(w.transpose(4, 0, 1, 2, 3)), b


@pytest.mark.parametrize("ci,sms,plan", [(64, 4, (4, 4, 1)),
                                         (64, 3, (4, 3, 2)),
                                         (128, 8, (4, 0, 2))])
def test_mirror_of_the_kernel_plan_matches_plain_version_f32(ci, sms, plan):
    """The emulated kernel against tok_conv_reference: whole tiles only,
    whole tiles then a tile split in two, every tile split in two."""
    x, wk, b = _mirror_data(ci, seed=ci + sms)
    got, got_plan = _emulate(x, wk, b, sms)
    assert got_plan == plan
    assert not np.isnan(got).any()            # every output stored once
    want = tok_conv.tok_conv_reference(
        t(x), t(np.ascontiguousarray(wk.transpose(0, 4, 1, 2, 3))), t(b))
    close(torch.from_numpy(got), want, 1e-5)
    got, _ = _emulate(x, wk, b, sms, gelu=False)
    want = tok_conv.tok_conv_reference(
        t(x), t(np.ascontiguousarray(wk.transpose(0, 4, 1, 2, 3))), t(b),
        gelu=False)
    close(torch.from_numpy(got), want, 1e-5)


def test_im2col_tiles_cross_frames_and_clips_with_zero_padding():
    """The second row tile of the mirror's input (rows 128-255 of M = 196)
    starts mid-frame in the second clip, crosses a frame boundary, and past
    row 196 walks into a third clip that is not there: zeros.  Taps off the
    frame's edge read zeros; the others the shifted pixel."""
    x, _, _ = _mirror_data(64, seed=0)
    kt, ci = 5, 64
    for tap in (0, 4, 8, 44):
        rows, (pb, it, ih, iw), zero = _a_tile(x, 128, tap * ci // 64, kt)
        m = np.arange(128, 256)
        b_out, t_out = m // 98, m // 49 % 2
        h_out, w_out = m // 7 % 7, m % 7
        dt, dy, dx = tap // 9, tap // 3 % 3, tap % 3
        assert np.array_equal(pb, b_out) and np.array_equal(it, t_out + dt)
        assert np.array_equal(ih, h_out + dy - 1)
        assert np.array_equal(iw, w_out + dx - 1)
        pad = ((h_out + dy - 1) % 8 == 7) | ((w_out + dx - 1) % 8 == 7) \
            | (b_out >= 2)
        assert np.array_equal(zero, pad)
        assert not rows[zero].any() and (m >= 196).sum() == 60
        real = ~zero
        assert np.array_equal(rows[real], x[b_out[real], (t_out + dt)[real],
                                            (h_out + dy - 1)[real],
                                            (w_out + dx - 1)[real], :64])


@pytest.mark.parametrize("m,plan", [(1176, (30, 0, 4)), (784, (21, 0, 6)),
                                    (18816, (441, 396, 2)),
                                    (12544, (294, 264, 4))])
def test_tile_plan_at_the_tokenizer_shapes(m, plan):
    """conv1 (K = 45 * 2048) and conv2 (K = 45 * 768) at B=2 and 32 on 132
    SMs: the tail is split so that it fills one more wave, or less."""
    k = 45 * (2048 if m in (1176, 18816) else 768)
    tiles, full, splits = tok_conv.tile_plan(m, 768, k, 132)
    assert (tiles, full, splits) == plan
    assert (tiles - full) * splits <= 132


def test_card_path_buffers_and_plan_with_the_emulated_kernel(monkeypatch):
    """_launch on CPU tensors with the C entry replaced by the emulation:
    the entry gets the shapes, the plan of the device's SM count and an f32
    partials buffer of (split items, 128, 256) (none without splits); it
    writes y, which the wrapper returns; launches count the calls."""
    x, wk, b = _mirror_data(64, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(wk).to(torch.bfloat16)
    bias = torch.from_numpy(b)
    calls = []

    def entry(px, pw, pb, py, ppart, bsz, t_len, h, w, ci, co, kt, full,
              splits, gelu, stream):
        shape = (bsz, t_len, h, w, ci)
        xs = tensor_at(px, shape, torch.bfloat16).float().numpy()
        ws = tensor_at(pw, (co, kt, 3, 3, ci), torch.bfloat16).float().numpy()
        bs = tensor_at(pb, (co,), torch.float32).numpy()
        y, plan = _emulate(xs, ws, bs, sms[0], bool(gelu))
        calls.append((shape, co, kt, full, splits, ppart is None, plan))
        tensor_at(py, y.shape, torch.bfloat16).copy_(torch.from_numpy(y))
        return 0

    sms = [3]
    monkeypatch.setattr(tok_conv, "_lib", lambda: SimpleNamespace(
        shgvqa_tok_conv_bf16=entry))
    monkeypatch.setattr(tok_conv, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(
                            multi_processor_count=sms[0]))
    before = tok_conv.fused_tok_conv.launches
    want = tok_conv.tok_conv_reference(xb, wb.permute(0, 4, 1, 2, 3), bias)
    for n_sms, plan in ((3, (4, 3, 2)), (4, (4, 4, 1))):
        sms[0] = n_sms
        got = tok_conv._launch(xb, wb, bias, True)
        assert calls[-1] == ((2, 6, 7, 7, 64), 512, 5, plan[1], plan[2],
                             plan[1] == plan[0], plan)
        assert got.shape == (2, 2, 7, 7, 512) and got.dtype == torch.bfloat16
        # f32 sums in another order, each rounded to bf16 once
        assert _rel_err(got.float(), want.float()) <= 1e-2
    assert tok_conv.fused_tok_conv.launches == before + 2

"""The int8 trunk's convolution (``shgvqa_tpu_torch/kernels/qconv.py``,
``csrc/qconv.cu``) on the CPU.

- ``quant_sym``, ``quant_weight`` and ``max_pool_i8`` bit-equal to the JAX
  package's (``shgvqa_tpu/models/backbone.py``), exact .5 ties and scales
  below the 1e-12 floor included;
- ``qconv_acc`` bit-equal to the JAX ``_qconv`` (s8 x s8 -> s32), and
  ``qconv_reference`` against ``_qconv`` + ``deq`` + ReLU + residual +
  ``quant_sym`` under ``jax.jit``: the int8 outputs equal in >= 99.9% of
  elements and never more than one step apart (XLA may skip a rounding
  of the epilogue when it fuses it);
- numpy mirrors of the kernel: its tile plan and im2col addressing (the
  128-row tiles over (B, T, Ho, Wo), K steps of 64 channels of one tap,
  zero rows in the padding of time, height and width, stride 2), its
  swizzle (conflict-free ldmatrix phases), and its epilogue's rounding
  order (each product and sum rounded to the compute dtype once, an IEEE
  f32 division, round half to even), held bit-equal to ``qconv_reference``;
- the card path (``_launch``) driven through a stand-in for the C entry;
  the wrapper's checks.
"""

import contextlib
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu_torch.kernels import qconv as qc
from test_torch_common import tensor_at

CSRC = Path(__file__).resolve().parent.parent / "shgvqa_tpu_torch" / "csrc"
KINDS = ((1, 1, 1), (3, 1, 1), (1, 3, 3))
MODES = (qc.MODE_QUANT, qc.MODE_DEQ, qc.MODE_RES, qc.MODE_RES_Q)
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# The JAX helpers, bit for bit

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_sym_matches_jax(dtype):
    tdt, jdt = DT[dtype]
    rng = np.random.RandomState(0)
    ties = np.arange(-140, 140, dtype=np.float32) + 0.5
    x = np.concatenate([rng.randn(4000).astype(np.float32) * 7.0, ties])
    for s in (1.0, 0.0371, 0.5, 1e-13, 0.0, 3e-12):
        want = np.asarray(jax_backbone.quant_sym(jnp.asarray(x, jdt), s))
        got = qc.quant_sym(torch.from_numpy(x).to(tdt), s)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        # a device scalar gives the same bits as a float
        again = qc.quant_sym(torch.from_numpy(x).to(tdt), torch.tensor(s))
        np.testing.assert_array_equal(again.numpy(), want)


def test_quant_weight_matches_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(3, 1, 1, 32, 24).astype(np.float32)
    w[..., 5] = 0.0                              # a channel at the floor
    w[..., 7] = np.round(w[..., 7] * 4) / 4      # many exact ties
    wq, sw = jax_backbone.quant_weight(jnp.asarray(w))
    got_q, got_s = qc.quant_weight(torch.from_numpy(w.transpose(4, 3, 0, 1,
                                                                2)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(got_q.numpy().transpose(2, 3, 4, 1, 0),
                                  np.asarray(wq))


def test_max_pool_i8_matches_jax_and_commutes_with_the_quantizer():
    rng = np.random.RandomState(2)
    for shape in ((2, 3, 16, 16, 8), (1, 2, 7, 9, 4)):
        xq = _i8(rng, *shape)
        want = np.asarray(jax_backbone._max_pool_i8(jnp.asarray(xq)))
        got = qc.max_pool_i8(torch.from_numpy(xq))
        np.testing.assert_array_equal(got.numpy(), want)
    # quantize-then-pool == pool-then-quantize (the JAX test's statement)
    x = torch.from_numpy(rng.rand(2, 3, 16, 16, 8).astype(np.float32) * 4)
    s = float(x.max()) / 127.0
    pooled = torch.nn.functional.max_pool3d(
        x.permute(0, 4, 1, 2, 3), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    torch.testing.assert_close(
        qc.max_pool_i8(qc.quant_sym(x, s)),
        qc.quant_sym(pooled.permute(0, 2, 3, 4, 1), s), rtol=0, atol=0)


def test_int32_to_bf16_rounds_through_f32():
    """``acc.to(bfloat16)``, the plain version's first rounding point and
    the kernel's ``__float2bfloat16_rn(__int2float_rn(acc))``: an int32
    sum above 2^24 rounds to f32 first, then to bf16 (2^25 + 2^17 + 1
    lands on 2^25 where one direct rounding would give 2^25 + 2^18)."""
    acc = torch.tensor([2 ** 25 + 2 ** 17 + 1, 2 ** 25 + 2 ** 17 + 4,
                        -(2 ** 26 + 2 ** 18 + 3), 12345], dtype=torch.int32)
    got = acc.to(torch.bfloat16)
    assert torch.equal(got, acc.float().to(torch.bfloat16))
    assert got[0].item() == 2 ** 25
    np.testing.assert_array_equal(
        _np(got), emulate_epilogue(acc.numpy(), np.float32(1),
                                   np.float32(0), "bfloat16", qc.MODE_DEQ,
                                   None, None, None))


# ---------------------------------------------------------------------------
# The plain version against the JAX path

def _operands(rng, kind, stride, ci=16, co=24, shape=(2, 4, 9, 9)):
    x = _i8(rng, *shape, ci)
    w = _i8(rng, co, *kind, ci)                  # (Co, kT, kH, kW, Ci)
    return x, w


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stride", (1, 2))
def test_qconv_acc_is_the_jax_s32_conv(kind, stride):
    x, w = _operands(np.random.RandomState(3), kind, stride)
    want = jax_backbone._qconv(jnp.asarray(x),
                               jnp.asarray(w.transpose(1, 2, 3, 4, 0)),
                               (1, stride, stride))
    got = qc.qconv_acc(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_epilogue(acc, scale, shift, jdt, mode, s_out, residual, s_res):
    """``deq`` (shgvqa_tpu/models/backbone.py:279) and the block's use of
    it: relu + quant_sym, the dequantized output, relu(+ r) + quant_sym."""
    v = acc.astype(jdt) * scale + shift
    if mode == qc.MODE_DEQ:
        return v
    if mode == qc.MODE_RES:
        v = v + residual
    elif mode == qc.MODE_RES_Q:
        v = v + residual.astype(jdt) * jnp.asarray(
            jnp.maximum(s_res, 1e-12), jdt)
    return jax_backbone.quant_sym(jax.nn.relu(v), s_out)


def _epilogue_operands(rng, co, out_shape, dtype, mode):
    tdt = DT[dtype][0]
    scale = torch.from_numpy(rng.rand(co).astype(np.float32) * 2e-3).to(tdt)
    shift = torch.from_numpy(rng.randn(co).astype(np.float32)).to(tdt)
    s_out = None if mode == qc.MODE_DEQ else torch.tensor(
        float(rng.rand() * 0.05 + 0.01))
    residual = s_res = None
    if mode == qc.MODE_RES:
        residual = torch.from_numpy(
            rng.randn(*out_shape).astype(np.float32)).to(tdt)
    elif mode == qc.MODE_RES_Q:
        residual = torch.from_numpy(_i8(rng, *out_shape))
        s_res = torch.tensor(float(rng.rand() * 0.02))
    return scale, shift, s_out, residual, s_res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_against_the_jax_epilogue(dtype):
    """Every kernel kind, stride and epilogue: int8 outputs equal in >=
    99.9% of elements and at most one step apart (XLA may round the fused
    epilogue fewer times; observed here: every int8 output equal, in f32
    and in bf16); the dequantized output within one rounding."""
    tdt, jdt = DT[dtype]
    rng = np.random.RandomState(4)
    fn = jax.jit(_jax_epilogue, static_argnums=(3, 4))
    equal = total = 0
    for kind in KINDS:
        for stride in (1, 2):
            x, w = _operands(rng, kind, stride)
            acc = qc.qconv_acc(torch.from_numpy(x), torch.from_numpy(w),
                               stride)
            for mode in MODES:
                ops = _epilogue_operands(rng, w.shape[0], acc.shape, dtype,
                                         mode)
                scale, shift, s_out, residual, s_res = ops
                got = qc.qconv_reference(torch.from_numpy(x),
                                         torch.from_numpy(w), scale, shift,
                                         stride, s_out, residual, s_res)
                want = np.asarray(fn(
                    jnp.asarray(acc.numpy()), jnp.asarray(_np(scale), jdt),
                    jnp.asarray(_np(shift), jdt), jdt, mode,
                    None if s_out is None else float(s_out),
                    None if residual is None else jnp.asarray(
                        _np(residual),
                        jnp.int8 if mode == qc.MODE_RES_Q else jdt),
                    None if s_res is None else float(s_res)))
                if mode == qc.MODE_DEQ:
                    np.testing.assert_allclose(_np(got), want.astype(
                        np.float32), rtol=1e-2 if dtype == "bfloat16"
                        else 1e-6, atol=1e-6)
                    continue
                diff = np.abs(got.numpy().astype(np.int32)
                              - want.astype(np.int32))
                assert diff.max() <= 1, (kind, stride, mode)
                equal += int((diff == 0).sum())
                total += diff.size
    assert equal / total >= 0.999, equal / total


# ---------------------------------------------------------------------------
# Mirrors of csrc/qconv.cu

def _constant(name):
    text = (CSRC / "qconv.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BM, STAGE_K = _constant("kBM"), _constant("kStageK")
MAX_STAGES, SMEM_OPTIN = _constant("kMaxStages"), _constant("kSmemOptin")
BAR_BYTES, LUT = _constant("kBarBytes"), _constant("kLut")
H100_SMS = 132


def test_mirror_constants_are_the_kernels():
    assert (_constant("kConsumers"), BM, STAGE_K) == (256, 128, 128)
    assert qc.CHANNEL_MULTIPLE == _constant("kChannelMultiple") == 64
    text = (CSRC / "qconv.cu").read_text()
    for name, value in (("kQuant", qc.MODE_QUANT), ("kDeq", qc.MODE_DEQ),
                        ("kRes", qc.MODE_RES), ("kResQ", qc.MODE_RES_Q)):
        assert f"{name} = {value}" in text
    # wgmma .s8 (m64nNk32, s32 sums), TMA in both modes; no mma.sync left
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n128k32\.s32\.s8\.s8",
                     text)
    # the tile's rows: 2 kBM in bf16, kBM in f32
    assert "return sizeof(T) == 2 ? 2 * kBM : kBM;" in text
    assert "cp.async.bulk.tensor.5d.shared::cluster.global.im2col" in text
    code = re.sub(r"//[^\n]*", "", text)
    assert "mma.sync" not in code and "ldmatrix" not in code


def test_sass_check_names_the_kernel_behind_a_path_hash():
    """chip_smoke.py's SASS and ptxas checks name a function by the
    innermost length-prefixed name ending in ``_kernel``: an anonymous
    namespace's mangled name holds a hash of the source's path, whose
    digits can spell an earlier, longer name ending at the same place (a
    checkout under another directory gave ``_8_qconv_cu_2ec5a49212qconv_kernel``
    for ``qconv_kernel``, and the check found no instruction)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_names", CSRC.parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for mangled in (
            "_ZN41_GLOBAL__N__1c2d3e4f_34_8_qconv_cu_2ec5a49212qconv_kernel"
            "ILi64EfLi0EEEv14CUtensorMap_stS2_S2_S2_NS_6ParamsE",
            "_ZN39_GLOBAL__N__0b551f6c_8_qconv_cu_2ec5a49212qconv_kernel"
            "ILi128E13__nv_bfloat16Li3EEEv14CUtensorMap_st"):
        assert smoke.kernel_name(mangled) == "qconv_kernel"
    assert smoke.kernel_name("_Z12ffn_o_kernelILi192EEvv") == "ffn_o_kernel"
    assert smoke.kernel_name("memcpy") == "memcpy"


def kernel_plan(shape, co, kernel, stride, mode, dtype, sms=H100_SMS):
    """The C entry's plan for one launch (shgvqa_qconv and launch<>): the
    tile width, the K step, the stages a tile, the ring's depth, the
    dynamic shared memory and the persistent grid."""
    b, t, h, w, ci = shape
    kt, kh, kw = kernel
    ho, wo = qc.out_side(h, kh, stride), qc.out_side(w, kw, stride)
    m, k = b * t * ho * wo, kt * kh * kw * ci
    bn = 128 if co % 128 == 0 else 64
    t_bytes = 2 if dtype == torch.bfloat16 else 4
    bm = 2 * BM if dtype == torch.bfloat16 else BM       # tile_rows
    out_e = t_bytes if mode == qc.MODE_DEQ else 1
    res_e = {qc.MODE_RES: t_bytes, qc.MODE_RES_Q: 1}.get(mode, 0)
    epi = bm * bn * (out_e + res_e)
    stage = (bm + bn) * STAGE_K
    stages = min(MAX_STAGES,
                 (SMEM_OPTIN - 1024 - BAR_BYTES - LUT - epi) // stage)
    tiles = -(-m // bm) * (co // bn)
    return dict(m=m, k=k, bn=bn, bm=bm, rb=128 if ci % 128 == 0 else 64,
                nk=-(-k // STAGE_K), im2col=(kernel, stride) != ((1, 1, 1), 1),
                stages=stages, smem=stages * stage + epi + BAR_BYTES + LUT + 1024,
                col_tiles=co // bn, tiles=tiles, grid=min(tiles, sms),
                ho=ho, wo=wo)


def persistent_schedule(plan):
    """Block b's tiles, in the order its producer loads them: tiles b, b +
    grid, ...; tile -> (m0, n0), row-major over (row tile, column tile)."""
    return [[((tile // plan["col_tiles"]) * plan["bm"], (tile % plan["col_tiles"])
              * plan["bn"]) for tile in range(blk, plan["tiles"], plan["grid"])]
            for blk in range(plan["grid"])]


def trunk_launches(b, t=16, side=56):
    """The int8 trunk's 52 launches at 224^2 (SlowR50: depths (3, 4, 6, 3),
    widths (64, 128, 256, 512) -> (256, 512, 1024, 2048), temporal kernel 3
    on conv_a of res_4 and res_5, stride 2 on conv_b and the projection of
    the first block of res_3..res_5): (x shape, Co, kernel, stride, mode)."""
    out, cin, h = [], 64, side
    for stage, (blocks, cm, co, kt) in enumerate(
            ((3, 64, 256, 1), (4, 128, 512, 1), (6, 256, 1024, 3),
             (3, 512, 2048, 3))):
        for i in range(blocks):
            s = 2 if stage and i == 0 else 1
            ho = qc.out_side(h, 3, s)
            out.append(((b, t, h, h, cin), cm, (kt, 1, 1), 1, qc.MODE_QUANT))
            out.append(((b, t, h, h, cm), cm, (1, 3, 3), s, qc.MODE_QUANT))
            if i == 0:
                out.append(((b, t, h, h, cin), co, (1, 1, 1), s, qc.MODE_DEQ))
            out.append(((b, t, ho, ho, cm), co, (1, 1, 1), 1,
                        qc.MODE_RES if i == 0 else qc.MODE_RES_Q))
            cin, h = co, ho
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3, "ragged"])
def test_persistent_schedule_covers_every_tile_once(stage):
    """At the trunk's conv shapes at B=2 (by res stage; 23 distinct shapes
    in all, 27 with the epilogues) and at ragged M, in bf16 and f32: the
    blocks' tiles are every (row tile, column tile) exactly once, the ring
    has 2-6 stages, and the shared memory fits an H100 block."""
    launches = trunk_launches(2)
    assert len(launches) == 52
    shapes = {(sh[-1], co, k, s, sh[2], m == qc.MODE_DEQ)
              for sh, co, k, s, m in launches}
    assert len(shapes) == 23
    assert len({(sh[-1], co, k, s, sh[2], m) for sh, co, k, s, m in launches}) == 27
    if stage == "ragged":
        cases = [((1, 3, 9, 11, 64), 128, (1, 3, 3), 2, qc.MODE_QUANT),
                 ((2, 5, 7, 7, 192), 64, (3, 1, 1), 1, qc.MODE_RES_Q),
                 ((1, 1, 3, 3, 64), 320, (1, 1, 1), 1, qc.MODE_RES)]
    else:
        first = [0, 10, 23, 42, 52][stage]
        cases = launches[first:[0, 10, 23, 42, 52][stage + 1]]
    for shape, co, kernel, stride, mode in cases:
        for dtype in (torch.bfloat16, torch.float32):
            plan = kernel_plan(shape, co, kernel, stride, mode, dtype)
            assert 2 <= plan["stages"] <= MAX_STAGES
            assert plan["smem"] <= SMEM_OPTIN
            assert co % plan["bn"] == 0 and plan["bn"] in (64, 128)
            seen = [tile for blk in persistent_schedule(plan) for tile in blk]
            want = [(m0, n0) for m0 in range(0, plan["m"], plan["bm"])
                    for n0 in range(0, co, plan["bn"])]
            assert sorted(seen) == want and len(seen) == plan["tiles"]


def _swz(r, byte, w):
    """csrc/qconv.cu swz: byte `byte` of row r in a tile of w-byte rows."""
    return r * w + ((((byte >> 4) ^ ((r * w >> 7) & (w // 16 - 1)))) << 4) \
        + (byte & 15)


def _tma_swizzle(addr, w):
    """The TMA's w-byte swizzle of a w-aligned row layout: 16-byte chunk
    bits 4.. XOR address bits 7.. (3 bits for 128 bytes, 2 for 64)."""
    bits = 3 if w == 128 else 2
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def a_tile(x, plan, kernel, stride, m0, k0):
    """The tile_rows x rb bytes of A that the producer lands for rows m0..
    and K bytes k0..: the im2col map (the filter origin of each output
    position, walked through the bounding box with the traversal stride,
    the tap's offsets added, zeros outside the tensor and past the last
    position) or, for a 1x1 stride-1 conv, the tiled map over (M, Ci);
    zeros for a K step past K."""
    b, t, h, w, ci = x.shape
    kt, kh, kw = kernel
    rb = plan["rb"]
    rows = m0 + np.arange(plan["bm"])
    tile = np.zeros((plan["bm"], rb), np.int64)
    if k0 >= plan["k"]:
        return tile
    live = rows < plan["m"]
    if not plan["im2col"]:
        tile[live] = x.reshape(-1, ci)[rows[live], k0:k0 + rb]
        return tile
    tap, c0 = k0 // ci, k0 % ci
    dt, dy, dx = tap // (kh * kw), (tap // kw) % kh, tap % kw
    xo, yo = rows % plan["wo"], (rows // plan["wo"]) % plan["ho"]
    frame = rows // (plan["wo"] * plan["ho"])
    to, bb = frame % t, frame // t
    # the box corners: origins from -k/2 to dim - 1 + k/2 - (k - 1), every s
    ow, oh, od = xo * stride - kw // 2, yo * stride - kh // 2, to - kt // 2
    assert (ow <= w - 1 + kw // 2 - (kw - 1)).all()
    assert (oh <= h - 1 + kh // 2 - (kh - 1)).all()
    wi, hi, ti = ow + dx, oh + dy, od + dt
    ok = live & (wi >= 0) & (wi < w) & (hi >= 0) & (hi < h) & (ti >= 0) \
        & (ti < t)
    tile[ok] = x[bb[ok], ti[ok], hi[ok], wi[ok], c0:c0 + rb]
    return tile


def emulate_acc(x, wk, stride, dtype=torch.bfloat16):
    """The kernel's products in numpy: every tile of the persistent
    schedule, stage by stage (128 bytes of K: one 128-channel step or two
    64-channel steps), A as the producer lands it (a_tile), B the weight's
    rows n0.. (zeros past K), summed in s32 order-free.  Returns (B, T, Ho,
    Wo, Co) int64."""
    co, kt, kh, kw = wk.shape[:4]
    b, t = x.shape[:2]
    plan = kernel_plan(x.shape, co, (kt, kh, kw), stride, qc.MODE_QUANT,
                       dtype)
    k = plan["k"]
    wflat = np.zeros((co, plan["nk"] * STAGE_K), np.int64)
    wflat[:, :k] = wk.reshape(co, k)
    out = np.zeros((plan["m"], co), np.int64)
    for blk in persistent_schedule(plan):
        for m0, n0 in blk:
            acc = np.zeros((plan["bm"], plan["bn"]), np.int64)
            for ks in range(plan["nk"]):
                for sub in range(STAGE_K // plan["rb"]):
                    k0 = ks * STAGE_K + sub * plan["rb"]
                    a = a_tile(x, plan, (kt, kh, kw), stride, m0, k0)
                    acc += a @ wflat[n0:n0 + plan["bn"], k0:k0 + plan["rb"]].T
            rows = min(plan["bm"], plan["m"] - m0)
            out[m0:m0 + rows, n0:n0 + plan["bn"]] = acc[:rows]
    return out.reshape(b, t, plan["ho"], plan["wo"], co)


@pytest.mark.parametrize("kind,stride,shape,co", [
    ((1, 3, 3), 2, (1, 3, 9, 11, 64), 128),      # ragged M, stride 2, Ci 64
    ((3, 1, 1), 1, (2, 5, 7, 7, 128), 64),       # the temporal padding
    ((1, 1, 1), 2, (1, 2, 6, 6, 128), 256),      # a strided projection
    ((1, 3, 3), 1, (1, 2, 14, 14, 64), 64),      # 392 rows: 4 row tiles
    ((1, 1, 1), 1, (2, 3, 5, 7, 256), 128),      # the tiled map
    ((3, 1, 1), 1, (1, 4, 5, 5, 192), 64),       # K = 576: a half stage
])
def test_im2col_boxes_give_the_exact_conv(kind, stride, shape, co):
    rng = np.random.RandomState(5)
    x, w = _i8(rng, *shape), _i8(rng, co, *kind, shape[-1])
    want = qc.qconv_acc(torch.from_numpy(x), torch.from_numpy(w), stride)
    np.testing.assert_array_equal(emulate_acc(x, w, stride), want.numpy())


@pytest.mark.parametrize("w", [128, 64])
def test_int8_swizzle_is_the_tmas_and_conflict_free(w):
    """swz is a bijection of a w-byte-row tile onto itself and the TMA's
    w-byte swizzle (so the epilogue reads the residual where the TMA landed
    it and stages the output where the TMA store reads it); a warp's
    2-byte accumulator-layout accesses (row lane / 4 (+ 8 h), column 8 j +
    2 (lane % 4)) touch each bank group at most once a 16-byte chunk."""
    rows = 2 * BM // 2                      # a warpgroup's rows of a tall tile
    addrs = [_swz(r, c, w) for r in range(rows) for c in range(w)]
    assert sorted(addrs) == list(range(rows * w))
    for r in range(rows):
        for c in range(w):
            assert _swz(r, c, w) == _tma_swizzle(r * w + c, w)
    for elem in (1, 2):                      # int8 output / bf16 residual
        for j in range(w // (8 * elem)):
            for h in range(2):
                chunks = {_swz(lane // 4 + 8 * h, (8 * j + 2 * (lane % 4))
                               * elem, w) // 16 for lane in range(32)}
                # 8 rows, one 16-byte chunk each, in 8 distinct bank groups
                assert len(chunks) == 8
                assert len({c % 8 for c in chunks}) == 8


def _kmajor_desc(addr, row):
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | (((8 * row) >> 4) << 32) \
        | ((1 if row == 128 else 2) << 62)


def _desc_byte(desc, mn, k):
    """The byte wgmma reads for operand element (mn, K byte k < 32) of a
    k32 slice: the K-major canonical layout ((8, m), (w)) : ((w B, SBO),
    (1 B)), w the swizzle span, swizzled on the absolute address."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    w = 128 if desc >> 62 == 1 else 64
    assert sbo == 8 * w
    return _tma_swizzle(start + (mn % 8) * w + (mn // 8) * sbo + k, w)


@pytest.mark.parametrize("rb", [128, 64])
def test_kmajor_descriptors_read_the_landed_tiles(rb):
    """Each k32 slice kk of a stage: its K step `sub` and offset `off` (as
    the consumer computes them) and the descriptor at sub-tile + the
    warpgroup's m64 half + off read exactly the byte the TMA landed for
    (row, K byte 32 kk + k), for A (tiles of 256 rows, two halves a
    warpgroup, or 128, one) and B (BN rows)."""
    stage = 1024 * 37                           # a 1 KB-aligned stage
    for bm, bn in ((2 * BM, 128), (2 * BM, 64), (BM, 128)):
        wg_rows = bm // 2
        for kk in range(STAGE_K // 32):
            sub, off = (kk * 32) // rb, kk * 32 - (kk * 32) // rb * rb
            assert sub * rb + off == 32 * kk
            for wg in range(2):
                for mh in range(wg_rows // 64):
                    d = _kmajor_desc(stage + sub * bm * rb
                                     + (wg * wg_rows + 64 * mh) * rb + off, rb)
                    for mn in range(0, 64, 3):
                        for k in range(0, 32, 5):
                            row = wg * wg_rows + 64 * mh + mn
                            landed = stage + sub * bm * rb + _tma_swizzle(
                                row * rb + off + k, rb)
                            assert _desc_byte(d, mn, k) == landed
            b = stage + bm * STAGE_K
            d = _kmajor_desc(b + sub * bn * rb + off, rb)
            for mn in range(0, bn, 7):
                for k in range(0, 32, 5):
                    landed = b + sub * bn * rb + _tma_swizzle(
                        mn * rb + off + k, rb)
                    assert _desc_byte(d, mn, k) == landed


def _bf16(v):
    """np.float32 -> nearest bf16 (ties to even), as np.float32."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _bf16_exact(v):
    """float64 -> nearest bf16 (ties to even), as np.float32: the correct
    rounding of an exact result, as the bf16x2 instructions give."""
    v = np.asarray(v, np.float64)
    m, e = np.frexp(v)                           # v = m 2^e, 0.5 <= |m| < 1
    scaled = np.ldexp(m, 8)                      # 8 significant bits
    return np.ldexp(np.rint(scaled), e - 8).astype(np.float32)


def quant_exact(u, s):
    """clamp(rint(u / max(s, 1e-12)), -127, 127), the IEEE f32 division
    (+inf past the largest float, as on the card)."""
    s = np.maximum(np.float32(s), np.float32(1e-12))
    with np.errstate(over="ignore"):
        return np.clip(np.rint(np.float32(u) / s), -127, 127).astype(np.int8)


def quant_table(s):
    """csrc/qconv.cu's bf16 quant() table: the ramp's foot (the least bf16
    pattern that quant_exact takes to 1, by bisection) and entry i =
    quant_exact of pattern foot + i - 1 (entry 0 = 0)."""
    s = np.maximum(np.float32(s), np.float32(1e-12))

    def value(bits):
        return (np.asarray(bits, np.uint32) << 16).view(np.float32)

    lo, hi = 0, 0x7F80
    while lo < hi:
        mid = (lo + hi) // 2
        if quant_exact(value(mid), s) >= 1:
            hi = mid
        else:
            lo = mid + 1
    bits = np.minimum(lo + np.arange(LUT) - 1, 0x7F80)
    table = quant_exact(value(bits), s)
    table[0] = 0
    return lo, table


def quant_lut(u, foot, table):
    """quant() of bf16 values u >= 0 through the table (the clamped index)."""
    bits = (np.asarray(u, np.float32).view(np.uint32) >> 16) & 0x7FFF
    return table[np.clip(bits.astype(np.int64) - foot + 1, 0, LUT - 1)]


def emulate_epilogue(acc, scale, shift, dtype, mode, s_out, residual,
                     s_res):
    """The kernel's epilogue in numpy.  bf16: pairs rounded once at each
    operation from the exact result (cvt.rn, mul.rn / add.rn .bf16x2),
    int8 residual times T(max(s_res, 1e-12)), max with 0, quant() through
    the table; f32: f32 operations and the division."""
    if dtype == "float32":
        f32 = np.float32
        v = (acc.astype(f32) * scale).astype(f32) + shift
        if mode == qc.MODE_DEQ:
            return v.astype(f32)
        if mode == qc.MODE_RES:
            v = (v + residual).astype(f32)
        elif mode == qc.MODE_RES_Q:
            rs = np.maximum(np.float32(s_res), np.float32(1e-12))
            v = (v + (residual.astype(f32) * rs).astype(f32)).astype(f32)
        return quant_exact(np.maximum(v, f32(0)), s_out)
    u = _bf16(acc.astype(np.float32))
    u = _bf16_exact(u.astype(np.float64) * scale.astype(np.float64))
    v = _bf16_exact(u.astype(np.float64) + shift.astype(np.float64))
    if mode == qc.MODE_DEQ:
        return v
    if mode == qc.MODE_RES:
        v = _bf16_exact(v.astype(np.float64) + residual.astype(np.float64))
    elif mode == qc.MODE_RES_Q:
        rs = _bf16(np.maximum(np.float32(s_res), np.float32(1e-12)))
        w = _bf16_exact(residual.astype(np.float64) * np.float64(rs))
        v = _bf16_exact(v.astype(np.float64) + w.astype(np.float64))
    foot, table = quant_table(s_out)
    return quant_lut(np.maximum(v, np.float32(0)), foot, table)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_mirror_of_the_epilogue_is_the_plain_version(dtype, mode):
    rng = np.random.RandomState(6 + mode)
    x, w = _i8(rng, 2, 3, 6, 6, 64), _i8(rng, 64, 1, 3, 3, 64)
    acc = qc.qconv_acc(torch.from_numpy(x), torch.from_numpy(w), 1)
    scale, shift, s_out, residual, s_res = _epilogue_operands(
        rng, 64, acc.shape, dtype, mode)
    want = qc.qconv_reference(torch.from_numpy(x), torch.from_numpy(w),
                              scale, shift, 1, s_out, residual, s_res)
    got = emulate_epilogue(
        acc.numpy(), _np(scale), _np(shift), dtype, mode,
        None if s_out is None else float(s_out),
        None if residual is None else _np(residual),
        None if s_res is None else float(s_res))
    np.testing.assert_array_equal(got, _np(want))


@pytest.mark.parametrize("op", ["add", "mul"])
def test_bf16_operations_through_f32_are_correctly_rounded(op):
    """The kernel's bf16x2 add and mul round the exact result once; the
    plain version computes in f32 and rounds to bf16.  They agree because
    f32's 24 bits are at least 2 x 8 + 2: checked on every pair of bf16
    significands (both signs of b) with b scaled down by 0-26 binades
    (beyond 17 the smaller addend is below a quarter of an ulp and both
    give a; a product of two bf16 values is exact in f32)."""
    sig = (1.0 + np.arange(128) / 128.0)
    a, b = np.meshgrid(sig, sig, indexing="ij")
    a, b = a.ravel(), b.ravel()
    for shift in range(27):
        for sign in (1.0, -1.0):
            bb = sign * np.ldexp(b, -shift)
            if op == "add":
                exact = a + bb
                via_f32 = _bf16((a.astype(np.float32) + bb.astype(np.float32))
                                .astype(np.float32))
            else:
                exact = a * bb
                via_f32 = _bf16((a.astype(np.float32) * bb.astype(np.float32))
                                .astype(np.float32))
            np.testing.assert_array_equal(via_f32, _bf16_exact(exact))


def test_quant_table_is_the_division_for_every_bf16():
    """quant() through the table equals the IEEE division's quant_exact at
    every non-negative bf16 value (32,641 patterns up to +inf, -0 as 0), for
    scales from 1e-13 (under the 1e-12 floor) to 1e30, around powers of two
    and where many quotients tie at .5; the ramp fits the table with room
    (quant_exact is non-decreasing in u, so the table's clamped lookup is
    exact wherever the ramp fits)."""
    rng = np.random.RandomState(7)
    scales = np.concatenate([
        10.0 ** rng.uniform(-13, 30, 150),
        [1e-12, 1e-13, 0.0, 1.0, 0.5, 2.0 ** -7, 2.0 ** 20, 0.0371, 3e-12],
        np.ldexp(1.0, np.arange(-40, 40, 7)) * (1 + 2.0 ** -23)])
    bits = np.arange(0x7F81, dtype=np.uint32)
    u = (bits << 16).view(np.float32)
    for s in scales.astype(np.float32):
        foot, table = quant_table(s)
        np.testing.assert_array_equal(quant_lut(u, foot, table),
                                      quant_exact(u, s))
        assert quant_lut(np.float32(-0.0), foot, table) == 0
        ramp = int(np.argmax(quant_exact(u, s) == 127))
        assert ramp - foot + 1 < LUT - 64, (s, ramp - foot)


# ---------------------------------------------------------------------------
# The card path through a stand-in for the C entry

_CODES = {0: torch.bfloat16, 1: torch.float32}


def _stand_in(calls):
    """``shgvqa_qconv`` in numpy: reads every operand at its pointer (the
    scales as device f32 scalars), runs the mirrors, writes y."""

    def entry(px, pw, psc, psh, pres, psres, psout, py, b, t, h, w, ci, co,
              kt, kh, kw, stride, mode, dtype, stream):
        dt = _CODES[dtype]
        x = tensor_at(px, (b, t, h, w, ci), torch.int8).numpy()
        wk = tensor_at(pw, (co, kt, kh, kw, ci), torch.int8).numpy()
        sc = _np(tensor_at(psc, (co,), dt))
        sh = _np(tensor_at(psh, (co,), dt))
        ho = (h + 2 * (kh // 2) - kh) // stride + 1
        wo = (w + 2 * (kw // 2) - kw) // stride + 1
        out = (b, t, ho, wo, co)
        res = None if pres is None else _np(tensor_at(
            pres, out, torch.int8 if mode == qc.MODE_RES_Q else dt))
        s_res = None if psres is None else float(
            tensor_at(psres, (), torch.float32))
        s_out = None if psout is None else float(
            tensor_at(psout, (), torch.float32))
        acc = emulate_acc(x, wk, stride, dt)
        y = emulate_epilogue(acc, sc, sh, "bfloat16" if dtype == 0
                             else "float32", mode, s_out, res, s_res)
        target = tensor_at(py, out, dt if mode == qc.MODE_DEQ else torch.int8)
        target.copy_(torch.from_numpy(y).to(target.dtype))
        calls.append((b, t, h, w, ci, co, kt, kh, kw, stride, mode, dtype,
                      pres is None, psres is None, psout is None))
        return 0

    return entry


@pytest.mark.parametrize("mode", MODES)
def test_card_path_with_a_stand_in_entry(monkeypatch, mode):
    calls = []
    monkeypatch.setattr(qc, "_lib", lambda: SimpleNamespace(
        shgvqa_qconv=_stand_in(calls),
        shgvqa_qconv_error_string=lambda err: b"?"))
    monkeypatch.setattr(qc, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    rng = np.random.RandomState(10 + mode)
    dtype = "bfloat16" if mode != qc.MODE_DEQ else "float32"
    x, w = _i8(rng, 1, 3, 7, 9, 64), _i8(rng, 128, 1, 3, 3, 64)
    out = (1, 3, 4, 5, 128)
    ops = _epilogue_operands(rng, 128, out, dtype, mode)
    args = (torch.from_numpy(x), torch.from_numpy(w), ops[0], ops[1], 2,
            ops[2], ops[3], ops[4])
    before = qc.qconv.launches
    got = qc._launch(*args)
    want = qc.qconv_reference(*args)
    assert qc.qconv.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert calls == [(1, 3, 7, 9, 64, 128, 1, 3, 3, 2, mode,
                      0 if dtype == "bfloat16" else 1,
                      ops[3] is None, ops[4] is None, ops[2] is None)]


def test_wrapper_checks_name_the_flag_and_refuse_a_gradient():
    x = torch.zeros(1, 2, 4, 4, 64, dtype=torch.int8)
    w = torch.randn(64, 64, 1, 3, 3)
    inv, shift = torch.ones(64), torch.zeros(64)
    s = torch.tensor(0.1)
    with pytest.raises(ValueError, match="--quantBackbone int8.*int8"):
        qc.qconv(x.float(), s, w, inv, shift)
    with pytest.raises(ValueError, match="--quantBackbone int8.*Ci=64"):
        qc.qconv(x, s, w[:, :32], inv, shift)
    with pytest.raises(ValueError, match="--quantBackbone int8.*kernel"):
        qc.qconv(x, s, torch.randn(64, 64, 1, 5, 5), inv, shift)
    with pytest.raises(ValueError, match="--quantBackbone int8.*stride"):
        qc.qconv(x, s, w, inv, shift, stride=3)
    with pytest.raises(ValueError, match="--quantBackbone int8.*dtype"):
        qc.qconv(x, s, w, inv, shift, dtype=torch.float16)
    with pytest.raises(ValueError, match="residual needs s_out"):
        qc.qconv(x, s, w, inv, shift, residual=x)
    with pytest.raises(RuntimeError, match="forward only"):
        qc.qconv(x, s, w.requires_grad_(True), inv, shift, s_out=s)
    w.requires_grad_(False)
    with torch.no_grad():
        assert qc.qconv(x, s, w.requires_grad_(True), inv, shift,
                        s_out=s).dtype == torch.int8
    w.requires_grad_(False)
    # the card's checks, reached on a device that is not the CPU
    meta = lambda a: a.to("meta")                    # noqa: E731
    with pytest.raises(ValueError, match="multiples of 64"):
        qc.qconv(meta(x[..., :32]), meta(s), meta(w[:, :32]), meta(inv),
                 meta(shift))
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        qc.qconv(meta(x), meta(s), meta(w), meta(inv), meta(shift),
                 s_out=meta(s))

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
    return int(re.search(rf"\b{name} = (\d+)[,;]", text).group(1))


def test_mirror_constants_are_the_kernels():
    assert (_constant("kThreads"), _constant("kBM"), _constant("kBK"),
            _constant("kStages")) == (256, 128, 64, 4)
    assert qc.CHANNEL_MULTIPLE == _constant("kBK")
    text = (CSRC / "qconv.cu").read_text()
    for name, value in (("kQuant", qc.MODE_QUANT), ("kDeq", qc.MODE_DEQ),
                        ("kRes", qc.MODE_RES), ("kResQ", qc.MODE_RES_Q)):
        assert f"{name} = {value}" in text


def _swz(r, c):
    """csrc/qconv.cu swz: chunk c of 64-byte row r."""
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


def test_swizzle_is_a_bijection_and_ldmatrix_conflict_free():
    addrs = {_swz(r, c) for r in range(128) for c in range(4)}
    assert addrs == set(range(0, 128 * 64, 16))
    # an ldmatrix phase reads 8 consecutive rows at one logical chunk: the
    # 8 16-byte reads fall in 8 distinct bank groups of a 128-byte line
    for r0 in range(0, 128, 8):
        for c in range(4):
            assert len({(_swz(r0 + i, c) % 128) // 16
                        for i in range(8)}) == 8


def emulate_acc(x, w, stride, bn):
    """The kernel's tile plan in numpy: 128-row tiles over M = (b, t, yo,
    xo), ``bn``-column tiles; per K step (64 channels of one tap (dt, dy,
    dx)) the A rows the cp.async copies land, zero where the tap falls in
    the padding or the row is past M, and the B rows [n][k]."""
    bm, bk = _constant("kBM"), _constant("kBK")
    b, t, h, wd, ci = x.shape
    co, kt, kh, kw = w.shape[:4]
    ho = (h + 2 * (kh // 2) - kh) // stride + 1
    wo = (wd + 2 * (kw // 2) - kw) // stride + 1
    m_total, k_total = b * t * ho * wo, kt * kh * kw * ci
    wk = w.reshape(co, k_total).astype(np.int64)
    out = np.zeros((m_total, co), np.int64)
    for m0 in range(0, m_total, bm):
        m = m0 + np.arange(bm)
        live = m < m_total
        xo, yo = m % wo, (m // wo) % ho
        bt = m // (wo * ho)
        bb, tt = bt // t, bt % t
        for n0 in range(0, co, bn):
            acc = np.zeros((bm, bn), np.int64)
            for ks in range(k_total // bk):
                k0 = ks * bk
                tap, c0 = k0 // ci, k0 % ci
                dt, dy, dx = tap // (kh * kw), (tap // kw) % kh, tap % kw
                ti = tt + dt - kt // 2
                yi = yo * stride + dy - kh // 2
                xi = xo * stride + dx - kw // 2
                ok = (live & (ti >= 0) & (ti < t) & (yi >= 0) & (yi < h)
                      & (xi >= 0) & (xi < wd))
                a = np.zeros((bm, bk), np.int64)
                a[ok] = x[bb[ok], ti[ok], yi[ok], xi[ok], c0:c0 + bk]
                acc += a @ wk[n0:n0 + bn, k0:k0 + bk].T
            out[m[live], n0:n0 + bn] = acc[live]
    return out.reshape(b, t, ho, wo, co)


@pytest.mark.parametrize("kind,stride,shape,co", [
    ((1, 3, 3), 2, (1, 3, 9, 11, 64), 128),      # ragged M, stride 2
    ((3, 1, 1), 1, (2, 5, 7, 7, 128), 64),       # the temporal padding
    ((1, 1, 1), 2, (1, 2, 6, 6, 64), 128),       # a strided projection
    ((1, 3, 3), 1, (1, 2, 14, 14, 64), 64),      # 392 rows: 4 row tiles
])
def test_mirror_of_the_tile_plan_is_the_exact_conv(kind, stride, shape, co):
    rng = np.random.RandomState(5)
    x, w = _i8(rng, *shape), _i8(rng, co, *kind, shape[-1])
    want = qc.qconv_acc(torch.from_numpy(x), torch.from_numpy(w), stride)
    got = emulate_acc(x, w, stride, 128 if co % 128 == 0 else 64)
    np.testing.assert_array_equal(got, want.numpy())


def _bf16(v):
    """np.float32 -> nearest bf16 (ties to even), as np.float32."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def emulate_epilogue(acc, scale, shift, dtype, mode, s_out, residual,
                     s_res):
    """The kernel's epilogue in numpy f32, element by element as its
    threads run it: rnd(f32(acc)); rnd(u * scale); rnd(u + shift); the
    residual added (an int8 one times rnd(max(s_res, 1e-12)) first), each
    rounded once; ReLU; rint(u / max(s_out, 1e-12)) clamped to 127."""
    rnd = _bf16 if dtype == "bfloat16" else (lambda v: np.float32(v))
    u = rnd(acc.astype(np.float32))
    u = rnd(u * scale)
    v = rnd(u + shift)
    if mode == qc.MODE_DEQ:
        return v
    if mode == qc.MODE_RES:
        v = rnd(v + residual)
    elif mode == qc.MODE_RES_Q:
        rs = rnd(np.maximum(np.float32(s_res), np.float32(1e-12)))
        v = rnd(v + rnd(residual.astype(np.float32) * rs))
    so = np.maximum(np.float32(s_out), np.float32(1e-12))
    q = np.rint(np.maximum(v, np.float32(0)) / so)
    return np.clip(q, -127, 127).astype(np.int8)


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
        acc = emulate_acc(x, wk, stride, 128 if co % 128 == 0 else 64)
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

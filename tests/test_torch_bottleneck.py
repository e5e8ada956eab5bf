"""The port's fused bottleneck (shgvqa_tpu_torch/kernels/bottleneck.py)
against the JAX Pallas prototype it replaces (tools/proto_block_kernel.py,
interpret mode on the CPU, and its XLA reference), and the switched slow_r50
trunk against the JAX trunk.  The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against ``bottleneck_reference`` there); on the CPU
the wrapper takes the plain version, which is what these tests hold.

What the kernel's plan decides is held through Python mirrors of
``csrc/bottleneck.cu`` (its constants read from the source, and the
span choice, the shared-memory layout and conv_c's fragment packing held
to the source's own expressions): the spans and passes cover every
output once, conv_b's taps read the shifted position or the zero row,
ldmatrix gives the register-A fragments of wgmma, the stage's boxes meet
the descriptors and the TMA store; and the plan emulated in numpy
against ``bottleneck_reference``.

Tolerances: f32 1e-5 against the XLA reference (the prototype's kernel
rounds its intermediates to bf16 whatever its input, so it is compared in
bf16); bf16 2e-2 of max |ref| (the prototype's own check,
proto_block_kernel.py:218, :228); the trunk 1e-4 (as
tests/test_torch_backbone.py)."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu_torch.kernels import bottleneck
from shgvqa_tpu_torch.models import backbone
from shgvqa_tpu_torch.models.backbone import SlowR50, set_block_kernel
from shgvqa_tpu_torch.models.layers import init_weights
from test_torch_common import (
    close,
    desc_address,
    jax_variables,
    load_port,
    t,
    tma_offset,
    wgmma_desc,
)

REPO = Path(__file__).resolve().parent.parent
# the flagship trunk's topology (depths, temporal kernels) at toy widths
TOY_DEEP = dict(stem_width=8, mids=(8, 8, 8, 8), outs=(16, 16, 16, 16),
                depths=(3, 4, 6, 3))


def _proto():
    spec = importlib.util.spec_from_file_location(
        "proto_block_kernel", REPO / "tools" / "proto_block_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(ci, cm, co, proj, seed):
    """numpy f32 operands in the prototype's layouts: x (N, 8, 8, Ci), wa
    (Ci, Cm), wb (3, 3, Cm, Cm), wc (Cm, Co), wp (Ci, Co); BN vectors."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=0.1):
        return rng.randn(*shape).astype(np.float32) * scale

    args = [np.abs(f(4, 8, 8, ci, scale=1.0)), f(ci, cm, scale=0.3),
            1.0 + f(cm), f(cm), f(3, 3, cm, cm, scale=0.2), 1.0 + f(cm),
            f(cm), f(cm, co, scale=0.3), 1.0 + f(co), f(co)]
    pr = (f(ci, co, scale=0.3), 1.0 + f(co), f(co)) if proj else None
    return args, pr


def _port_args(args, pr, dtype):
    """The prototype's operands in the port's layouts, as torch ``dtype``."""
    x, wa, sa, ba, wb, sb, bb, wc, sc, bc = args
    ours = [x, wa.T, sa, ba, wb.transpose(3, 2, 0, 1), sb, bb, wc.T, sc, bc]
    ours = [t(np.ascontiguousarray(a), dtype) for a in ours]
    if pr is not None:
        pr = (t(np.ascontiguousarray(pr[0].T), dtype), t(pr[1], dtype),
              t(pr[2], dtype))
    return ours, pr


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("proj", [False, True])
def test_plain_version_matches_xla_reference_f32(proj):
    proto = _proto()
    args, pr = _data(16 if proj else 32, 16, 32, proj, seed=proj)
    want = proto._xla_reference(
        *map(jnp.asarray, args),
        proj=None if pr is None else tuple(map(jnp.asarray, pr)))
    ours, opr = _port_args(args, pr, torch.float32)
    got = bottleneck.bottleneck_reference(*ours, opr)
    assert got.shape == (4, 8, 8, 32) and got.dtype == torch.float32
    close(got, want, 1e-5)


@pytest.mark.parametrize("proj", [False, True])
def test_plain_version_matches_prototype_bf16(proj):
    proto = _proto()
    args, pr = _data(16 if proj else 32, 16, 32, proj, seed=2 + proj)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jpr = None if pr is None else tuple(jnp.asarray(a, jnp.bfloat16)
                                        for a in pr)
    ours, opr = _port_args(args, pr, torch.bfloat16)
    got = bottleneck.bottleneck_reference(*ours, opr)
    assert got.dtype == torch.bfloat16
    want = proto.fused_bottleneck(*jargs, proj=jpr, interpret=True)
    assert _rel_err(got.float(), want) <= 2e-2
    assert _rel_err(got.float(),
                    proto._xla_reference(*jargs, proj=jpr)) <= 2e-2
    # on the CPU the wrapper takes the plain version
    close(bottleneck.fused_bottleneck(*ours, opr), got.float(), 0.0)


@pytest.mark.parametrize("t_len,hw", [(4, 32), (2, 40)])
def test_trunk_with_the_block_switch_matches_jax(t_len, hw):
    x = np.random.RandomState(5).randn(2, t_len, hw, hw, 3).astype(np.float32)
    mod = JaxSlowR50(dtype=jnp.float32, **TOY_DEEP)
    v = jax_variables(mod, x)
    port = load_port(SlowR50(torch.float32, **TOY_DEEP), v)
    set_block_kernel(port, True)
    with torch.no_grad():
        got = port(t(x))
    want = np.asarray(mod.apply(v, x))
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-4


def test_switch_reaches_exactly_the_six_eligible_blocks(monkeypatch):
    """res_2 blocks 0-2 and res_3 blocks 1-3 take the kernel route; res_3
    block_0 (stride 2) and res_4/res_5 (temporal kernel 3) do not.  In bf16
    the route gives the unfused blocks' output exactly: the plain version
    rounds where the convs and the frozen BN do."""
    calls = []

    def counted(x, *args):
        calls.append(tuple(x.shape))
        return bottleneck.fused_bottleneck(x, *args)

    monkeypatch.setattr(backbone, "fused_bottleneck", counted)
    trunk = init_weights(SlowR50(torch.bfloat16, **TOY_DEEP)).eval()
    x = torch.randn(2, 4, 32, 32, 3)
    with torch.no_grad():
        want = trunk(x)
        assert calls == []
        set_block_kernel(trunk, True)
        got = trunk(x)
    eligible = [f"res_{s}.block_{i}" for s, i in
                ((2, 0), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3))]
    assert sorted(name for name, m in trunk.named_modules()
                  if isinstance(m, backbone.Bottleneck3D)
                  and m.temporal_kernel == 1 and m.spatial_stride == 1
                  ) == eligible
    assert calls == [(8, 8, 8, 8)] + [(8, 8, 8, 16)] * 2 + [(8, 4, 4, 16)] * 3
    assert sum(isinstance(m, backbone.Bottleneck3D)
               for m in trunk.modules()) == 16
    close(got.float(), want.float(), 0.0)


def test_wrapper_raises_on_bad_shapes_dtypes_and_grad():
    args, pr = _data(32, 16, 32, False, seed=7)
    ours, _ = _port_args(args, pr, torch.float32)
    with pytest.raises(ValueError, match="wb must have shape"):
        bottleneck.fused_bottleneck(*ours[:4], ours[4][:, :8], *ours[5:])
    with pytest.raises(ValueError, match="without a projection"):
        bottleneck.fused_bottleneck(ours[0][..., :16], *ours[1:])
    with pytest.raises(ValueError, match=r"sc must have shape \(32,\)"):
        bottleneck.fused_bottleneck(*ours[:8], ours[8][:16], ours[9])
    with pytest.raises(RuntimeError, match="forward only"):
        bottleneck.fused_bottleneck(ours[0].requires_grad_(True), *ours[1:])
    ours[0].requires_grad_(False)

    # the card's checks, reached before any launch on a device that is not
    # the CPU
    def meta(args, dtype):
        return [a.to(device="meta", dtype=dtype) for a in args]

    with pytest.raises(NotImplementedError, match="bfloat16"):
        bottleneck.fused_bottleneck(*meta(ours, torch.float32))
    with pytest.raises(ValueError, match="Cm=16 must be 64 or 128"):
        bottleneck.fused_bottleneck(*meta(ours, torch.bfloat16))
    wide, _ = _port_args(*_data(128, 64, 128, False, seed=8), torch.float32)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        bottleneck.fused_bottleneck(*meta(wide, torch.bfloat16))


# ---------------------------------------------------------------------------
# Mirrors of the kernel's plan (shgvqa_tpu_torch/csrc/bottleneck.cu): its
# constants are read from the source

CU = (REPO / "shgvqa_tpu_torch" / "csrc" / "bottleneck.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


STAGES, PASS, NC, BK = _const("kStages"), _const("kPass"), _const("kNC"), \
    _const("kBK")
SMEM_LIMIT = _const("kSmemLimit")
X_BYTES = PASS * BK * 2
STAGE_BYTES = X_BYTES + int(re.search(
    r"kStageBytes = kXBytes \+ (\d+) \* kBK \* 2", CU).group(1)) * BK * 2
SMS = 132                                        # an H100 SXM's SMs
# (frames, H = W, Ci, Cm, Co, projection): the trunk's three geometries at
# B=2 and B=32 (16 frames a clip), and the ragged shapes chip_smoke checks
GEOMETRIES = [(16 * b, 56, 64, 64, 256, True) for b in (2, 32)] \
    + [(16 * b, 56, 256, 64, 256, False) for b in (2, 32)] \
    + [(16 * b, 28, 512, 128, 512, False) for b in (2, 32)] \
    + [(3, 30, 64, 64, 256, False), (3, 13, 512, 128, 512, False)]


def _smem(span, w, cm, co):
    """Layout(span, w, cm, co).total + the 1 KB of alignment slack."""
    a = STAGES * STAGE_BYTES
    bn = a + (span + 2 * w + 3) * cm * 2
    bars = -(-(bn + (4 * cm + 4 * co) * 2) // 8) * 8
    return bars + 16 * STAGES + 1024


def _choose_span(total, w, cm, co, sms=SMS):
    best, best_cost = 0, 0.0
    span = 64
    while span <= total + 63 and _smem(span, w, cm, co) <= SMEM_LIMIT:
        rounds = -(-(-(-total // span)) // sms)
        cost = rounds * (span + 0.25 * (2 * w + 2))
        if best == 0 or cost < best_cost:
            best, best_cost = span, cost
        span += 64
    return best


def _source_layout_total(span, w, cm, co):
    """``Layout(span, w, cm, co).total`` evaluated from the source's own
    expressions."""
    body = re.search(r"Layout\(int span, int w, int cm, int co\) \{(.*?)\n  \}",
                     CU, re.S).group(1)
    env = dict(span=span, w=w, cm=cm, co=co, kStages=STAGES,
               kStageBytes=STAGE_BYTES)
    for name, expr in re.findall(r"(\w+) = ([^;]+);", body):
        env[name] = _c_eval(expr, env)
    return env["total"]


def _source_choose_span(total, w, cm, co, sms=SMS):
    """``choose_span`` evaluated from the source's own loop bounds, shared
    memory test and cost expressions."""
    body = re.search(r"int choose_span\(int total, int w, int cm, int co, "
                     r"int sms\) \{(.*?)\n\}", CU, re.S).group(1)
    start, reach, step = map(int, re.search(
        r"for \(int span = (\d+); span <= total \+ (\d+); span \+= (\d+)\)",
        body).groups())
    slack = int(re.search(r"Layout\(span, w, cm, co\)\.total \+ (\d+) > "
                          r"static_cast<size_t>\(kSmemLimit\)\) break;",
                          body).group(1))
    exprs = [re.search(rf"const (?:int|double) {name} = ([^;]+);", body).group(1)
             for name in ("items", "rounds", "cost")]
    assert "if (best == 0 || cost < best_cost)" in body
    best, best_cost = 0, 0.0
    span = start
    while span <= total + reach:
        if _source_layout_total(span, w, cm, co) + slack > SMEM_LIMIT:
            break
        env = dict(total=total, span=span, w=w, sms=sms)
        for name, expr in zip(("items", "rounds", "cost"), exprs):
            env[name] = _c_eval(expr, env)
        if best == 0 or env["cost"] < best_cost:
            best, best_cost = span, env["cost"]
        span += step
    return best


@pytest.mark.parametrize("cm,co", [(64, 256), (128, 512)])
def test_span_choice_and_layout_mirror_the_source(cm, co):
    """The plan's mirrors ``_smem`` and ``_choose_span`` agree with
    ``Layout`` and ``choose_span`` as the source writes them, at the
    trunk's geometries and over a sweep of position counts and widths."""
    for span in range(64, 2049, 64):
        for w in (7, 13, 28, 30, 56):
            assert _smem(span, w, cm, co) \
                == _source_layout_total(span, w, cm, co) + 1024
    totals = sorted({n * hw * hw for n, hw, _, c, _, _ in GEOMETRIES if c == cm}
                    | {64, 100, 4096, 8191, 50_000, 123_457})
    for total in totals:
        for w in (13, 28, 30, 56):
            for sms in (SMS, 7):
                assert _choose_span(total, w, cm, co, sms) \
                    == _source_choose_span(total, w, cm, co, sms)


def _plan(n, hw, cm, co, sms=SMS):
    total = n * hw * hw
    span = _choose_span(total, hw, cm, co, sms)
    items = [(q0, min(span, total - q0)) for q0 in range(0, total, span)]
    return total, span, items


def _tap_rows(m, q0, n_out, hw, span):
    """The a-tile row each lane of output m (of an item at q0 with n_out
    outputs) reads for each of the 9 taps, as conv_b's addressing computes
    it: the window row of the shifted position, or the zero row."""
    zero_row = span + 2 * hw + 2
    f = (q0 + m) % (hw * hw)
    fh = np.where(m < n_out, f // hw, -2)
    fw = np.where(m < n_out, f % hw, 0)
    rows = []
    for tap in range(9):
        dr, dc = tap // 3 - 1, tap % 3 - 1
        inside = (fh + dr >= 0) & (fh + dr < hw) & (fw + dc >= 0) \
            & (fw + dc < hw)
        rows.append(np.where(inside, m + (dr + 1) * hw + dc + 1, zero_row))
    return np.stack(rows, 1)


@pytest.mark.parametrize("n,hw,ci,cm,co,proj", GEOMETRIES)
def test_span_plan_writes_every_output_once(n, hw, ci, cm, co, proj):
    """The spans cover the N*H*W positions once; each span's passes of 128
    (64 a warpgroup) store each output position once per 64-channel chunk,
    and a warpgroup's 64-row TMA store never reaches into the next item;
    the a tile (window and zero row) fits in shared memory."""
    total, span, items = _plan(n, hw, cm, co)
    assert span >= 64 and span % 64 == 0 and co % NC == 0 and ci % BK == 0
    assert _smem(span, hw, cm, co) <= SMEM_LIMIT
    stored = np.zeros(total, np.int64)
    for q0, n_out in items:
        for o0 in range(0, n_out, PASS):
            for wg in range(2):
                m0 = o0 + 64 * wg
                if m0 >= n_out:
                    continue                  # the warpgroup sits the pass out
                rows = np.arange(q0 + m0, q0 + m0 + 64)
                # the TMA store clips rows past the tensor: the rest are
                # this item's
                assert ((rows < q0 + n_out) | (rows >= total)).all()
                stored[rows[rows < total]] += 1
    assert (stored == 1).all()
    # the window rows conv_a computes and the zero row fit the a tile
    cap = span + 2 * hw + 3
    assert all(n_out + 2 * hw + 2 < cap for _, n_out in items)


@pytest.mark.parametrize("n,hw,ci,cm,co,proj", GEOMETRIES)
def test_taps_read_the_shifted_position_or_zeros(n, hw, ci, cm, co, proj):
    """conv_b's 9 taps of every output position read the a-tile row of the
    shifted position when it lies in the frame (a window row that conv_a
    computed, position w0 + row) and the zero row otherwise: the frame's
    edges, its first and last rows (the halo rows outside the frame), and
    the rows past the item."""
    total, span, items = _plan(n, hw, cm, co)
    zero_row = span + 2 * hw + 2
    for q0, n_out in (items[0], items[len(items) // 2], items[-1]):
        win, w0 = n_out + 2 * hw + 2, q0 - hw - 1
        m = np.arange(-(-n_out // 64) * 64)       # the warpgroups' rows
        rows = _tap_rows(m, q0, n_out, hw, span)
        pos = q0 + m
        fh, fw = (pos % (hw * hw)) // hw, pos % hw
        for tap in range(9):
            dr, dc = tap // 3 - 1, tap % 3 - 1
            inside = ((m < n_out) & (fh + dr >= 0) & (fh + dr < hw)
                      & (fw + dc >= 0) & (fw + dc < hw))
            got = rows[:, tap]
            assert (got[~inside] == zero_row).all()
            assert (got[inside] < win).all()
            assert (w0 + got[inside] == pos[inside] + dr * hw + dc).all()
            assert ((w0 + got[inside] >= 0) & (w0 + got[inside] < total)).all()


def _c_eval(expr, env):
    """A C integer expression of the kernel source, evaluated in Python on
    non-negative operands (``/`` is integer division there)."""
    expr = re.sub(r"static_cast<\w+>", "", expr).replace("/", "//")
    return eval(expr, {}, dict(env))


def _wgmma_d(reg, g, q):
    """(row, column) of f32 accumulator register ``reg`` of wgmma's m64nNk16
    D fragment within a warp's 16 rows, for thread 4 g + q: the 8-column
    block reg / 4, row g or g + 8 by (reg / 2) % 2, column 2 q + reg % 2."""
    return g + 8 * ((reg // 2) % 2), 8 * (reg // 4) + 2 * q + reg % 2


# conv_c's register-A fragment from conv_b's accumulators: j and hh of
# (s, i), the two accumulator registers of the bf16 pair, the BN column
_BFRAG_PACKING = re.search(
    r"const int j = ([^,;]+), hh = ([^;]+);\s*bfrag\[s\]\[i\] = "
    r"relu_bf16x2\(bn2\(acc\[([^\]]+)\], acc\[([^\]]+)\], sb, bb,\s*"
    r"([^)]+)\)\);", CU).groups()


def _ldmatrix_elements(cm, warp, kc, kk, rows):
    """conv_b_stage's ldmatrix.x4 for one warp and k16 slice: lane l gives
    the address of a-tile row rows[16 warp + l % 16], 16-byte chunk
    8 kc + 2 kk + l / 16, swizzled; matrix i is lanes 8 i..8 i + 7, and
    thread t takes elements (t / 4, 2 (t % 4) + e) of each.  Returns
    (a-tile row, channel) of register i, element e of each thread, decoded
    through the conv_a epilogue's write map."""
    row_bytes = cm * 2
    lane = np.arange(32)
    row = rows[16 * warp + lane % 16]
    chunk = 8 * kc + 2 * kk + lane // 16
    addr = row * row_bytes + ((chunk ^ (row & 7)) << 4)
    t = np.arange(32)[:, None, None]
    i = np.arange(4)[None, :, None]
    e = np.arange(2)[None, None, :]
    src = addr[8 * i + t // 4] + 4 * (t % 4) + 2 * e      # byte read
    r = src // row_bytes
    c_sw = (src % row_bytes) >> 4
    chunk_of = c_sw ^ (r & 7)                              # unswizzled chunk
    return r, 8 * chunk_of + (src % 16) // 2


@pytest.mark.parametrize("cm", [64, 128])
def test_register_a_fragments_hold_the_taps_channels(cm):
    """For each tap and k16 slice, the registers ldmatrix gives each thread
    are the A fragment of wgmma (m16n8k16's: register i holds row g + 8 (i
    % 2), k 16 s + 8 (i / 2) + 2 q + e) of the tap-shifted rows' channels;
    and conv_b's accumulator pairs, as packed for conv_c, are the same
    fragment of its output."""
    hw, span = 13, 64
    rng = np.random.RandomState(cm)
    m = np.arange(64)
    rows = _tap_rows(m, 0, 40, hw, span)
    t = np.arange(32)[:, None, None]
    i = np.arange(4)[None, :, None]
    e = np.arange(2)[None, None, :]
    g, q = t // 4, t % 4
    for tap in rng.choice(9, 3, replace=False):
        for warp in range(4):
            for kc in range(cm // BK):
                for kk in range(BK // 16):
                    s = 4 * kc + kk
                    r, ch = _ldmatrix_elements(cm, warp, kc, kk, rows[:, tap])
                    want_row = rows[16 * warp + g + 8 * (i % 2), tap]
                    want_ch = 16 * s + 8 * (i // 2) + 2 * q + e
                    assert (r == want_row).all() and (ch == want_ch).all()
    # conv_b's accumulator registers as the source packs them into conv_c's
    # bfrag[s][i], placed by wgmma's accumulator layout
    j_of, hh_of, lo, hi, bn_col = _BFRAG_PACKING
    for s in range(cm // 16):
        env = dict(s=s, i=i, qd=2 * q)
        env.update(j=_c_eval(j_of, env), hh=_c_eval(hh_of, env))
        for e_reg, reg in enumerate((_c_eval(lo, env), _c_eval(hi, env))):
            acc_row, acc_col = _wgmma_d(reg, g, q)
            assert (acc_row == g + 8 * (i % 2)).all()
            assert (acc_col == 16 * s + 8 * (i // 2) + 2 * q + e_reg).all()
        # the BN column the pair is scaled with is the pair's first column
        assert (_c_eval(bn_col, env) == 16 * s + 8 * (i // 2) + 2 * q).all()


def test_stage_boxes_and_descriptors():
    """A stage's x box (128 rows of 64 channels, landed by TMA with the
    128-byte swizzle): each warpgroup's conv_a / projection descriptors
    read its 64 rows; the conv_c epilogue's address of (row, column) is
    where the TMA put the residual; and a warpgroup's y store (a 64-row box
    from 8 KB in) reads the y the epilogue wrote there.  The weight tile
    after 16 KB: N rows of 64 channels, 8-row groups 1 KB apart."""
    row = np.arange(PASS)[:, None]
    col = np.arange(64)[None, :]
    epilogue = row * 128 + (((col // 8) ^ (row & 7)) << 4) + 2 * (col % 8)
    assert (epilogue == tma_offset(row, col)).all()
    for wg in range(2):
        r = np.arange(64)[:, None]
        assert (wg * 8192 + tma_offset(r, col)
                == epilogue[64 * wg + r, col]).all()
        for kk in range(BK // 16):
            k = np.arange(16)[None, :]
            desc = wgmma_desc(wg * 64 * 128 + 32 * kk, 16, 1024)
            assert (desc_address(desc, r, k, False)
                    == tma_offset(64 * wg + r, 16 * kk + k)).all()
    n = np.arange(128)[:, None]
    for kk in range(BK // 16):
        k = np.arange(16)[None, :]
        desc = wgmma_desc(X_BYTES + 32 * kk, 16, 1024)
        want = X_BYTES + (n // 64) * 8192 + tma_offset(n % 64, 16 * kk + k)
        assert (desc_address(desc, n, k, False) == want).all()
    assert STAGE_BYTES >= X_BYTES + 128 * BK * 2 and X_BYTES % 1024 == 0


def _emulate(x, wa, sa, ba, wb, sb, bb, wc, sc, bc, proj, sms):
    """The kernel's plan in f32 numpy: per span, conv_a on its window (x
    rows past the tensor read as zeros), the a tile with its zero row,
    conv_b by the taps' row addressing, conv_c, the residual and the ReLU;
    no rounding."""
    n, hw, _, ci = x.shape
    cm, co = wa.shape[0], wc.shape[0]
    total, span, items = _plan(n, hw, cm, co, sms)
    flat = x.reshape(total, ci)
    y = np.zeros((total, co), np.float32)
    for q0, n_out in items:
        win, w0 = n_out + 2 * hw + 2, q0 - hw - 1
        p = np.arange(w0, w0 + win)
        xw = np.where(((p >= 0) & (p < total))[:, None],
                      flat[np.clip(p, 0, total - 1)], 0.0)
        a_tile = np.zeros((span + 2 * hw + 3, cm), np.float32)
        a_tile[:win] = np.maximum(xw @ wa.T * sa + ba, 0.0)
        m = np.arange(n_out)
        rows = _tap_rows(m, q0, n_out, hw, span)
        acc = sum(a_tile[rows[:, tap]] @ wb[:, :, tap // 3, tap % 3].T
                  for tap in range(9))
        b = np.maximum(acc * sb + bb, 0.0)
        c = b @ wc.T * sc + bc
        xs = flat[q0 + m]
        r = xs if proj is None else xs @ proj[0].T * proj[1] + proj[2]
        y[q0 + m] = np.maximum(c + r, 0.0)
    return y.reshape(n, hw, hw, co)


@pytest.mark.parametrize("proj", [False, True])
def test_plan_in_numpy_matches_the_plain_version(proj):
    """The plan emulated in f32 (spans over 3 ragged 13x13 frames, 4 SMs so
    that there are several spans and a short last one) against
    bottleneck_reference."""
    rng = np.random.RandomState(11 + proj)
    ci, cm, co = (64, 64, 128) if proj else (128, 64, 128)

    def f(*shape, scale=0.1):
        return rng.randn(*shape).astype(np.float32) * scale

    x = np.abs(f(3, 13, 13, ci, scale=1.0))
    args = [x, f(cm, ci, scale=0.2), 1.0 + f(cm), f(cm),
            f(cm, cm, 3, 3, scale=0.05), 1.0 + f(cm), f(cm),
            f(co, cm, scale=0.2), 1.0 + f(co), f(co)]
    pr = (f(co, ci, scale=0.2), 1.0 + f(co), f(co)) if proj else None
    total, span, items = _plan(3, 13, cm, co, sms=4)
    assert len(items) > 2 and items[-1][1] < span
    got = _emulate(*args, pr, sms=4)
    want = bottleneck.bottleneck_reference(
        *[t(a) for a in args], None if pr is None else tuple(map(t, pr)))
    close(want, got, 1e-5)

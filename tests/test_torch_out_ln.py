"""The port's attention-output block (``kernels/ffn.py`` ``fused_out_ln``,
``out_ln_reference``) against the JAX ``fused_out_ln`` it replaces (the
Pallas kernel ``_make_out_ln`` in interpret mode on the CPU), its gradients
against ``jax.grad`` of the JAX custom VJP, and the switched ``AttOutput``
(``set_out_ln_kernel``) against the JAX ``AttOutput`` and the port's
unswitched block.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against ``out_ln_reference`` there); on the CPU
the wrapper takes the plain version, which is what these tests hold.

The kernel's design is held here by mirrors: its launch plan (cluster
size and slab from D, rows per tile from M and the SMs; constants read
from ``csrc/out_ln.cu``) covering every (row, column) once, a numpy
emulation of its epilogue's order of sums (quad partials, slab partials in
rank order through the cluster, the two-pass variance), and the wrapper's
card path through a stand-in for its C entry.

Tolerances: f32 1e-5; bf16 3e-2 (the JAX package's FFN-kernel tolerance,
tests/test_pallas_ffn.py:41-43); gradients 1e-4 (tests/test_pallas_ffn.py
:218-241); the module 1e-4 (as the other layers)."""

import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import ffn as jax_ffn
from shgvqa_tpu.models import layers as jlayers
from shgvqa_tpu_torch.kernels import ffn
from shgvqa_tpu_torch.kernels.ffn import fused_out_ln, out_ln_reference
from shgvqa_tpu_torch.models import layers
from test_torch_common import close, jax_variables, load_port, t, tensor_at

CSRC = Path(__file__).resolve().parent.parent / "shgvqa_tpu_torch" / "csrc"


def _data(m, d, seed=0):
    """numpy f32 x, w (in, out) as the JAX kernel takes it, b, residual,
    gamma, beta."""
    rng = np.random.RandomState(seed)
    return (rng.randn(m, d).astype(np.float32),
            (rng.randn(d, d) * 0.1).astype(np.float32),
            (rng.randn(d) * 0.1).astype(np.float32),
            rng.randn(m, d).astype(np.float32),
            (1.0 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32))


def _port_args(x, w, b, res, gamma, beta, dtype=torch.float32):
    """The port's operands: x, residual and W (nn.Linear layout (out, in))
    in ``dtype``, the vectors f32."""
    return (t(x, dtype), t(np.ascontiguousarray(w.T), dtype), t(b),
            t(res, dtype), t(gamma), t(beta))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(37, 32), (37, 64), (600, 32), (600, 64)])
def test_reference_matches_jax_kernel_interpret(m, d, dtype):
    """Rows ragged across the JAX kernel's 512-row tile."""
    x, w, b, res, gamma, beta = _data(m, d, seed=m + d)
    jdt = jnp.dtype(dtype)
    want = jax_ffn.fused_out_ln(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b),
        jnp.asarray(res, jdt), jnp.asarray(gamma), jnp.asarray(beta),
        interpret=True)
    tdt = getattr(torch, dtype)
    args = _port_args(x, w, b, res, gamma, beta, tdt)
    got = out_ln_reference(*args)
    assert got.dtype == tdt
    close(got, np.asarray(want, np.float32),
          1e-5 if dtype == "float32" else 3e-2)
    # the public wrapper takes the plain version on the CPU
    close(fused_out_ln(*args), np.asarray(got.float()), 0.0)


def test_gradients_match_jax_custom_vjp():
    x, w, b, res, gamma, beta = _data(16, 32, seed=8)
    jargs = [jnp.asarray(a) for a in (x, w, b, res, gamma, beta)]

    def loss(*a):
        return jnp.sum(jax_ffn.fused_out_ln(*a, interpret=True) ** 2)

    want = jax.grad(loss, argnums=tuple(range(6)))(*jargs)
    args = [a.requires_grad_(True) for a in _port_args(
        x, w, b, res, gamma, beta)]
    got = torch.autograd.grad((fused_out_ln(*args) ** 2).sum(), args)
    # the port's W is (out, in): its gradient is the transpose of JAX's
    for i, (g, jg) in enumerate(zip(got, want)):
        jg = np.asarray(jg)
        close(g, jg.T if i == 1 else jg, 1e-4)


def test_att_output_switch_matches_jax_and_the_unswitched_block():
    rng = np.random.RandomState(3)
    hidden = rng.randn(2, 9, 32).astype(np.float32)
    residual = rng.randn(2, 9, 32).astype(np.float32)
    jmod = jlayers.AttOutput(dropout=0.1)
    v = jax_variables(jmod, hidden, residual, deterministic=True)
    want = jmod.apply(v, hidden, residual, deterministic=True)
    port = load_port(layers.AttOutput(32), v)
    with torch.no_grad():
        plain = port(t(hidden), t(residual))
        layers.set_out_ln_kernel(port, True)
        assert port.use_kernel
        got = port(t(hidden), t(residual))
    close(got, want, 1e-4)
    close(got, np.asarray(plain), 1e-6)


def test_att_output_switch_routes_only_outside_training(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fused_out_ln(*args, **kw)

    monkeypatch.setattr(layers, "fused_out_ln", counted)
    model = layers.init_weights(layers.SelfAttLayer(32, 4, 8), 0)
    layers.set_out_ln_kernel(model, True)
    x = torch.randn(2, 5, 32)
    with torch.no_grad():
        model.eval()(x)
        assert calls == [(2, 5, 32)]
        model.train()(x)
    assert len(calls) == 1
    layers.set_out_ln_kernel(model, False)
    with torch.no_grad():
        model.eval()(x)
    assert len(calls) == 1


def _meta(*ts, dtype=None):
    return [a.to(device="meta", dtype=dtype or a.dtype) for a in ts]


def test_wrapper_raises_on_bad_shapes_dtypes_and_devices():
    x, w, b, res, gamma, beta = _port_args(*_data(8, 64))
    with pytest.raises(ValueError, match="residual"):
        fused_out_ln(x, w, b, res[:4], gamma, beta)

    # the card's checks, reached before any launch on a device that is not
    # the CPU
    bf16 = torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fused_out_ln(*_meta(x, w, b, res, gamma, beta))
    xs, ws, rs = _meta(x[:, :24], w[:24, :24], res[:, :24], dtype=bf16)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_out_ln(xs, ws, b[:24], rs, gamma[:24], beta[:24])
    xm, wm, rm = _meta(x, w, res, dtype=bf16)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        fused_out_ln(xm, wm, b, rm, gamma, beta)


# ---------------------------------------------------------------------------
# Mirrors of csrc/out_ln.cu

def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_constants_are_the_kernels():
    src, hdr = ((CSRC / n).read_text() for n in ("out_ln.cu",
                                                 "wgmma_gemm.cuh"))
    assert (_constant(src, "kMaxCluster"), _constant(src, "kMaxSlab"),
            _constant(hdr, "kGemmBM"), _constant(src, "kNarrowRows")) == (
        ffn.OUT_LN_MAX_CLUSTER, ffn.OUT_LN_MAX_SLAB) + ffn.OUT_LN_ROWS
    assert "constexpr int kMaxD = kMaxCluster * kMaxSlab;" in src
    # the kernel's cluster launch and its exchange through distributed
    # shared memory
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "mapa.shared::cluster.u32" in src
    assert "ld.shared::cluster.f32" in src
    assert not re.search(r"\b(atom|red)\.|atomic[A-Z]", src)   # no atomics


# (D, cluster): every multiple of 64 up to 768, and the widths the kernel
# does not take
WIDTHS = [(64, 1), (128, 2), (192, 3), (256, 4), (320, None), (384, 3),
          (448, None), (512, 4), (576, 3), (640, None), (704, None),
          (768, 4), (32, None), (96, None), (832, None), (0, None)]


@pytest.mark.parametrize("d,cluster", WIDTHS)
def test_cluster_of_each_width(d, cluster):
    assert ffn.out_ln_cluster(d) == cluster
    if cluster is not None:
        slab = d // cluster
        assert slab % 64 == 0 and slab <= ffn.OUT_LN_MAX_SLAB


SMS = 132   # the H100 SXM's SMs
# (M, D, the plan at 132 SMs): the AttOutput sites (M = B * L, L in 40,
# 393, 177, B in 2 and 32) and ragged ones
PLANS = [(80, 768, (4, 192, 64, 2)), (786, 768, (4, 192, 64, 13)),
         (354, 768, (4, 192, 64, 6)), (1280, 768, (4, 192, 64, 20)),
         (12576, 768, (4, 192, 128, 99)), (5664, 768, (4, 192, 64, 89)),
         (1, 768, (4, 192, 64, 1)), (65, 768, (4, 192, 64, 2)),
         (12577, 768, (4, 192, 128, 99)), (4097, 768, (4, 192, 128, 33)),
         (64, 128, (2, 64, 64, 1)), (300, 256, (4, 64, 64, 5)),
         (130, 512, (4, 128, 64, 3)), (90, 576, (3, 192, 64, 2)),
         (100, 64, (1, 64, 64, 2))]


def _covered(m, d, plan):
    """How often the CTAs of ``plan`` write each (row, column) of (M, D):
    CTA (rank r, row tile i) writes rows i*rows.. below M, columns
    r*slab.."""
    cluster, slab, rows, tiles = plan
    hits = np.zeros((m, d), np.int32)
    for i in range(tiles):
        for r in range(cluster):
            hits[i * rows:min(m, (i + 1) * rows), r * slab:(r + 1) * slab] += 1
    return hits


@pytest.mark.parametrize("m,d,want", PLANS)
def test_plan_covers_every_row_and_column_once(m, d, want):
    plan = ffn.out_ln_plan(m, d, SMS)
    assert plan == want
    cluster, slab, rows, tiles = plan
    assert cluster * slab == d and cluster <= ffn.OUT_LN_MAX_CLUSTER
    assert rows in ffn.OUT_LN_ROWS and tiles == -(-m // rows) <= 65535
    # the grid (cluster, tiles) is whole clusters: one a row tile
    assert (cluster * tiles) % cluster == 0
    assert (_covered(m, d, plan) == 1).all()


def test_plan_takes_128_rows_only_where_they_fill_the_waves():
    # 3 whole waves of 132 at M = 12576; 180 CTAs (2 waves, 68% full) at
    # M = 5664 take 64-row tiles; under a wave always 64
    for m, rows in ((12576, 128), (5664, 64), (16896, 128), (100, 64)):
        assert ffn.out_ln_plan(m, 768, SMS)[2] == rows
    with pytest.raises(ValueError, match="no plan"):
        ffn.out_ln_plan(10, 320, SMS)


def _emulate(x, w, b, res, gamma, beta, eps, sms=SMS):
    """numpy f32 emulation of the kernel on (M, D): each CTA's f32 product
    of its slab, r = (acc + b) + residual, each quad thread's sum of its
    columns (8 j + 2 q + e, in order of j then e), the quad's two shfl_xor,
    the slab partials summed over the cluster in rank order, the same for
    the sums of (r - mean)^2, then y."""
    m, d = x.shape
    cluster, slab, _, _ = ffn.out_ln_plan(m, d, sms)
    f32 = np.float32
    r = (x.astype(f32) @ w.astype(f32).T + b).astype(f32) + res
    inv_d = f32(1.0) / f32(d)

    def row_sums(v):
        total = np.zeros(m, f32)
        for k in range(cluster):
            lane = np.zeros((m, 4), f32)
            for j in range(slab // 8):
                for e in range(2):
                    cols = k * slab + 8 * j + 2 * np.arange(4) + e
                    lane += v[:, cols]
            quad = lane[:, 0] + lane[:, 1]          # xor 1 ...
            quad = quad + (lane[:, 2] + lane[:, 3])   # ... then xor 2
            total = total + quad                    # rank order
        return total

    mean = row_sums(r) * inv_d
    dev = r - mean[:, None]
    var = row_sums(dev * dev) * inv_d
    rstd = (f32(1.0) / np.sqrt(var + f32(eps))).astype(f32)
    return (dev * rstd[:, None] * gamma + beta).astype(f32)


@pytest.mark.parametrize("m,d", [(37, 64), (70, 128), (45, 192), (130, 256),
                                 (33, 384), (66, 512), (20, 576),
                                 (129, 768)])
def test_epilogue_emulation_matches_reference_f32(m, d):
    x, w_in_out, b, res, gamma, beta = _data(m, d, seed=m * 7 + d)
    w = np.ascontiguousarray(w_in_out.T)
    got = _emulate(x, w, b, res, gamma, beta, 1e-12)
    want = out_ln_reference(*_port_args(x, w_in_out, b, res, gamma, beta))
    close(torch.from_numpy(got), np.asarray(want), 1e-5)


def _stand_in_entry(monkeypatch, calls, fill=None, err=0):
    """Replace the kernel's library by a stand-in whose C entry records its
    arguments and writes ``fill`` into y."""
    def entry(*c_args):
        calls.append(c_args)
        m, d = c_args[7:9]
        if fill is not None:
            tensor_at(c_args[6], (m, d), torch.bfloat16).copy_(fill)
        return err

    lib = SimpleNamespace(shgvqa_out_ln_bf16=entry, max_d=768,
                          shgvqa_out_ln_error_string=lambda e: b"stand-in")
    monkeypatch.setattr(ffn, "_out_ln_lib", lambda: lib)
    monkeypatch.setattr(ffn, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())


def test_card_path_passes_its_operands_to_the_c_entry(monkeypatch):
    """The card path on CPU tensors, the C entry replaced by a stand-in:
    one call with x, W, b, residual, gamma, beta, y, M, D, eps and the
    stream in order; y comes back from the buffer the entry wrote (here
    the emulated kernel); fused_out_ln.launches counts the call; the
    backward recomputes through the plain version."""
    m, d, eps = 40, 192, 1e-12
    data = _data(m, d, seed=4)
    args = [a.contiguous() for a in _port_args(*data, dtype=torch.bfloat16)]
    x, w, b, res, gamma, beta = args
    fill = torch.from_numpy(_emulate(
        x.float().numpy(), w.float().numpy(), b.numpy(), res.float().numpy(),
        gamma.numpy(), beta.numpy(), eps)).to(torch.bfloat16)
    calls = []
    _stand_in_entry(monkeypatch, calls, fill)
    before = ffn.fused_out_ln.launches
    leaves = [a.detach().requires_grad_(i == 0) for i, a in enumerate(args)]
    y = ffn._FusedOutLN.apply(*leaves, eps)
    assert len(calls) == 1 and ffn.fused_out_ln.launches == before + 1
    c = calls[0]
    assert c[:6] == tuple(a.data_ptr() for a in args)
    assert c[6] == y.data_ptr() and c[7:9] == (m, d)
    assert c[9] == pytest.approx(eps) and c[10] == 0
    assert torch.equal(y, fill)
    close(y, np.asarray(out_ln_reference(*args).float()), 3e-2)
    # the backward: autograd of out_ln_reference
    dy = torch.randn(m, d, generator=torch.Generator().manual_seed(0))
    (gx,) = torch.autograd.grad(y, leaves[0], dy.to(torch.bfloat16))
    ref_x = args[0].detach().requires_grad_(True)
    (want,) = torch.autograd.grad(
        out_ln_reference(ref_x, *args[1:]), ref_x, dy.to(torch.bfloat16))
    assert torch.equal(gx, want)


def test_card_path_raises_when_the_launch_fails(monkeypatch):
    calls = []
    _stand_in_entry(monkeypatch, calls, err=98)
    args = [a.contiguous() for a in _port_args(*_data(8, 64),
                                               dtype=torch.bfloat16)]
    before = ffn.fused_out_ln.launches
    with pytest.raises(RuntimeError, match="CUDA error 98 .stand-in."):
        ffn._launch_out_ln(*args, 1e-12)
    assert len(calls) == 1 and ffn.fused_out_ln.launches == before


@pytest.mark.parametrize("d,cluster", WIDTHS[:12])
def test_wrapper_takes_the_planned_widths_and_names_the_switch(d, cluster):
    """On a device with no kernel, a width the kernel takes gets as far as
    the device check; any other raises and names set_out_ln_kernel."""
    ops = _meta(torch.zeros(4, d), torch.zeros(d, d), torch.zeros(4, d),
                dtype=torch.bfloat16)
    vecs = [torch.zeros(d, device="meta") for _ in range(3)]
    x, w, res = ops
    if cluster is None:
        with pytest.raises(ValueError, match="set_out_ln_kernel"):
            fused_out_ln(x, w, vecs[0], res, vecs[1], vecs[2])
    else:
        with pytest.raises(NotImplementedError, match="no kernel for meta"):
            fused_out_ln(x, w, vecs[0], res, vecs[1], vecs[2])

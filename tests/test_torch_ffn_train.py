"""The port's FFN train pair (shgvqa_tpu_torch/kernels/ffn.py
``fused_ffn_train``) on the CPU, where it runs its plain version: held to
the JAX ``fused_ffn_train`` (Pallas interpret mode) at rate 0, forward and
gradients, at the JAX tests' shapes and tolerances (bf16 3e-2, f32
gradients 2e-3, ``tests/test_pallas_ffn.py``); the backward kernel's
algorithm (``ffn_train_backward_reference``) against autograd with one
explicit keep mask at rate > 0 (1e-5, f32); the autograd Function of the
CUDA path with its launches replaced by the plain version; and the FFN
sites of a training forward routed through ``fused_ffn_train``.

JAX's rate > 0 train kernels have no CPU lowering (``pltpu.prng_seed``);
the CUDA kernels run only on the card (``chip_smoke.py``).  What the
chains' host side decides is held here through Python mirrors of the
formulas of ``csrc/ffn_train.cu`` and ``csrc/wgmma_gemm.cuh``: the tile and
grid plan of each stage of the forward's and the backward's chains, the
swizzled shared-memory layout the TMA writes against the addresses the
wgmma descriptors read, the wrapper's buffers and their order in the C
calls, and the widths both chains take."""

import contextlib
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.entry import build_model, example_batch
from shgvqa_tpu_torch.kernels import ffn
from shgvqa_tpu_torch.kernels.ffn import (
    ffn_train_backward_reference,
    ffn_train_reference,
    fused_ffn,
    fused_ffn_train,
)
from shgvqa_tpu_torch.models import layers
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.layers import FFN
from shgvqa_tpu_torch.train.step import compute_losses
from test_torch_common import (
    TOY,
    close,
    desc_address,
    t,
    tensor_at,
    tma_offset,
    wgmma_desc,
)

NAMES = ("x", "w1t", "b1", "w2t", "b2", "gamma", "beta")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default pool (one thread per core) in each oversubscribes
    the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def force_interpret():
    pallas_ffn._FORCE_INTERPRET = True
    yield
    pallas_ffn._FORCE_INTERPRET = False


def _data(m, d, f, seed=0):
    """numpy f32 operands in the JAX layout: w1 (D, F), w2 (F, D)."""
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(m, d).astype(np.float32) * 0.5,
        w1=rng.randn(d, f).astype(np.float32) * 0.05,
        b1=rng.randn(f).astype(np.float32) * 0.1,
        w2=rng.randn(f, d).astype(np.float32) * 0.05,
        b2=rng.randn(d).astype(np.float32) * 0.1,
        gamma=1.0 + 0.1 * rng.randn(d).astype(np.float32),
        beta=0.1 * rng.randn(d).astype(np.float32))


def _jax_args(a, dtype):
    return (jnp.asarray(a["x"], dtype), jnp.asarray(a["w1"], dtype),
            jnp.asarray(a["b1"]), jnp.asarray(a["w2"], dtype),
            jnp.asarray(a["b2"]), jnp.asarray(a["gamma"]),
            jnp.asarray(a["beta"]))


def _torch_args(a, dtype, grad=False):
    """The port's operands: nn.Linear layout, matmul operands in ``dtype``."""
    args = (t(a["x"], dtype), t(a["w1"].T.copy(), dtype), t(a["b1"]),
            t(a["w2"].T.copy(), dtype), t(a["b2"]), t(a["gamma"]),
            t(a["beta"]))
    return [x.requires_grad_(grad) for x in args]


@pytest.mark.parametrize("m", [96, 7])
def test_rate0_forward_matches_pallas_train_kernel_bf16(force_interpret, m):
    a = _data(m, 64, 128)
    want = pallas_ffn.fused_ffn_train(*_jax_args(a, jnp.bfloat16),
                                      dropout_rate=0.0, dropout_rng=None,
                                      interpret=True)
    args = _torch_args(a, torch.bfloat16)
    got = ffn_train_reference(*args)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), 3e-2)
    close(fused_ffn_train(*args, 0.0), np.asarray(want, np.float32), 3e-2)


def test_rate0_gradients_match_jax_grad_of_pallas_train_kernel(
        force_interpret):
    """dx, dW1, db1, dW2, db2, dgamma, dbeta of the JAX train kernel's
    custom VJP (its backward kernel in interpret mode) against autograd of
    the plain version and against the port's backward algorithm."""
    a = _data(32, 32, 64, seed=1)
    w = np.random.RandomState(2).randn(32, 32).astype(np.float32)

    def loss(*args):
        y = pallas_ffn.fused_ffn_train(*args, dropout_rate=0.0,
                                       dropout_rng=None, interpret=True)
        return jnp.sum(y * w)

    jgrads = jax.grad(loss, argnums=tuple(range(7)))(
        *_jax_args(a, jnp.float32))
    # the JAX layout's W1 (D, F) and W2 (F, D) are the port's w1t^T, w2t^T
    want = [np.asarray(g) for g in jgrads]
    want[1], want[3] = want[1].T, want[3].T
    args = _torch_args(a, torch.float32, grad=True)
    got = torch.autograd.grad(fused_ffn_train(*args, 0.0), args, t(w))
    plain = ffn_train_backward_reference(
        *(x.detach() for x in args[:6]), 0.0, None, t(w))
    for name, g, p, jg in zip(NAMES, got, plain, want):
        close(g, jg, 2e-3)
        close(p, jg, 2e-3)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_one_mask_in_forward_and_backward(rate):
    """At rate > 0 the backward algorithm with the forward's explicit keep
    mask equals autograd through the forward, for every gradient."""
    rng = np.random.RandomState(int(rate * 100))
    a = _data(40, 32, 64, seed=3)
    keep = t(rng.rand(40, 32) >= rate)
    dy = t(rng.randn(40, 32).astype(np.float32))
    args = _torch_args(a, torch.float32, grad=True)
    y = ffn_train_reference(*args, rate, keep)
    grads = torch.autograd.grad(y, args, dy)
    plain = ffn_train_backward_reference(
        *(x.detach() for x in args[:6]), rate, keep, dy)
    for g, p in zip(grads, plain):
        close(p, np.asarray(g), 1e-5)
    # the mask drops the output dense (bias included) before the residual,
    # kept values scaled by 1 / (1 - rate)
    x, w1t, b1, w2t, b2, gamma, beta = (v.detach() for v in args)
    h = torch.nn.functional.gelu(x @ w1t.t() + b1)
    r = torch.where(keep, (h @ w2t.t() + b2) / (1 - rate), 0.0) + x
    want = torch.nn.functional.layer_norm(r, (32,), gamma, beta, 1e-12)
    close(y, want, 1e-5)


def test_cpu_path_draws_its_mask_from_the_generator():
    a = _data(256, 32, 64, seed=4)
    args = _torch_args(a, torch.float32)
    rate = 0.1
    y1 = fused_ffn_train(*args, rate, torch.Generator().manual_seed(5))
    y2 = fused_ffn_train(*args, rate, torch.Generator().manual_seed(5))
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    keep = torch.rand((256, 32), generator=torch.Generator().manual_seed(5))
    keep = keep >= rate
    close(y1, ffn_train_reference(*args, rate, keep), 1e-6)
    # keep rate within 6 binomial standard deviations of 1 - rate
    kept = keep.float().mean().item()
    assert abs(kept - (1 - rate)) < 6 * np.sqrt(rate * (1 - rate)
                                                / keep.numel())
    assert fused_ffn_train.launches == 0
    assert fused_ffn_train.bwd_launches == 0
    with pytest.raises(ValueError, match="dropout_rate"):
        fused_ffn_train(*args, 1.0)


def _mask_of(seed, m, d, rate):
    """A stand-in for the kernels' mask: keyed on the seed tensor only."""
    g = torch.Generator().manual_seed(int(seed[0]) ^ int(seed[1]))
    return torch.rand((m, d), generator=g) >= rate


def test_autograd_function_wiring_with_plain_launches(monkeypatch):
    """The CUDA path's autograd.Function, run on the CPU with both launches
    replaced by their plain versions: the forward's seed reaches the
    backward (one mask), and the weight gradients formed from the backward
    kernel's spills (du^T x, do^T h, the bias sums) equal autograd of the
    plain version."""
    calls = []

    def fake_fwd(x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps,
                 row0=0):
        calls.append(("fwd", seed, row0))
        keep = _mask_of(seed, *x2.shape, rate)
        return ffn_train_reference(x2, w1t, b1, w2t, b2, gamma, beta, rate,
                                   keep, eps)

    def fake_bwd(x2, w1t, b1, w2t, b2, gamma, seed, rate, eps, dy, row0=0):
        calls.append(("bwd", seed, row0))
        keep = _mask_of(seed, *x2.shape, rate)
        return ffn._backward_spills(x2, w1t, b1, w2t, b2, gamma, rate, keep,
                                    dy, eps)

    monkeypatch.setattr(ffn, "_launch_train_fwd", fake_fwd)
    monkeypatch.setattr(ffn, "_launch_train_bwd", fake_bwd)
    a = _data(24, 32, 64, seed=6)
    rate = 0.2
    seed = torch.tensor([11, 12])
    args = _torch_args(a, torch.float32, grad=True)
    dy = t(np.random.RandomState(7).randn(24, 32).astype(np.float32))
    y = ffn._FusedFFNTrain.apply(*args, seed, rate, 1e-12, 48)
    got = torch.autograd.grad(y, args, dy)
    assert [c for c, _, _ in calls] == ["fwd", "bwd"]
    assert calls[0][1] is calls[1][1]
    assert calls[0][2] == calls[1][2] == 48    # the row offset too
    ref = [x.detach().clone().requires_grad_(True) for x in args]
    want = torch.autograd.grad(
        ffn_train_reference(*ref, rate, _mask_of(seed, 24, 32, rate)), ref,
        dy)
    for g, w in zip(got, want):
        close(g, np.asarray(w), 1e-5)


def test_wrapper_raises_where_it_has_no_kernel():
    a = _data(4, 64, 256)
    args = [x.to("meta") for x in _torch_args(a, torch.bfloat16)]
    with pytest.raises(NotImplementedError, match="no kernel"):
        fused_ffn_train(*args, 0.1)
    assert fused_ffn_train.launches == 0
    with pytest.raises(NotImplementedError, match="card only"):
        ffn.keep_mask(torch.zeros(2, dtype=torch.int64), 4, 64, 0.1)


def test_ffn_module_routes_training_through_the_train_kernel(monkeypatch):
    """FFN in training with train_kernel calls fused_ffn_train at its
    dropout rate with the caller's generator; in eval it keeps fused_ffn;
    with train_kernel off training runs the unfused block."""
    calls = []

    def spy(x, *args):
        calls.append(args[6])
        return fused_ffn_train(x, *args)

    monkeypatch.setattr(layers, "fused_ffn_train", spy)
    torch.manual_seed(0)
    mod = layers.init_weights(FFN(32, 64, use_kernel=True, dropout=0.1))
    x = torch.randn(2, 5, 32)
    g = torch.Generator().manual_seed(1)
    layers.set_ffn_train_kernel(torch.nn.Sequential(mod), True)
    y = mod.train()(x, g)
    keep = torch.rand((10, 32), generator=torch.Generator().manual_seed(1))
    want = ffn_train_reference(
        x.reshape(-1, 32), mod.intermediate.weight, mod.intermediate.bias,
        mod.output.weight, mod.output.bias, mod.ln.weight, mod.ln.bias, 0.1,
        keep >= 0.1).reshape(2, 5, 32)
    close(y, want.detach(), 1e-6)
    mod.eval()(x)
    mod.train_kernel = False
    mod.train()(x, g)
    assert calls == [0.1]
    with torch.no_grad():
        close(mod.eval()(x), fused_ffn(x, mod.intermediate.weight,
                                       mod.intermediate.bias,
                                       mod.output.weight, mod.output.bias,
                                       mod.ln.weight, mod.ln.bias), 1e-6)


def test_train_step_ffn_sites_and_their_backward(monkeypatch):
    """With use_pallas_ffn_train every FFN site of a training forward calls
    fused_ffn_train, and the backward reaches all of them but the LXRT
    x-layers' (which feed only the unsupervised logit): 18 and 14 at the
    flagship depths (5/2/5, two HG-cross layers)."""
    fwd, bwd = [], []

    def spy(x, *args):
        y = fused_ffn_train(x, *args)
        fwd.append(tuple(x.shape))
        y.register_hook(lambda grad: bwd.append(tuple(grad.shape)))
        return y

    monkeypatch.setattr(layers, "fused_ffn_train", spy)
    monkeypatch.setattr("shgvqa_tpu_torch.models.shgvqa.make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))
    cfg = tiny_test_config(task="hgqa", use_pallas_ffn_train=True)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=64))
    model = build_model(cfg, "cpu", seed=0).train()
    assert all(m.train_kernel for m in model.modules() if isinstance(m, FFN))
    batch = example_batch(cfg, 2, 0, with_labels=True)
    batch.pop("visual_mask")
    e = cfg.encoder
    batch["frames"] = np.random.RandomState(1).randint(
        0, 255, (2, e.visual_t + 8, 64, 64, 3)).astype(np.uint8)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _ = compute_losses(cfg, model(tb, torch.Generator().manual_seed(0)),
                             tb)
    loss.backward()
    x = e.x_layers
    hg = x                               # the HG-cross encoder's layers
    assert len(fwd) == (e.l_layers + x + hg) + (e.r_layers + x) + hg
    assert len(bwd) == len(fwd) - 2 * x


# ---------------------------------------------------------------------------
# Mirrors of csrc/wgmma_gemm.cuh and the backward chain of csrc/ffn_train.cu

GEMM_BM, GEMM_BK, GEMM_BOX = 128, 64, 64     # kGemmBM, kGemmBK, kGemmBox
REPO_CSRC = Path(__file__).resolve().parent.parent / "shgvqa_tpu_torch" / "csrc"
WIDE_N, NARROW_N, ROW_TILE = 128, 64, 16     # kWideN, kNarrowN, kRowTile
D, F = 768, 3072
# (stage, N, tile width, K) of the four products, in launch order
PRODUCTS = (("u", F, WIDE_N, D), ("o", D, NARROW_N, F),
            ("dh", F, WIDE_N, D), ("dx", D, NARROW_N, F))
SITE_ROWS = (80, 354, 786, 1280, 5664, 12576, 1000)


def _grid(m, n, bn):
    """gemm_launch: (column tiles, row tiles) of an (m, n) product."""
    return n // bn, -(-m // GEMM_BM)


def _tile_pairs(bn):
    """gemm_epilogue for every consumer thread (0..255) of a block: rows
    and first columns, in the tile, of the pairs it stores."""
    tid = np.arange(256)[:, None, None]
    j = np.arange(bn // 8)[None, :, None]
    h = np.arange(2)[None, None, :]
    lane = tid % 32
    rows = (tid // 32) * 16 + lane // 4 + 8 * h + 0 * j
    cols = 2 * (lane % 4) + 8 * j + 0 * h
    return rows.ravel(), cols.ravel()


@pytest.mark.parametrize("bn", [WIDE_N, NARROW_N])
def test_gemm_threads_cover_their_tile_once(bn):
    rows, cols = _tile_pairs(bn)
    count = np.zeros((GEMM_BM, bn), np.int64)
    np.add.at(count, (rows, cols), 1)
    np.add.at(count, (rows, cols + 1), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("m", SITE_ROWS)
def test_backward_stages_cover_every_element_once(m):
    """Each product's grid and thread map store every (row, column) of its
    (M, N) output exactly once and no row past M; the row pass visits every
    row once, in tiles that are the wrapper's partials."""
    for _, n, bn, k in PRODUCTS:
        assert n % bn == 0 and k % GEMM_BK == 0
        gx, gy = _grid(m, n, bn)
        rows, cols = _tile_pairs(bn)
        tile = np.zeros((GEMM_BM, bn), np.uint8)
        np.add.at(tile, (rows, cols), 1)
        np.add.at(tile, (rows, cols + 1), 1)
        count = np.zeros((gy * GEMM_BM, n), np.uint8)
        for by in range(gy):
            for bx in range(gx):
                count[by * GEMM_BM:(by + 1) * GEMM_BM,
                      bx * bn:(bx + 1) * bn] += tile
        stored = count[:m]            # the epilogues store rows < M only
        assert (stored == 1).all()
        assert gy * GEMM_BM - m < GEMM_BM
    tiles = -(-m // ROW_TILE)
    visited = np.zeros(m, np.int64)
    for block in range(tiles):
        valid = min(ROW_TILE, m - block * ROW_TILE)
        visited[block * ROW_TILE + np.arange(valid)] += 1
    assert (visited == 1).all()
    assert tuple(ffn._bwd_buffers(m, D, F, ROW_TILE, "meta")["part"].shape) \
        == (tiles, 2 * D)


@pytest.mark.parametrize("bn,mn_major", [(WIDE_N, False), (NARROW_N, False),
                                         (WIDE_N, True), (NARROW_N, True)])
def test_wgmma_descriptors_read_what_the_tma_wrote(bn, mn_major):
    """For every k16 step of a stage, the descriptors gemm_mainloop builds
    address, element by element, the bytes where the TMA boxes put the A
    rows of each consumer warpgroup and the B operand (K-major: N rows of K;
    MN-major: K rows of N, transposed by the wgmma).  The stage's base is
    1 KB aligned (offset 0 here); the B tile starts after the 16 KB A
    tile."""
    a_bytes = GEMM_BM * GEMM_BK * 2
    box_bytes = GEMM_BOX * GEMM_BK * 2
    mn = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    for kk in range(GEMM_BK // 16):
        for wg in range(2):                     # A: K-major, 64 rows each
            desc = wgmma_desc(wg * 64 * 128 + 32 * kk, 16, 1024)
            got = desc_address(desc, mn, k, False)
            assert (got == tma_offset(wg * 64 + mn, 16 * kk + k)).all()
        n = np.arange(bn)[:, None]
        if mn_major:
            desc = wgmma_desc(a_bytes + 2048 * kk, box_bytes, 1024)
            want = a_bytes + (n // GEMM_BOX) * box_bytes + tma_offset(
                16 * kk + k, n % GEMM_BOX)
        else:
            desc = wgmma_desc(a_bytes + 32 * kk, 16, 1024)
            want = a_bytes + (n // GEMM_BOX) * box_bytes + tma_offset(
                n % GEMM_BOX, 16 * kk + k)
        assert (desc_address(desc, n, k, mn_major) == want).all()


def test_wgmma_descriptor_fields():
    desc = wgmma_desc(0x1F400 + 2048, 8192, 1024)
    assert desc & 0x3FFF == (0x1F400 + 2048) >> 4
    assert (desc >> 16) & 0x3FFF == 512 and (desc >> 32) & 0x3FFF == 64
    assert (desc >> 49) & 7 == 0 and desc >> 62 == 1


def test_backward_buffers_and_their_order_in_the_c_call(monkeypatch):
    """_launch_train_bwd on CPU tensors with the library replaced by a
    stand-in: the 16 pointers reach the C entry in its order (inputs, then
    dx, du, do, h, gelu'(u), dr, the partials, [dgamma | dbeta]) with the
    shapes and dtypes the kernels write; the stand-in fills them from the
    plain version, and the wrapper returns (dx, du, do, h, dgamma, dbeta)
    from them."""
    m, d, f = 40, 64, 256
    rng = np.random.RandomState(8)
    a = _data(m, d, f, seed=9)
    args = [x.contiguous() for x in _torch_args(a, torch.bfloat16)]
    dy = t(rng.randn(m, d).astype(np.float32), torch.bfloat16)
    want = ffn._backward_spills(*args[:6], 0.0, None, dy, 1e-12)
    shapes = [("dx", (m, d), torch.bfloat16), ("du", (m, f), torch.bfloat16),
              ("do", (m, d), torch.bfloat16), ("h", (m, f), torch.bfloat16),
              ("gd", (m, f), torch.float32), ("dr", (m, d), torch.float32),
              ("part", (-(-m // ROW_TILE), 2 * d), torch.float32),
              ("dgb", (2 * d,), torch.float32)]
    calls = []

    def backward_entry(*c_args):
        calls.append(c_args)
        ptrs, (cm, cd, cf) = c_args[:16], c_args[16:19]
        assert (cm, cd, cf) == (m, d, f) and c_args[22] == 0   # dropout off
        assert ptrs[:8] == (args[0].data_ptr(), args[1].data_ptr(),
                            args[2].data_ptr(), args[3].data_ptr(),
                            args[4].data_ptr(), args[5].data_ptr(), None,
                            dy.data_ptr())
        out = {name: tensor_at(ptr, shape, dtype)
               for (name, shape, dtype), ptr in zip(shapes, ptrs[8:])}
        for name, value in zip(("dx", "du", "do", "h"), want[:4]):
            out[name].copy_(value)
        out["dgb"].copy_(torch.cat([want[4], want[5]]))
        return 0

    lib = SimpleNamespace(shgvqa_ffn_train_bwd_bf16=backward_entry,
                          shgvqa_ffn_train_bwd_rows=lambda: ROW_TILE,
                          shgvqa_ffn_train_max_d=lambda: 768)
    monkeypatch.setattr(ffn, "_train_lib", lambda: lib)
    monkeypatch.setattr(ffn, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    buffers = ffn._bwd_buffers(m, d, f, ROW_TILE, "cpu")
    assert [(k, tuple(v.shape), v.dtype) for k, v in buffers.items()] == \
        shapes
    launches = fused_ffn_train.bwd_launches
    got = ffn._launch_train_bwd(*args[:6], None, 0.0, 1e-12, dy)
    assert len(calls) == 1 and fused_ffn_train.bwd_launches == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


# ---------------------------------------------------------------------------
# Mirrors of the forward chain of csrc/ffn_train.cu

# (stage, N, tile width, K) of the forward's two products, in launch order
FWD_PRODUCTS = (("u", F, WIDE_N, D), ("o", D, NARROW_N, F))


@pytest.mark.parametrize("m", SITE_ROWS)
def test_forward_stages_cover_every_element_once(m):
    """The forward's u and o grids and thread maps store every (row, column)
    of their (M, F) and (M, D) outputs exactly once and no row past M; the
    row pass (a warp a row, 16 rows a block) visits every row below M
    once."""
    assert ffn.FWD_STAGES == ("ffn_fwd_u_kernel", "ffn_o_kernel",
                              "ffn_fwd_rows_kernel")
    for _, n, bn, k in FWD_PRODUCTS:
        assert n % bn == 0 and k % GEMM_BK == 0
        gx, gy = _grid(m, n, bn)
        rows, cols = _tile_pairs(bn)
        count = np.zeros((gy * GEMM_BM, n), np.uint8)
        for by in range(gy):
            for bx in range(gx):
                np.add.at(count, (by * GEMM_BM + rows, bx * bn + cols), 1)
                np.add.at(count, (by * GEMM_BM + rows, bx * bn + cols + 1), 1)
        assert (count[:m] == 1).all()
        assert gy * GEMM_BM - m < GEMM_BM
    blocks = -(-m // ROW_TILE)
    rows = (np.arange(blocks)[:, None] * ROW_TILE
            + np.arange(ROW_TILE)[None, :]).ravel()
    visited = np.bincount(rows[rows < m], minlength=m)
    assert (visited == 1).all()
    # a lane holds columns lane * 4 + 128 i, i < 6: every column of D = 768
    cols = (np.arange(32)[:, None, None] * 4 + 128 * np.arange(6)[None, :, None]
            + np.arange(4)[None, None, :]).ravel()
    assert np.array_equal(np.sort(cols), np.arange(D))


def test_forward_buffers_and_their_order_in_the_c_call(monkeypatch):
    """_launch_train_fwd on CPU tensors with the library replaced by a
    stand-in: the 11 pointers reach the C entry in its order (inputs, the
    seed, then y, h and o + b2) with the shapes and dtypes the chain
    writes; the stand-in fills them from the plain version, the wrapper
    returns y, and buffers the caller gives receive h and o + b2."""
    m, d, f = 40, 64, 256
    a = _data(m, d, f, seed=10)
    args = [x.contiguous() for x in _torch_args(a, torch.bfloat16)]
    u, h, _ = ffn._residual(*args[:5], 0.0, None)
    o = torch.matmul(h.float(), args[3].float().t()) + args[4]
    y = ffn_train_reference(*args, 0.0, None)
    shapes = [("y", (m, d), torch.bfloat16), ("h", (m, f), torch.bfloat16),
              ("o", (m, d), torch.float32)]
    calls = []

    def forward_entry(*c_args):
        calls.append(c_args)
        ptrs, (cm, cd, cf) = c_args[:11], c_args[11:14]
        assert (cm, cd, cf) == (m, d, f) and c_args[17] == 0   # dropout off
        assert ptrs[:8] == tuple(x.data_ptr() for x in args) + (None,)
        out = {name: tensor_at(ptr, shape, dtype)
               for (name, shape, dtype), ptr in zip(shapes, ptrs[8:])}
        for name, value in (("y", y), ("h", h), ("o", o)):
            out[name].copy_(value)
        return 0

    lib = SimpleNamespace(shgvqa_ffn_train_fwd_bf16=forward_entry,
                          shgvqa_ffn_train_max_d=lambda: 768)
    monkeypatch.setattr(ffn, "_train_lib", lambda: lib)
    monkeypatch.setattr(ffn, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    buffers = ffn._fwd_buffers(m, d, f, "cpu")
    assert [(k, tuple(v.shape), v.dtype) for k, v in buffers.items()] == \
        shapes
    launches = fused_ffn_train.launches
    got = ffn._launch_train_fwd(*args, None, 0.0, 1e-12, buffers)
    assert got is buffers["y"] and torch.equal(got, y)
    assert torch.equal(buffers["h"], h) and torch.equal(buffers["o"], o)
    got = ffn._launch_train_fwd(*args, None, 0.0, 1e-12)
    assert len(calls) == 2 and fused_ffn_train.launches == launches + 2
    assert torch.equal(got, y)


@pytest.mark.parametrize("d,f,ok", [(768, 3072, True), (64, 128, True),
                                    (64, 192, False), (96, 256, False),
                                    (832, 3072, False)])
def test_train_wrapper_takes_what_both_chains_take(monkeypatch, d, f, ok):
    """The wrapper's checks, shared by the forward and the backward: D a
    multiple of 64 up to the library's maximum (768: the forward's row pass
    holds a row in registers), F a multiple of 128 (the (M, F) products'
    tiles)."""
    lib = SimpleNamespace(shgvqa_ffn_train_max_d=lambda: 768)
    monkeypatch.setattr(ffn, "_train_lib", lambda: lib)
    bf16 = torch.bfloat16
    ops = (torch.empty(4, d, dtype=bf16), torch.empty(f, d, dtype=bf16),
           torch.empty(f), torch.empty(d, f, dtype=bf16), torch.empty(d),
           torch.empty(d), torch.empty(d))
    if ok:
        assert ffn._check_train(*ops) == (4, d, f)
    else:
        with pytest.raises(ValueError, match="multiple of 64"):
            ffn._check_train(*ops)


def _o_takes_wide_tiles(m, d, sms, wide=192):
    """o_takes_wide_tiles of csrc/ffn_train.cu."""
    if d % wide:
        return False
    tiles = -(-m // GEMM_BM) * (d // wide)
    waves = -(-tiles // sms)
    return tiles >= sms and 4 * tiles >= 3 * waves * sms


@pytest.mark.parametrize("m", SITE_ROWS)
def test_o_stage_takes_192_wide_tiles_where_they_fill_the_waves(m):
    """On 132 SMs the o stage (shared by both chains) takes its 192-wide
    tiles at M = 12576 only (396 tiles, 3 waves) and 64-wide ones at the
    other sites (M = 5664 would leave 2 waves 68% full); either grid and
    thread map stores every (row, column) of o once and no row past M."""
    src = (REPO_CSRC / "ffn_train.cu").read_text()
    assert "constexpr int kOWideN = 192;" in src
    assert "return tiles >= sms && 4 * tiles >= 3 * waves * sms;" in src
    assert "err = o_takes_wide_tiles(p.m, p.d, sms)" in src
    wide = _o_takes_wide_tiles(m, D, 132)
    assert wide == (m == 12576)
    assert not _o_takes_wide_tiles(m, 64, 132)
    bn = 192 if wide else NARROW_N
    gx, gy = _grid(m, D, bn)
    rows, cols = _tile_pairs(bn)
    count = np.zeros((gy * GEMM_BM, D), np.uint8)
    for by in range(gy):
        for bx in range(gx):
            np.add.at(count, (by * GEMM_BM + rows, bx * bn + cols), 1)
            np.add.at(count, (by * GEMM_BM + rows, bx * bn + cols + 1), 1)
    assert (count[:m] == 1).all()

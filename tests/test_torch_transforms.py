"""The port's RandAugment / AugMix (data/transforms.py) against the JAX
package's ``shgvqa_tpu/data/transforms.py``.  The two packages draw from
different random streams, so the ops and layers are held at fixed choices:
each of the 14 ops at a fixed magnitude and sign, one batch layer and two
stacked layers at fixed (op, apply, sign) arrays.  Then the port's own
promises: the sub-batch and full-batch layers and the folded and unfolded
AugMix give the same bits, the draws cover every op at the apply rate,
and one seed gives the same bits twice.  The fixed-capacity path (the JAX
gathered path, which a CUDA graph of the train step runs): its class
capacities equal JAX's, it gives the select tree's bits for RandAugment
and AugMix with and without a class over its capacity, it matches the JAX
gathered layer, and its branch runs with every host read refused when the
conditional nodes of a capture are emulated on the CPU."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.data import transforms as jt
from shgvqa_tpu_torch.data import transforms as tt
from shgvqa_tpu_torch.kernels import cond
from test_torch_common import close, t

# B clips of T frames, H != W so that a swapped axis shows
B, T, H, W = 6, 2, 20, 24
MAGNITUDE = 9
# bf16: mean |port - JAX| of the JAX test of its strided equalize
# (tests/test_transforms.py::test_equalize_batch_strided_close_to_exact)
BF16_MEAN_TOL = 0.04


def _frames(seed=0, b=B, smooth=False):
    rng = np.random.RandomState(seed)
    if not smooth:
        return rng.rand(b, T, H, W, 3).astype(np.float32)
    # random walks along W: non-degenerate histograms for equalize
    x = np.cumsum(rng.randn(b, T, H, W, 3), axis=3)
    lo = x.min(axis=(1, 2, 3, 4), keepdims=True)
    hi = x.max(axis=(1, 2, 3, 4), keepdims=True)
    return ((x - lo) / (hi - lo)).astype(np.float32)


def _levels(i, b=B):
    """Op i's level at MAGNITUDE per clip, the signed ops alternating
    signs."""
    _, maxval, signed = tt.RAND_AUGMENT_OPS[i]
    v = np.full(b, MAGNITUDE / 31.0 * maxval, np.float32)
    if signed:
        v *= np.where(np.arange(b) % 2, -1.0, 1.0).astype(np.float32)
    return v


def _jax_op(i, x, v):
    fn = jt.RAND_AUGMENT_OPS[i][0]
    return np.asarray(jax.vmap(fn)(jnp.asarray(x), jnp.asarray(v)),
                      np.float32)


def test_op_table_matches_jax():
    assert len(tt.RAND_AUGMENT_OPS) == len(jt.RAND_AUGMENT_OPS) == 14
    for (f, m, s), (jf, jm, js) in zip(tt.RAND_AUGMENT_OPS,
                                       jt.RAND_AUGMENT_OPS):
        assert (f.__name__, m, s) == (jf.__name__, jm, js)
    assert tt._geo_pad_bound(MAGNITUDE, H, W) == jt._geo_pad_bound(
        MAGNITUDE, H, W)


@pytest.mark.parametrize("i", range(14), ids=[
    f[0].__name__ for f in tt.RAND_AUGMENT_OPS])
def test_op_matches_jax_f32(i):
    """Each op at MAGNITUDE, both signs, f32: 1e-5."""
    x = _frames(i, smooth=i == 2)
    v = _levels(i)
    got = tt.RAND_AUGMENT_OPS[i][0](t(x), t(v))
    assert got.dtype == torch.float32 and got.shape == x.shape
    close(got, _jax_op(i, x, v), 1e-5)


@pytest.mark.parametrize("i", range(14), ids=[
    f[0].__name__ for f in tt.RAND_AUGMENT_OPS])
def test_op_matches_jax_bf16(i):
    """Each op in bf16 (the flagship's frames dtype): mean |port - JAX| as
    the JAX strided-equalize test bounds it."""
    x = _frames(i + 20, smooth=i == 2)
    v = _levels(i)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.vmap(jt.RAND_AUGMENT_OPS[i][0])(
        xb, jnp.asarray(v, jnp.bfloat16)).astype(jnp.float32))
    got = tt.RAND_AUGMENT_OPS[i][0](t(x, torch.bfloat16),
                                    t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).mean() < BF16_MEAN_TOL


@pytest.mark.parametrize("stride", [1, 4, 8])
def test_equalize_batch_matches_jax(stride):
    x = _frames(3, smooth=True)
    want = np.asarray(jt.op_equalize_batch(jnp.asarray(x), stride=stride))
    close(tt.op_equalize_batch(t(x), stride=stride), want, 1e-6)


def _draws(seed, b=B, layers=1):
    """Fixed (op, apply, sign) arrays: every op at least once per layer
    (b >= 14) or a random mix, a few clips not applied."""
    rng = np.random.RandomState(seed)
    op = np.stack([rng.permutation(np.arange(b) % 14) for _ in range(layers)],
                  axis=1).astype(np.int32)
    apply = rng.rand(b, layers) < 0.85
    sign = rng.choice([-1.0, 1.0], size=(b, layers)).astype(np.float32)
    return op, apply, sign


@pytest.mark.parametrize("eq_stride", [1, 8])
@pytest.mark.parametrize("path", ["subbatch", "select"], ids=["sub", "full"])
def test_layer_matches_jax(path, eq_stride):
    """One layer over 16 clips at fixed draws (every op at least once)
    against the JAX ``_apply_layer_batch``, f32, 1e-5."""
    b = 16
    x = _frames(4, b=b, smooth=True)
    op, apply, sign = (a[:, 0] for a in _draws(5, b))
    want = np.asarray(jt._apply_layer_batch(
        jnp.asarray(x), jnp.asarray(op), jnp.asarray(apply),
        jnp.asarray(sign), MAGNITUDE, eq_stride, apply_prob=1.0,
        subbatch=False))
    got = tt.apply_layer_batch(t(x), t(op).long(), t(apply), t(sign),
                               MAGNITUDE, eq_stride, path=path)
    close(got, want, 1e-5)


def test_two_layers_match_jax():
    """``rand_augment_batch``'s layers at fixed draws: two stacked JAX
    layers, f32, 1e-5."""
    b = 16
    x = _frames(6, b=b, smooth=True)
    op, apply, sign = _draws(7, b, layers=2)
    want = jnp.asarray(x)
    for layer in range(2):
        want = jt._apply_layer_batch(
            want, jnp.asarray(op[:, layer]), jnp.asarray(apply[:, layer]),
            jnp.asarray(sign[:, layer]), MAGNITUDE, 8, apply_prob=0.5,
            subbatch=False)
    got = tt._augment(t(x), t(op).long(), t(apply), t(sign), MAGNITUDE, 8,
                      "subbatch")
    close(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_subbatch_and_full_layers_bit_equal(dtype):
    for seed in range(3):
        b = 14 + 3 * seed
        x = t(_frames(10 + seed, b=b, smooth=seed == 1), dtype)
        op, apply, sign = (t(a[:, 0]) for a in _draws(seed, b))
        sub = tt.apply_layer_batch(x, op.long(), apply, sign, MAGNITUDE)
        full = tt.apply_layer_batch(x, op.long(), apply, sign, MAGNITUDE,
                                    path="select")
        assert sub.dtype == dtype
        assert torch.equal(sub, full), seed
    # every clip at the identity: the frames come back untouched
    none = torch.zeros(b, dtype=torch.bool)
    assert torch.equal(tt.apply_layer_batch(x, op.long(), none, sign), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("path", ["subbatch", "select"], ids=["sub", "full"])
def test_aug_mix_folded_and_unfolded_bit_equal(dtype, path):
    x = t(_frames(11, smooth=True), dtype)
    out = [tt.aug_mix_batch(x, torch.Generator().manual_seed(5),
                            path=path, fold_chains=fold)
           for fold in (True, False)]
    assert out[0].dtype == dtype and out[0].shape == x.shape
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], x)
    assert out[0].min() >= 0.0 and out[0].max() <= 1.0


def test_draws_cover_every_op_at_the_apply_rate():
    """Many draws from one generator: all 14 ops, each near 1/14, applied
    at a rate near ``prob``, signs near half and half."""
    n, layers = 8192, 2
    op, apply, sign = tt.sample_rand_augment(
        n, layers, 0.5, torch.Generator().manual_seed(0), "cpu")
    assert op.shape == apply.shape == sign.shape == (n, layers)
    counts = torch.bincount(op.flatten(), minlength=14).float() / op.numel()
    assert op.min() == 0 and op.max() == 13
    assert ((counts - 1 / 14).abs() < 0.01).all(), counts
    assert abs(apply.float().mean().item() - 0.5) < 0.02
    assert set(sign.unique().tolist()) == {-1.0, 1.0}
    assert abs((sign > 0).float().mean().item() - 0.5) < 0.02
    _, always, _ = tt.sample_rand_augment(
        64, 2, 1.0, torch.Generator().manual_seed(1), "cpu")
    assert always.all()


def test_aug_mix_weights_have_the_dirichlet_and_beta_moments():
    """Dirichlet(1, 1, 1): each weight mean 1/3, variance 1/18, rows summing
    to 1; Beta(1, 1): mean 1/2, variance 1/12."""
    ws, m = tt.aug_mix_weights(20000, 3, torch.Generator().manual_seed(2),
                               "cpu")
    assert ws.shape == (20000, 3) and m.shape == (20000,)
    assert (ws > 0).all() and ((m > 0) & (m < 1)).all()
    torch.testing.assert_close(ws.sum(dim=1), torch.ones(20000))
    assert ((ws.mean(dim=0) - 1 / 3).abs() < 0.01).all()
    assert ((ws.var(dim=0) - 1 / 18).abs() < 0.005).all()
    assert abs(m.mean().item() - 0.5) < 0.01
    assert abs(m.var().item() - 1 / 12) < 0.005


@pytest.mark.parametrize("kind", ["rand_aug", "aug_mix"])
def test_one_seed_gives_the_same_bits(kind):
    x = t(_frames(12), torch.bfloat16)
    out = [tt.augment_clips(x, kind, torch.Generator().manual_seed(9))
           for _ in range(2)]
    other = tt.augment_clips(x, kind, torch.Generator().manual_seed(10))
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], other)
    assert not torch.equal(out[0], x)


# -- the fixed-capacity path ---------------------------------------------------

@pytest.mark.parametrize("b", [2, 8, 16, 32, 96, 128])
def test_class_cap_matches_jax(b):
    for p in (0.5 / 14, 1.5 / 14, 1.0 / 14, 3.0 / 14, 0.3):
        assert tt._class_cap(b, p) == jt._class_cap(b, p)


@contextlib.contextmanager
def _recorded_branches():
    """The flags of every ``cond.branch`` call: True where a class drew
    more clips than its capacity (the select tree ran)."""
    flags, real = [], cond.branch

    def record(flag, if_true, if_false, out):
        flags.append(bool(flag))
        return real(flag, if_true, if_false, out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cond, "branch", record)
        yield flags


def _geometry_draws(b, layers=2):
    """Every clip rotates at every layer: the x1, y and rot classes all
    over their capacities (as tests/test_transforms.py forces it)."""
    return (torch.full((b, layers), tt._GEO_ROT), torch.ones(b, layers,
            dtype=torch.bool), torch.ones(b, layers))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fixed_capacity_rand_augment_is_the_select_tree(dtype):
    """RandAugment at B=16 and 32 (apply 0.5), three seeds each: the
    gathered classes take the select tree's bits and layout; then every
    clip rotating, which overflows, takes the select tree itself."""
    flags_seen = []
    for b in (16, 32):
        x = t(_frames(b, b=b, smooth=True), dtype)
        for seed in range(3):
            g = torch.Generator().manual_seed(seed)
            op, apply, sign = tt.sample_rand_augment(b, 2, 0.5, g, "cpu")
            full = tt._augment(x, op, apply, sign, MAGNITUDE, 8, "select")
            with _recorded_branches() as flags:
                cap = tt._augment(x, op, apply, sign, MAGNITUDE, 8,
                                  "capacity", 0.5)
            assert len(flags) == 2
            flags_seen += flags
            assert torch.equal(cap, full) and cap.stride() == full.stride()
        op, apply, sign = _geometry_draws(b)
        with _recorded_branches() as flags:
            cap = tt._augment(x, op, apply, sign, MAGNITUDE, 8, "capacity",
                              0.5)
        assert flags == [True, True]
        assert torch.equal(cap, tt._augment(x, op, apply, sign, MAGNITUDE,
                                            8, "select"))
    assert not any(flags_seen)


def test_fixed_capacity_aug_mix_is_the_select_tree():
    """AugMix at B=8 (its folded 3 x 8 rows at apply 1.0), two seeds: the
    fixed-capacity chains against the select tree's, bit-equal."""
    x = t(_frames(12, b=8, smooth=True))
    for seed in (5, 6):
        want = tt.aug_mix_batch(x, torch.Generator().manual_seed(seed),
                                path="select")
        with _recorded_branches() as flags:
            got = tt.aug_mix_batch(x, torch.Generator().manual_seed(seed),
                                   path="capacity")
        assert len(flags) == 2
        assert torch.equal(got, want)


def test_fixed_capacity_layer_matches_the_jax_gathered_layer():
    """One layer at fixed draws over 16 clips (every op at least once)
    against the JAX gathered path (``subbatch=True``) at apply 1.0, f32
    1e-5, with and without overflow."""
    b = 16
    x = _frames(4, b=b, smooth=True)
    op, apply, sign = (a[:, 0] for a in _draws(5, b))
    geo = np.full(b, tt._GEO_ROT, np.int32)
    for ops in (op, geo):
        want = np.asarray(jt._apply_layer_batch(
            jnp.asarray(x), jnp.asarray(ops), jnp.asarray(apply),
            jnp.asarray(sign), MAGNITUDE, 8, apply_prob=1.0, subbatch=True))
        got = tt.apply_layer_batch(t(x), t(ops).long(), t(apply), t(sign),
                                   MAGNITUDE, 8, path="capacity")
        close(got, want, 1e-5)


def _refuse(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"the layer called {name}")
    return refuse


def _predicated(flag, bodies, out):
    """The CPU's stand-in for the two IF nodes: each body runs, and its
    result is kept where its condition holds (no host read)."""
    for negate, body in bodies:
        keep = flag != negate
        out.copy_(torch.where(keep, body(), out))


def test_fixed_capacity_branch_under_capture_reads_nothing_on_the_host(
        monkeypatch):
    """With the capture's conditional nodes emulated (``_capturing`` true,
    the nodes' bodies predicated), a RandAugment batch at B=16 runs with
    every host read refused and gives the select tree's bits, with and
    without overflow."""
    b = 16
    x = t(_frames(9, b=b, smooth=True))
    g = torch.Generator().manual_seed(2)
    draws = [tt.sample_rand_augment(b, 2, 0.5, g, "cpu"), _geometry_draws(b)]
    monkeypatch.setattr(cond, "_capturing", lambda device: True)
    monkeypatch.setattr(cond, "_capture_branches", _predicated)
    for op, apply, sign in draws:
        want = tt._augment(x, op, apply, sign, MAGNITUDE, 8, "select")
        with pytest.MonkeyPatch.context() as mp:
            for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                         "__int__", "__float__"):
                mp.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
            mp.setattr(torch, "tensor", _refuse("torch.tensor"))
            got = tt._augment(x, op, apply, sign, MAGNITUDE, 8, "capacity",
                              0.5)
        assert torch.equal(got, want)


def test_branch_runs_one_side_on_the_cpu():
    out = torch.zeros(3)
    calls = []
    for flag in (True, False):
        cond.branch(torch.tensor(flag), lambda: calls.append(1) or
                    torch.ones(3), lambda: calls.append(0) or
                    torch.full((3,), 2.0), out)
        assert out.tolist() == ([1.0] * 3 if flag else [2.0] * 3)
    assert calls == [1, 0]


def test_warm_up_lasts_its_block_and_the_cpu_runs_one_side():
    """``cond.warm_up`` (a card's runs of both branches before a capture)
    holds inside its block only; on the CPU a branch runs one side even
    inside it."""
    assert not cond.branch.warming
    out, calls = torch.zeros(2), []
    with cond.warm_up():
        assert cond.branch.warming
        cond.branch(torch.tensor(True), lambda: calls.append(1) or
                    torch.ones(2), lambda: calls.append(0) or torch.ones(2),
                    out)
    assert not cond.branch.warming and calls == [1]

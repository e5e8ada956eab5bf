"""The port's RandAugment / AugMix (data/transforms.py) against the JAX
package's ``shgvqa_tpu/data/transforms.py``.  The two packages draw from
different random streams, so the ops and layers are held at fixed choices:
each of the 14 ops at a fixed magnitude and sign, one batch layer and two
stacked layers at fixed (op, apply, sign) arrays.  Then the port's own
promises: the sub-batch and full-batch layers and the folded and unfolded
AugMix give the same bits, the draws cover every op at the apply rate,
and one seed gives the same bits twice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.data import transforms as jt
from shgvqa_tpu_torch.data import transforms as tt
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
@pytest.mark.parametrize("subbatch", [True, False], ids=["sub", "full"])
def test_layer_matches_jax(subbatch, eq_stride):
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
                               MAGNITUDE, eq_stride, subbatch=subbatch)
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
                      True)
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
                                    subbatch=False)
        assert sub.dtype == dtype
        assert torch.equal(sub, full), seed
    # every clip at the identity: the frames come back untouched
    none = torch.zeros(b, dtype=torch.bool)
    assert torch.equal(tt.apply_layer_batch(x, op.long(), none, sign), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("subbatch", [True, False], ids=["sub", "full"])
def test_aug_mix_folded_and_unfolded_bit_equal(dtype, subbatch):
    x = t(_frames(11, smooth=True), dtype)
    out = [tt.aug_mix_batch(x, torch.Generator().manual_seed(5),
                            subbatch=subbatch, fold_chains=fold)
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

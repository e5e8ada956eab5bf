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
the CUDA kernels run only on the card (``chip_smoke.py``)."""

import dataclasses

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
from test_torch_common import TOY, close, t

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

    def fake_fwd(x2, w1t, b1, w2t, b2, gamma, beta, seed, rate, eps):
        calls.append(("fwd", seed))
        keep = _mask_of(seed, *x2.shape, rate)
        return ffn_train_reference(x2, w1t, b1, w2t, b2, gamma, beta, rate,
                                   keep, eps)

    def fake_bwd(x2, w1t, b1, w2t, b2, gamma, seed, rate, eps, dy):
        calls.append(("bwd", seed))
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
    y = ffn._FusedFFNTrain.apply(*args, seed, rate, 1e-12)
    got = torch.autograd.grad(y, args, dy)
    assert [c for c, _ in calls] == ["fwd", "bwd"]
    assert calls[0][1] is calls[1][1]
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

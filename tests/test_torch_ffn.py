"""The port's fused FFN (shgvqa_tpu_torch/kernels/ffn.py) against the JAX
package's Pallas kernel (shgvqa_tpu/kernels/ffn.py, interpret mode on the
CPU) and FFN module.  The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against ``ffn_reference`` there); on the CPU the
wrapper takes the plain version, which is what these tests hold to JAX.

Tolerances: bf16 3e-2 (as tests/test_pallas_ffn.py; the TPU kernel's erf
is a polynomial, the port's is erf); f32 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu.models.layers import FFN as JaxFFN
from shgvqa_tpu_torch.kernels import ffn
from shgvqa_tpu_torch.models.layers import FFN
from test_torch_common import close, jax_variables, load_port, t


@pytest.fixture()
def force_interpret():
    pallas_ffn.enable(True)
    pallas_ffn._FORCE_INTERPRET = True
    yield
    pallas_ffn.enable(False)
    pallas_ffn._FORCE_INTERPRET = False


def _data(m=200, d=64, f=256, seed=0):
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


def _torch_args(a, dtype):
    """The port's operands: nn.Linear layout, matmul operands in ``dtype``."""
    return (t(a["x"], dtype), t(a["w1"].T.copy(), dtype), t(a["b1"]),
            t(a["w2"].T.copy(), dtype), t(a["b2"]), t(a["gamma"]),
            t(a["beta"]))


@pytest.mark.parametrize("m", [200, 7])
def test_plain_version_matches_pallas_kernel_bf16(force_interpret, m):
    a = _data(m=m)
    want = pallas_ffn.fused_ffn(*_jax_args(a, jnp.bfloat16), interpret=True)
    args = _torch_args(a, torch.bfloat16)
    got = ffn.ffn_reference(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 64)
    close(got, np.asarray(want, np.float32), 3e-2)
    # the wrapper takes the plain version for CPU tensors
    close(ffn.fused_ffn(*args), np.asarray(got.float()), 0.0)


@pytest.mark.parametrize("m", [96, 7])
def test_plain_version_matches_pallas_kernel_f32(force_interpret, m):
    a = _data(m=m, seed=1)
    want = pallas_ffn.fused_ffn(*_jax_args(a, jnp.float32), interpret=True)
    close(ffn.ffn_reference(*_torch_args(a, torch.float32)),
          np.asarray(want), 1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ffn_module_matches_jax(force_interpret, use_kernel):
    """Both paths of the port's FFN against the JAX module on its kernel
    path (interpret mode) and its unfused path, f32."""
    pallas_ffn.enable(use_kernel)
    x = np.random.RandomState(2).randn(3, 37, 32).astype(np.float32)
    mod = JaxFFN(intermediate_size=64, dtype=jnp.float32)
    v = jax_variables(mod, x, deterministic=True)
    want = mod.apply(v, x, deterministic=True)
    port = load_port(FFN(32, 64, torch.float32, use_kernel=use_kernel), v)
    close(port(t(x)), want, 1e-5)


def test_autograd_function_backward_matches_plain_gradients(monkeypatch):
    """The CUDA path's autograd.Function, run on the CPU with its launch
    replaced by the plain version: the backward recomputes through
    ``ffn_reference`` and returns each input's gradient in place."""
    launches = []

    def fake_launch(*args):
        launches.append(1)
        return ffn.ffn_reference(*args)

    monkeypatch.setattr(ffn, "_launch", fake_launch)
    a = _data(m=16, d=32, f=64, seed=3)
    args = [x.requires_grad_(i in (0, 1, 3, 5)) for i, x in
            enumerate(_torch_args(a, torch.float32))]
    (ffn._FusedFFN.apply(*args, 1e-12) ** 2).sum().backward()
    got = [x.grad for x in args]
    ref = [x.detach().clone().requires_grad_(x.requires_grad) for x in args]
    (ffn.ffn_reference(*ref) ** 2).sum().backward()
    assert launches == [1]
    for g, r in zip(got, ref):
        if r.grad is None:
            assert g is None
        else:
            close(g, np.asarray(r.grad), 1e-6)


def test_wrapper_raises_where_it_has_no_kernel():
    a = _data(m=4, d=16, f=32)
    args = [x.to("meta") for x in _torch_args(a, torch.bfloat16)]
    before = ffn.fused_ffn.launches
    with pytest.raises(NotImplementedError, match="no kernel"):
        ffn.fused_ffn(*args)
    assert ffn.fused_ffn.launches == before

"""The port's attention-output block (``kernels/ffn.py`` ``fused_out_ln``,
``out_ln_reference``) against the JAX ``fused_out_ln`` it replaces (the
Pallas kernel ``_make_out_ln`` in interpret mode on the CPU), its gradients
against ``jax.grad`` of the JAX custom VJP, and the switched ``AttOutput``
(``set_out_ln_kernel``) against the JAX ``AttOutput`` and the port's
unswitched block.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against ``out_ln_reference`` there); on the CPU
the wrapper takes the plain version, which is what these tests hold.

Tolerances: f32 1e-5; bf16 3e-2 (the JAX package's FFN-kernel tolerance,
tests/test_pallas_ffn.py:41-43); gradients 1e-4 (tests/test_pallas_ffn.py
:218-241); the module 1e-4 (as the other layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import ffn as jax_ffn
from shgvqa_tpu.models import layers as jlayers
from shgvqa_tpu_torch.kernels.ffn import fused_out_ln, out_ln_reference
from shgvqa_tpu_torch.models import layers
from test_torch_common import close, jax_variables, load_port, t


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


def test_wrapper_raises_on_bad_shapes_dtypes_and_devices():
    x, w, b, res, gamma, beta = _port_args(*_data(8, 32))
    with pytest.raises(ValueError, match="residual"):
        fused_out_ln(x, w, b, res[:4], gamma, beta)

    # the card's checks, reached before any launch on a device that is not
    # the CPU
    def meta(*ts, dtype=None):
        return [a.to(device="meta", dtype=dtype or a.dtype) for a in ts]

    bf16 = torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fused_out_ln(*meta(x, w, b, res, gamma, beta))
    xs, ws, rs = meta(x[:, :24], w[:24, :24], res[:, :24], dtype=bf16)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_out_ln(xs, ws, b[:24], rs, gamma[:24], beta[:24])
    xm, wm, rm = meta(x, w, res, dtype=bf16)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        fused_out_ln(xm, wm, b, rm, gamma, beta)

"""The port's fused FFN (shgvqa_tpu_torch/kernels/ffn.py) against the JAX
package's Pallas kernel (shgvqa_tpu/kernels/ffn.py, interpret mode on the
CPU) and FFN module.  On the card ``fused_ffn`` launches the forward chain
of csrc/ffn_train.cu at rate 0, which runs only there (chip_smoke.py holds
it against ``ffn_reference``); on the CPU the wrapper takes the plain
version, which is what these tests hold to JAX.  The card path's host side
(the C entry's arguments, the buffers, the launch counts, the widths it
takes) is driven here on CPU tensors with the C entry replaced by a
stand-in.

Tolerances: bf16 3e-2 (as tests/test_pallas_ffn.py; the TPU kernel's erf
is a polynomial, the port's is erf); f32 1e-5."""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu.models.layers import FFN as JaxFFN
from shgvqa_tpu_torch.kernels import ffn
from shgvqa_tpu_torch.models.layers import FFN
from test_torch_common import close, jax_variables, load_port, t, tensor_at


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


def _stand_in_chain(monkeypatch, calls, fill=None):
    """Replace the chain's library by a stand-in whose forward entry records
    its arguments and fills y, h and o + b2 from ``fill`` (a dict)."""
    def forward_entry(*c_args):
        calls.append(c_args)
        m, d, f = c_args[11:14]
        if fill is not None:
            shapes = (((m, d), torch.bfloat16), ((m, f), torch.bfloat16),
                      ((m, d), torch.float32))
            for (shape, dtype), ptr, name in zip(shapes, c_args[8:11],
                                                 ("y", "h", "o")):
                tensor_at(ptr, shape, dtype).copy_(fill[name])
        return 0

    lib = SimpleNamespace(shgvqa_ffn_train_fwd_bf16=forward_entry,
                          shgvqa_ffn_train_max_d=lambda: 768)
    monkeypatch.setattr(ffn, "_train_lib", lambda: lib)
    monkeypatch.setattr(ffn, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())


def test_card_path_runs_the_train_forward_chain_at_rate_0(monkeypatch):
    """The card path of fused_ffn on CPU tensors, the chain's C entry
    replaced by a stand-in: one call of shgvqa_ffn_train_fwd_bf16 with the
    operands in order, no seed, threshold 0, keep scale 1 and dropout off,
    and the forward's buffers (y and h bf16, o + b2 f32); y comes back from
    the buffer the entry wrote; fused_ffn.launches counts the call and
    fused_ffn_train's counts stay; the backward recomputes through the plain
    version."""
    m, d, f = 24, 64, 256
    args = [x.contiguous() for x in _torch_args(_data(m, d, f, seed=5),
                                                torch.bfloat16)]
    _, h, _ = ffn._residual(*args[:5], 0.0, None)
    fill = {"y": ffn.ffn_reference(*args), "h": h,
            "o": torch.matmul(h.float(), args[3].float().t()) + args[4]}
    calls = []
    _stand_in_chain(monkeypatch, calls, fill)
    before = (ffn.fused_ffn.launches, ffn.fused_ffn_train.launches,
              ffn.fused_ffn_train.bwd_launches)
    leaves = [a.detach().requires_grad_(i == 0) for i, a in enumerate(args)]
    y = ffn._FusedFFN.apply(*leaves, 1e-6)
    assert len(calls) == 1
    c_args = calls[0]
    assert c_args[:8] == tuple(a.data_ptr() for a in args) + (None,)
    assert c_args[11:] == (m, d, f, 1e-6, 0, 1.0, 0, 0, 0)   # row0 0
    assert torch.equal(y, fill["y"])
    assert (ffn.fused_ffn.launches, ffn.fused_ffn_train.launches,
            ffn.fused_ffn_train.bwd_launches) == (before[0] + 1, *before[1:])
    (grad,) = torch.autograd.grad(y.float().sum(), leaves[0])
    ref = args[0].detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        ffn.ffn_reference(ref, *args[1:], 1e-6).float().sum(), ref)
    close(grad, want.float(), 1e-6)


@pytest.mark.parametrize("d,f,ok", [(768, 3072, True), (64, 128, True),
                                    (64, 208, False), (96, 256, False),
                                    (832, 3072, False)])
def test_card_path_takes_the_widths_of_the_chain(monkeypatch, d, f, ok):
    """The card path takes D a multiple of 64 up to 768 and F a multiple of
    128 (the chain's tiles; the old kernel took multiples of 16) and raises
    with the wrapper's name otherwise, before any launch; f32 raises with
    the switch to turn off."""
    calls = []
    _stand_in_chain(monkeypatch, calls)
    bf16 = torch.bfloat16
    ops = (torch.zeros(4, d, dtype=bf16), torch.zeros(f, d, dtype=bf16),
           torch.zeros(f), torch.zeros(d, f, dtype=bf16), torch.zeros(d),
           torch.ones(d), torch.zeros(d))
    before = ffn.fused_ffn.launches
    if ok:
        ffn._launch(*ops, 1e-12)
        assert len(calls) == 1 and ffn.fused_ffn.launches == before + 1
    else:
        with pytest.raises(ValueError, match="fused_ffn: D=.*multiple of 64"):
            ffn._launch(*ops, 1e-12)
        assert not calls and ffn.fused_ffn.launches == before
    with pytest.raises(NotImplementedError, match="use_pallas_ffn=False"):
        ffn._launch(*(o.float() for o in ops), 1e-12)

"""The port's tokenizer conv (shgvqa_tpu_torch/kernels/tok_conv.py) against
the JAX Pallas prototype it replaces (tools/proto_tok_kernel.py, interpret
mode on the CPU, and its XLA reference) and the switched VisualTokenizer
against the JAX module.  The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against ``tok_conv_reference`` there); on the CPU
the wrapper takes the plain version, which is what these tests hold.

Tolerances: f32 1e-5 (the prototype's erf is the A-S polynomial, within
1.5e-7 of ``torch.erf``); bf16 2e-2 of max |ref| (the prototype's own
check, proto_tok_kernel.py:166); the module 1e-4 (as the other layers)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.models import visual as jvis
from shgvqa_tpu_torch.kernels import tok_conv
from shgvqa_tpu_torch.models import visual
from shgvqa_tpu_torch.models.layers import init_weights
from test_torch_common import close, jax_variables, load_port, t

REPO = Path(__file__).resolve().parent.parent


def _proto():
    spec = importlib.util.spec_from_file_location(
        "proto_tok_kernel", REPO / "tools" / "proto_tok_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(bsz, seed=0, t_len=8, s=7, ci=256, co=128):
    """numpy f32 operands; w in the prototype's (kT, 3, 3, Ci, Co)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, t_len, s, s, ci).astype(np.float32) * 0.1,
            rng.randn(5, 3, 3, ci, co).astype(np.float32) * 0.01,
            rng.randn(co).astype(np.float32) * 0.1)


def _port_weight(w):
    """(kT, 3, 3, Ci, Co) -> the port's Conv3d layout (Co, Ci, kT, 3, 3)."""
    return np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("bsz", [1, 2])
def test_plain_version_matches_prototype_f32(bsz):
    proto = _proto()
    x, w, b = _data(bsz, seed=bsz)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    want = np.asarray(proto.fused_tok_conv(jx, jw, jb, interpret=True))
    got = tok_conv.tok_conv_reference(t(x), t(_port_weight(w)), t(b))
    assert got.shape == (bsz, 4, 7, 7, 128) and got.dtype == torch.float32
    close(got, want, 1e-5)
    close(got, proto._xla_reference(jx, jw, jb), 1e-5)


def test_plain_version_matches_prototype_bf16():
    proto = _proto()
    x, w, b = _data(2, seed=3)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = proto.fused_tok_conv(jx, jw, jnp.asarray(b), interpret=True)
    args = (t(x, torch.bfloat16), t(_port_weight(w), torch.bfloat16), t(b))
    got = tok_conv.tok_conv_reference(*args)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want) <= 2e-2
    assert _rel_err(got.float(), proto._xla_reference(jx, jw, jnp.asarray(b))
                    ) <= 2e-2
    # the wrapper casts the weight to x's dtype and takes the plain version
    close(tok_conv.fused_tok_conv(*args), got.float(), 0.0)


def test_plain_version_without_gelu_matches_xla_reference():
    proto = _proto()
    x, w, b = _data(1, seed=4, t_len=6, s=5, ci=64, co=32)
    want = proto._xla_reference(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), gelu=False)
    close(tok_conv.fused_tok_conv(t(x), t(_port_weight(w)), t(b), gelu=False),
          want, 1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_visual_tokenizer_switch_matches_jax(use_kernel):
    feats = np.random.RandomState(10).randn(2, 10, 3, 3, 16).astype(
        np.float32)
    mod = jvis.VisualTokenizer(hidden_size=32)
    v = jax_variables(mod, feats)
    port = load_port(visual.VisualTokenizer(16, 32, 2 * 9 + 1), v)
    visual.set_tok_kernel(port, use_kernel)
    assert port.use_kernel is use_kernel
    with torch.no_grad():
        got = port(t(feats))
    assert got.shape == (2, 19, 32)
    close(got, mod.apply(v, feats), 1e-4)


def test_tokenizer_takes_the_kernel_only_outside_training(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return tok_conv.tok_conv_reference(args[0], args[1].to(args[0].dtype),
                                           args[2])

    monkeypatch.setattr(visual, "fused_tok_conv", counted)
    tok = init_weights(visual.VisualTokenizer(64, 32, 2 * 9 + 1)).eval()
    visual.set_tok_kernel(tok, True)
    feats = torch.randn(2, 10, 3, 3, 64)
    with torch.no_grad():
        tok(feats)
    assert calls == [(2, 10, 3, 3, 64), (2, 6, 3, 3, 32)]
    tok.train()
    tok(feats)
    assert len(calls) == 2


def test_wrapper_raises_on_bad_shapes_dtypes_and_grad():
    x = torch.randn(1, 8, 7, 7, 64)
    w = torch.randn(32, 64, 5, 3, 3)
    b = torch.randn(32)
    with pytest.raises(ValueError, match="do not fit"):
        tok_conv.fused_tok_conv(x, w[:, :32], b)
    with pytest.raises(ValueError, match="do not fit"):
        tok_conv.fused_tok_conv(x[:, :4], w, b)
    with pytest.raises(ValueError, match=r"\(Co, Ci, kT, 3, 3\)"):
        tok_conv.fused_tok_conv(x, w[..., :2], b)
    with pytest.raises(RuntimeError, match="forward only"):
        tok_conv.fused_tok_conv(x, w.requires_grad_(True), b)
    w.requires_grad_(False)
    # the card's checks, reached before any launch on a device that is not
    # the CPU
    def meta(a, dtype=torch.float32):
        return a.to(device="meta", dtype=dtype)

    bf16 = torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tok_conv.fused_tok_conv(meta(x), meta(w), meta(b))
    with pytest.raises(ValueError, match="multiple of 64"):
        tok_conv.fused_tok_conv(meta(x[..., :32], bf16), meta(w[:, :32]),
                                meta(b))
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        tok_conv.fused_tok_conv(meta(x, bf16), meta(w), meta(b))

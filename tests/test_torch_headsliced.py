"""The port's head-sliced attention (``kernels/headsliced.py``) against the
JAX Pallas prototype it replaces (``tools/proto_headsliced_attn.py``
``make_headsliced``, interpret mode on the CPU) and against the JAX fused
attention (interpret mode) through transposes; the switched ``Attention``
and ``TorchMHA`` (``set_headsliced_kernel``) against their plain paths; the
mask contract; and the card-side launch helper, driven on CPU tensors with
the attention forward's C entry replaced by a stand-in, passing the
projections' own strides.  The CUDA kernel itself (the attention forward of
``csrc/attention.cu``) runs only on the card (``chip_smoke.py`` holds it
against ``headsliced_reference`` and bit-equal to the transpose path
there); on the CPU the wrapper takes the plain version, which is what the
other tests hold.

Tolerances: against the prototype 1e-5 f32 and 2e-2 bf16 (its probabilities
are rounded to bf16 before the PV product, as the plain version's); against
the JAX fused attention 2e-4 (tests/test_pallas_attention.py's own); the
switched modules 1e-5 (f32, the same products)."""

import contextlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import attention as jax_attention
from shgvqa_tpu_torch.data.featurize import situation_causal_mask
from shgvqa_tpu_torch.kernels import attention, headsliced
from shgvqa_tpu_torch.kernels.attention import fused_attention
from shgvqa_tpu_torch.kernels.headsliced import (
    headsliced_attention,
    headsliced_reference,
)
from shgvqa_tpu_torch.models import decoder, layers
from test_torch_common import close, t, tensor_at

REPO = Path(__file__).resolve().parent.parent


def _proto():
    spec = importlib.util.spec_from_file_location(
        "proto_headsliced_attn", REPO / "tools" / "proto_headsliced_attn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masks(kind, b, lq, lk, rng):
    """(key row (B, Lk), pane (Lq, Lk)) numpy f32, either all zeros: a key
    row masking random keys by -10000, or the situation-causal -inf pane."""
    key = np.zeros((b, lk), np.float32)
    pane = np.zeros((lq, lk), np.float32)
    if kind == "key":
        key[rng.rand(b, lk) < 0.3] = -10000.0
    else:
        pane = situation_causal_mask(lq // 2, 2)
    return key, pane


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,lq,lk", [("key", 5, 7), ("pane", 6, 6)])
def test_reference_matches_prototype_interpret(kind, lq, lk, dtype):
    rng = np.random.RandomState(lq * lk)
    b, h, d = 2, 2, 8
    q, k, v = (rng.randn(b, n, h * d).astype(np.float32)
               for n in (lq, lk, lk))
    key, pane = _masks(kind, b, lq, lk, rng)
    jdt = jnp.dtype(dtype)
    want = _proto().make_headsliced(h, interpret=True)(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(key[:, None, :]), jnp.asarray(pane))
    tdt = getattr(torch, dtype)
    got = headsliced_reference(t(q, tdt), t(k, tdt), t(v, tdt), t(key),
                               t(pane), heads=h)
    assert got.dtype == tdt and got.shape == (b, lq, h * d)
    if dtype == "float32":
        close(got, np.asarray(want, np.float32), 1e-5)
    else:
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-2, err


def _mask4(kind, b, lq, lk):
    if kind == "key":
        m = np.zeros((b, 1, 1, lk), np.float32)
        m[1, ..., lk - lk // 4:] = -10000.0
        return m
    if kind == "pane":
        return np.triu(np.full((lq, lk), -np.inf, np.float32), k=1)
    return None


CASES = [("key", 40, 57, 16), ("pane", 24, 24, 16), ("none", 40, 57, 64)]


@pytest.mark.parametrize("kind,lq,lk,d", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-d{c[3]}" for c in CASES])
def test_matches_jax_fused_attention_through_transposes(kind, lq, lk, d):
    rng = np.random.RandomState(lq + lk + d)
    b, h = 2, 3
    q, k, v = (rng.randn(b, n, h * d).astype(np.float32)
               for n in (lq, lk, lk))
    mask = _mask4(kind, b, lq, lk)

    def heads_first(x):
        return jnp.asarray(x.reshape(b, -1, h, d).transpose(0, 2, 1, 3))

    want = jax_attention.fused_attention(
        heads_first(q), heads_first(k), heads_first(v),
        None if mask is None else jnp.asarray(mask), interpret=True)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, lq, h * d)
    got = headsliced_attention(t(q), t(k), t(v),
                               None if mask is None else t(mask), h)
    close(got, want, 2e-4)


def _switched(module, *args, mask=None):
    """``module`` (eval, no grad) on ``args`` with the head-sliced switch
    off, then on."""
    with torch.no_grad():
        outs = []
        for on in (False, True):
            layers.set_headsliced_kernel(module, on)
            outs.append(module(*args, mask))
    return outs


@pytest.mark.parametrize("kind", ["key", "none"])
def test_attention_switch_matches_plain_path(kind, monkeypatch):
    calls = []
    monkeypatch.setattr(layers, "headsliced_attention",
                        lambda *a: calls.append(1) or headsliced_attention(*a))
    rng = np.random.RandomState(4)
    model = layers.init_weights(layers.Attention(32, 4, 8), 1).eval()
    hidden, context = (t(rng.randn(2, n, 32).astype(np.float32))
                       for n in (9, 13))
    mask = t(_mask4(kind, 2, 9, 13)) if kind == "key" else None
    plain, got = _switched(model, hidden, context, mask=mask)
    assert calls == [1]
    close(got, plain.numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["pane", "none"])
def test_torch_mha_switch_matches_plain_path(kind, monkeypatch):
    calls = []
    monkeypatch.setattr(decoder, "headsliced_attention",
                        lambda *a: calls.append(1) or headsliced_attention(*a))
    rng = np.random.RandomState(5)
    model = layers.init_weights(decoder.TorchMHA(32, 4), 2).eval()
    lk = 12 if kind == "pane" else 7
    query = t(rng.randn(2, 12, 32).astype(np.float32))
    memory = t(rng.randn(2, lk, 32).astype(np.float32))
    mask = (t(situation_causal_mask(6, 2)) if kind == "pane" else None)
    plain, got = _switched(model, query, memory, memory, mask=mask)
    assert calls == [1]
    close(got, plain.numpy(), 1e-5)


def test_switch_is_read_outside_training_only(monkeypatch):
    monkeypatch.setattr(layers, "headsliced_attention",
                        lambda *a: pytest.fail("kernel in training"))
    model = layers.init_weights(layers.Attention(32, 4, 8), 1).train()
    layers.set_headsliced_kernel(model, True)
    x = torch.randn(2, 5, 32)
    assert model(x, x).shape == (2, 5, 32)


def test_unsupported_masks_and_gradients_raise():
    q = torch.randn(2, 5, 24)
    k = torch.randn(2, 7, 24)
    with pytest.raises(ValueError, match="unsupported mask"):
        headsliced_attention(q, k, k, torch.zeros(2, 3, 5, 7), 3)
    with pytest.raises(ValueError, match="unsupported mask"):
        headsliced_attention(q, k, k, torch.zeros(2, 1, 5, 7), 3)
    with pytest.raises(ValueError, match="multiple of 5 heads"):
        headsliced_attention(q, k, k, None, 5)
    with pytest.raises(RuntimeError, match="forward only"):
        headsliced_attention(q.requires_grad_(True), k, k, None, 3)


def test_card_side_checks_on_meta():
    def meta(*ts, dtype=torch.bfloat16):
        return [x.to(device="meta", dtype=dtype) for x in ts]

    q, k = torch.randn(2, 5, 24), torch.randn(2, 7, 24)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        headsliced_attention(*meta(q, k, k, dtype=torch.float32), None, 3)
    with pytest.raises(ValueError, match="head dim 64"):
        headsliced_attention(*meta(q, k, k), None, 3)
    q, k = torch.randn(2, 5, 128), torch.randn(2, 7, 128)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        headsliced_attention(*meta(q, k, k), None, 2)


@pytest.mark.parametrize("kind", ["key", "pane"])
def test_launch_runs_the_attention_forward_on_the_projection_strides(
        kind, monkeypatch):
    """The card-side launch helper on CPU tensors, with the attention
    library's forward C entry replaced by a stand-in that records its
    arguments and fills the output from headsliced_reference: one call of
    the rate-0 instance on the (B, L, H*64) strides of q, k, v and o (batch
    L*H*64, head 64, row H*64), the operands and masks passed without a
    copy, one head-sliced launch counted and no fused_attention launch."""
    b, lq, lk, heads = 2, 5, 7, 3
    hd = heads * 64
    rng = np.random.RandomState(11)
    q2, k2, v2 = (t(rng.randn(b, n, hd).astype(np.float32), torch.bfloat16)
                  for n in (lq, lk, lk))
    key = pane = None
    if kind == "key":
        key = t(np.where(rng.rand(b, lk) < 0.3, -10000.0, 0.0)
                .astype(np.float32))
    else:
        pane = t(np.triu(np.full((lq, lk), -np.inf, np.float32), k=1))
    want = headsliced_reference(q2, k2, v2, key, pane, heads=heads)
    calls = []

    def forward_entry(q, k, v, key_ptr, pane_ptr, seed, o, lse, strides,
                      batch, h, nq, nk, scale, threshold, inv_keep, dropout,
                      group0, heads_global, head0, stream):
        calls.append(dict(ptrs=(q, k, v, key_ptr, pane_ptr, seed),
                          strides=list(strides), shape=(batch, h, nq, nk),
                          rate=(scale, threshold, inv_keep, dropout)))
        tensor_at(o, (batch, nq, h * 64), torch.bfloat16).copy_(want)
        tensor_at(lse, (batch * h, nq), torch.float32).zero_()
        return 0

    monkeypatch.setattr(attention, "_lib", lambda: SimpleNamespace(
        shgvqa_attention_fwd_bf16=forward_entry))
    monkeypatch.setattr(headsliced, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    launches = headsliced_attention.launches, fused_attention.launches
    out = headsliced._launch(q2, k2, v2, key, pane, heads)
    assert len(calls) == 1
    call = calls[0]
    mask_ptr = (lambda m: None if m is None else m.data_ptr())
    assert call["ptrs"] == (q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                            mask_ptr(key), mask_ptr(pane), None)
    q_strides, k_strides = [lq * hd, 64, hd], [lk * hd, 64, hd]
    assert call["strides"] == q_strides + k_strides + k_strides + q_strides
    assert call["shape"] == (b, heads, lq, lk)
    assert call["rate"] == (0.125, 0, 1.0, 0)
    assert out.shape == (b, lq, hd) and out.dtype == torch.bfloat16
    assert torch.equal(out, want)
    assert (headsliced_attention.launches, fused_attention.launches) == (
        launches[0] + 1, launches[1])

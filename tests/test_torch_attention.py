"""The port's fused attention (kernels/attention.py) on the CPU, where it
runs its plain version: held to the JAX ``fused_attention`` in Pallas
interpret mode at rate 0, forward and gradients, over the mask shapes the
model uses (key row, -inf causal pane, none) and ragged lengths; the
kernels' backward algorithm (``attention_backward_reference``) against
autograd; dropout with one explicit mask in forward and backward; and the
training attention sites routed through ``fused_attention``.

The CUDA kernels themselves run only on the card (``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.kernels import attention as jax_attention
from shgvqa_tpu_torch.kernels import attention
from shgvqa_tpu_torch.kernels.attention import (
    attention_backward_reference,
    attention_reference,
    decompose_mask,
    fused_attention,
)
from shgvqa_tpu_torch.models import layers
from test_torch_common import close, t

FWD_TOL, GRAD_TOL = 2e-4, 2e-3     # tests/test_pallas_attention.py's own


def _mask(kind, b, lq, lk):
    if kind == "key":
        m = np.zeros((b, 1, 1, lk), np.float32)
        m[1, ..., lk - lk // 4:] = -10000.0
        return m
    if kind == "pane":
        return np.triu(np.full((lq, lk), -np.inf, np.float32), k=1)
    return None


CASES = [("key", 40, 40, 16), ("pane", 24, 24, 16), ("none", 40, 57, 16),
         ("key", 57, 40, 64), ("pane", 48, 48, 64)]


@pytest.mark.parametrize("kind,lq,lk,d", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-d{c[3]}" for c in CASES])
def test_reference_and_grads_match_jax_kernel_interpret(kind, lq, lk, d):
    rng = np.random.RandomState(lq + lk + d)
    b, h = 2, 3
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    w = rng.randn(b, h, lq, d).astype(np.float32)
    mask = _mask(kind, b, lq, lk)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        out = jax_attention.fused_attention(q, k, v, jmask, interpret=True)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    tmask = None if mask is None else t(mask)
    got = attention_reference(tq, tk, tv, tmask)
    grads = torch.autograd.grad(got, (tq, tk, tv), t(w))
    close(got, want, FWD_TOL)
    for gr, jg in zip(grads, jgrads):
        close(gr, jg, GRAD_TOL)
    # the backward kernels' algorithm (lse recompute, delta = rowsum(dO*O))
    for gr, jg in zip(attention_backward_reference(
            t(q), t(k), t(v), tmask, 0.0, None, got.detach(), t(w)), jgrads):
        close(gr, jg, GRAD_TOL)


@pytest.mark.parametrize("rate", [0.1, 0.15, 0.5])
def test_dropout_one_mask_in_forward_and_backward(rate):
    """The explicit-mask plain version drops with the given mask, and the
    backward algorithm with the same mask equals autograd through it."""
    rng = np.random.RandomState(int(rate * 100))
    b, h, lq, lk, d = 2, 3, 40, 57, 16
    q, k, v = (t(rng.randn(b, h, n, d).astype(np.float32))
               for n in (lq, lk, lk))
    do = t(rng.randn(b, h, lq, d).astype(np.float32))
    mask = t(_mask("key", b, lq, lk))
    keep = t(rng.rand(b, h, lq, lk) >= rate)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = attention_reference(qg, kg, vg, mask, rate, keep)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    for gr, want in zip(grads, attention_backward_reference(
            q, k, v, mask, rate, keep, out.detach(), do)):
        close(gr, want, 1e-5)
    # the mask acts on the normalized probabilities, kept ones scaled
    s = torch.matmul(q, k.transpose(-1, -2)) / d ** 0.5 + mask
    p = torch.where(keep, torch.softmax(s, -1) / (1 - rate), 0.0)
    close(out, torch.matmul(p, v), 1e-5)


def test_cpu_tensors_take_the_plain_version_with_generator_drawn_mask():
    rng = np.random.RandomState(3)
    b, h, l, d, rate = 2, 4, 128, 16, 0.1
    q, k, v = (t(rng.randn(b, h, l, d).astype(np.float32)) for _ in range(3))
    pane = t(_mask("pane", b, l, l))
    out1 = fused_attention(q, k, v, pane, rate,
                           torch.Generator().manual_seed(5))
    out2 = fused_attention(q, k, v, pane, rate,
                           torch.Generator().manual_seed(5))
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    keep = torch.rand((b, h, l, l),
                      generator=torch.Generator().manual_seed(5)) >= rate
    close(out1, attention_reference(q, k, v, pane, rate, keep), 1e-6)
    close(fused_attention(q, k, v, pane), attention_reference(q, k, v, pane),
          0.0)
    # keep rate within 6 binomial standard deviations of 1 - rate
    kept = keep.float().mean().item()
    assert abs(kept - (1 - rate)) < 6 * np.sqrt(rate * (1 - rate) / keep.numel())
    assert fused_attention.launches == 0 and fused_attention.bwd_launches == 0


def test_mask_decomposition_and_unsupported_shapes():
    b, h, lq, lk = 2, 3, 5, 7
    key = torch.randn(b, 1, 1, lk)
    k_row, pane = decompose_mask(key, b, h, lq, lk)
    assert pane is None and torch.equal(k_row, key[:, 0, 0])
    shared = torch.randn(lq, lk)
    k_row, pane = decompose_mask(shared, b, h, lq, lk)
    assert k_row is None and torch.equal(pane, shared)
    assert decompose_mask(None, b, h, lq, lk) == (None, None)
    for bad in (torch.randn(b, h, lq, lk), torch.randn(b, 1, lq, lk),
                torch.randn(lk)):
        with pytest.raises(ValueError, match="unsupported mask shape"):
            decompose_mask(bad, b, h, lq, lk)
    with pytest.raises(ValueError, match="dropout_rate"):
        fused_attention(torch.zeros(1, 1, 2, 4), torch.zeros(1, 1, 2, 4),
                        torch.zeros(1, 1, 2, 4), None, 1.0)


@pytest.mark.parametrize("rate", [0.1, 0.15])
def test_dropout_threshold_matches_the_tpu_kernel(rate):
    want = np.uint32(min(2 ** 32 - 1, int(round(rate * 2.0 ** 32))))
    assert attention._threshold(rate) == int(want)


def test_dropout_module_keep_rate_in_training_only():
    drop = layers.Dropout(0.1)
    x = torch.ones(64, 40, 96)
    g = torch.Generator().manual_seed(0)
    assert drop.eval()(x, g) is x
    y = drop.train()(x, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 6 * np.sqrt(0.09 / x.numel())
    close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9), 1e-6)
    layers.set_dropout_rate(torch.nn.Sequential(drop), 0.0)
    assert drop(x, g) is x


def test_training_attention_sites_route_through_fused_attention(monkeypatch):
    """In training every attention site of a BertLayer and a decoder layer
    calls fused_attention at its dropout rate; in eval mode none does, and
    with the kernel switched off training takes the plain path."""
    from shgvqa_tpu_torch.models.decoder import DecoderLayer

    calls = []

    def spy(q, k, v, mask=None, rate=0.0, g=None):
        calls.append(rate)
        return fused_attention(q, k, v, mask, rate, g)

    monkeypatch.setattr(layers, "fused_attention", spy)
    torch.manual_seed(0)
    bert = layers.init_weights(layers.BertLayer(
        32, 4, 8, 64, attn_dropout=0.1, kernel_train=True))
    dec = layers.init_weights(DecoderLayer(32, 4, 64, dropout=0.15,
                                           kernel_train=True))
    x, mem = torch.randn(2, 12, 32), torch.randn(2, 9, 32)
    g = torch.Generator().manual_seed(1)
    for on in (True, False):
        layers.set_attention_kernel(bert, on)
        layers.set_attention_kernel(dec, on)
        bert.train()(x, None, g)
        dec.train()(x, mem, x, None, None, g)
    bert.eval()(x)
    dec.eval()(x, mem, x)
    assert calls == [0.1, 0.15, 0.15]

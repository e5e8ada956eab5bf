"""The port's fused attention (kernels/attention.py) on the CPU, where it
runs its plain version: held to the JAX ``fused_attention`` in Pallas
interpret mode at rate 0, forward and gradients, over the mask shapes the
model uses (key row, -inf causal pane, none) and ragged lengths; the
kernels' backward algorithm (``attention_backward_reference``) against
autograd; dropout with one explicit mask in forward and backward; the
kernels' Philox counter layout and ``keep_mask_reference`` (known answers,
one lane per call in both tile layouts, keep rate, threshold); and the
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
    keep_counter,
    keep_mask_reference,
    philox4x32,
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


# Random123's known-answer vectors for Philox4x32-10: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    words = philox4x32([torch.tensor([c], dtype=torch.int64)
                        for c in counter], key)
    assert tuple(int(w) for w in words) == want


def test_keep_counter_gives_every_pair_its_own_call_word():
    """Every (query, key) of a ragged block reads its own (counter, word),
    and a call's four words decide queries {q, q + 8} x keys {k, k + 8}."""
    lq, lk = 177, 393
    q, k = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    cq, ck, word = keep_counter(q, k)
    cq, ck = cq.expand(lq, lk), ck.expand(lq, lk)
    triples = torch.stack([cq, ck, word], -1).reshape(-1, 3)
    assert torch.unique(triples, dim=0).shape[0] == lq * lk
    assert int(word.min()) == 0 and int(word.max()) == 3
    for qq, kk in ((0, 0), (23, 37), (170, 390)):
        base = keep_counter(qq, kk)[:2]
        block = {(qq - qq % 16 + qq % 8 + 8 * s, kk - kk % 16 + kk % 8 + 8 * t)
                 for s in (0, 1) for t in (0, 1)}
        assert {p for p in block if keep_counter(*p)[:2] == base} == block
        assert sorted(keep_counter(*p)[2] for p in block) == [0, 1, 2, 3]


def _owner(rows, cols, row, col):
    """(block tile of rows, of cols, warp, lane, n8 tile j, register e) of
    element (row, col) in the kernels' m16n8k16 accumulator layout: 64-row
    blocks of 4 warps, 16 rows a warp, 64-column tiles."""
    return (row // rows, col // cols, (row % rows) // 16,
            (row % 8) * 4 + (col % 8) // 2, (col % cols) // 8,
            2 * ((row % 16) // 8) + col % 2)


@pytest.mark.parametrize("rows_are", ["queries", "keys"])
def test_keep_call_belongs_to_one_lane_in_both_tile_layouts(rows_are):
    """The forward's tiles have query rows, the backward's S^T tiles key
    rows: in both, the four (query, key) pairs of a Philox call sit in one
    lane, and the counter and word that lane computes (the formulas of
    csrc/attention.cu) are keep_counter's."""
    lq, lk = 93, 70
    owners = {}
    for q in range(lq):
        for k in range(lk):
            row, col = (q, k) if rows_are == "queries" else (k, q)
            r_tile, c_tile, warp, lane, j, e = _owner(64, 64, row, col)
            g, c, half, x = lane // 4, 2 * (lane % 4), e // 2, e % 2
            row_word = (((r_tile * 64 + warp * 16) >> 4) << 3) | g
            col_word = (((c_tile * 64 + (j // 2) * 16) >> 4) << 3) | (c + x)
            if rows_are == "queries":
                lane_call = (row_word, col_word, 2 * half + j % 2)
            else:
                lane_call = (col_word, row_word, 2 * (j % 2) + half)
            assert lane_call == keep_counter(q, k)
            owners.setdefault(lane_call[:2], set()).add(
                (r_tile, c_tile, warp, lane))
    assert all(len(o) == 1 for o in owners.values())


def test_keep_mask_reference_matches_per_element_philox():
    seed = torch.tensor([0x123456789AB, 0x7FEDCBA98765])
    groups, lq, lk, rate = 3, 40, 57, 0.15
    got = keep_mask_reference(seed, groups, lq, lk, rate)
    key = [int(w) & 0xFFFFFFFF for w in seed.tolist()]
    gi, q, k = torch.meshgrid(torch.arange(groups), torch.arange(lq),
                              torch.arange(lk), indexing="ij")
    cq, ck, word = keep_counter(q, k)
    words = torch.stack(philox4x32((cq, ck, gi, torch.zeros_like(gi)),
                                   key), -1)
    bits = words.gather(-1, word[..., None])[..., 0]
    assert torch.equal(got, bits >= attention._threshold(rate))


@pytest.mark.parametrize("rate", [0.1, 0.15])
def test_keep_mask_reference_keep_rate_and_tpu_threshold(rate):
    """The keep rate lies within 6 binomial sigma of 1 - rate, and a word
    is kept at and above the TPU kernel's threshold round(rate * 2^32)
    (shgvqa_tpu/kernels/attention.py:137), dropped just below it."""
    keep = keep_mask_reference([11, 12], 8, 128, 128, rate)
    kept = keep.float().mean().item()
    assert abs(kept - (1 - rate)) < 6 * np.sqrt(rate * (1 - rate)
                                                / keep.numel())
    want = int(np.uint32(min(2 ** 32 - 1, int(round(rate * 2.0 ** 32)))))
    assert attention._threshold(rate) == want
    words = philox4x32([torch.zeros(1, dtype=torch.int64)] * 4, (11, 12))
    w = int(words[0])
    ref_rate = (w + 1) / 2.0 ** 32      # threshold w + 1: word w is dropped
    at_rate = w / 2.0 ** 32             # threshold w: word w is kept
    assert not bool(keep_mask_reference([11, 12], 1, 1, 1, ref_rate)[0, 0, 0])
    assert bool(keep_mask_reference([11, 12], 1, 1, 1, at_rate)[0, 0, 0])


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

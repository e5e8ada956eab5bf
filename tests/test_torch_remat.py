"""``--remat`` / ``--rematPolicy`` (models/remat.py) in the port.

- In training with every dropout rate at 0.1, the gradients of the tiny
  hgqa model under each of the four policies equal those without remat
  (rtol 1e-5, atol 1e-6), and the generator ends where a step without
  remat leaves it: the recompute reads the forward's draws back from its
  tape.  Also under ``--scanLayers`` (its cross stack rematerialized) and
  ``--vitInit`` (the ViT r-layers).  (The driver trains with ``--remat``:
  ``test_torch_driver.py::test_driver_refuses_unported_options[remat]``.)
- At dropout 0 the port's remat gradients match the JAX package's remat
  gradients at ``deterministic=True`` (tests/test_perf_knobs.py's
  comparison), one JAX init shared by the four policies.
- The attention and FFN-train kernels' launches a step, counted through
  the stand-in C entries of ``kernels/attention.py`` and ``kernels/ffn.py``
  on a bf16 model with 64-wide heads: every rematerialized attention site
  launches its forward again under '', ``dots`` and ``dots_batch``; under
  ``dots_attn`` its (o, lse) are saved and nothing runs again; every
  rematerialized FFN block runs its forward again under every policy; the
  backward launches as without remat.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.kernels import attention, ffn
from shgvqa_tpu_torch.kernels.attention import fused_attention
from shgvqa_tpu_torch.models import layers
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.remat import POLICIES, remat_call
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.train import step
from test_torch_common import close, t
from test_torch_train_step import _labelled_batch

RTOL, ATOL = 1e-5, 1e-6


def _grads(model, cfg, batch, seed=0):
    """Every parameter's gradient of the step's loss, and the generator's
    state after the step."""
    g = torch.Generator().manual_seed(seed)
    loss, _ = step.compute_losses(cfg, model(batch, g), batch)
    model.zero_grad()
    loss.backward()
    return ({n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}, g.get_state())


def _model(cfg, dropout):
    model = init_weights(ShgVqaModel(cfg), 0).train()
    layers.set_dropout_rate(model, dropout)
    return model


@pytest.mark.parametrize("variant", ["plain", "scan_layers", "vit_init"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_no_remat_at_dropout(policy, variant):
    base = tiny_test_config(task="hgqa")
    if variant != "plain":
        base = base.replace(encoder=dataclasses.replace(
            base.encoder, **{variant: True}))
    batch = {k: t(v) for k, v in _labelled_batch(base).items()}
    plain = _model(base, 0.1)
    want, want_state = _grads(plain, base, batch)
    cfg = base.replace(remat=True, remat_policy=policy)
    model = _model(cfg, 0.1)
    model.load_state_dict(plain.state_dict())
    got, state = _grads(model, cfg, batch)
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, msg=name)
    assert torch.equal(state, want_state)


def test_the_tape_replays_the_draws_and_refuses_a_longer_recompute():
    """A block's recompute reads its draws back (the generator does not
    move), and one that draws more than its forward raises."""
    drop = layers.Dropout(0.5).train()
    g = torch.Generator().manual_seed(1)
    x = torch.ones(4, 8, requires_grad=True)
    y = remat_call(drop, "", x, g)
    after = g.get_state()
    y.sum().backward()
    assert torch.equal(g.get_state(), after)
    assert torch.equal(x.grad, (y != 0).float() * 2.0)

    class Grows(torch.nn.Module):
        calls = 0

        def forward(self, x, g):
            Grows.calls += 1
            for _ in range(Grows.calls):
                x = drop(x, g)
            return x

    # without early stop the recompute runs the whole block
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        y = remat_call(Grows().train(), "", x.detach().requires_grad_(), g)
    with pytest.raises(RuntimeError, match="drew more than the forward"):
        y.sum().backward()


# the outputs a surrogate loss reads: sum(output * fixed weights) over
# them reaches every rematerialized block (the set losses' matching
# would only add compile time to the JAX side)
OUTPUTS = ("logit", "hg_logit", "rel_preds", "act_preds")


def _surrogate(out, weights, xp):
    return sum(xp.sum(out[k] * weights[k]) for k in OUTPUTS)


def _one_layer(cfg):
    """One layer a stack: each JAX remat gradient is one jit compile."""
    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, l_layers=1, r_layers=1,
                                    x_layers=1),
        decoder=dataclasses.replace(cfg.decoder, num_layers=1))


@pytest.fixture(scope="module")
def jax_remat():
    """The port's f32 tiny hgqa model (one layer a stack) at random
    weights, carried into JAX (no JAX init), and JAX's surrogate-loss
    gradients at ``deterministic=True`` under each policy."""
    cfg = _one_layer(tiny_test_config(task="hgqa"))
    jcfg = _one_layer(jax_tiny(task="hgqa"))
    batch = _labelled_batch(jcfg)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(
        init_weights(ShgVqaModel(cfg), 3).state_dict()))
    shapes = jax.eval_shape(lambda v: JaxShgVqaModel(jcfg).apply(v, batch),
                            variables)
    rng = np.random.RandomState(2)
    weights = {k: rng.randn(*shapes[k].shape).astype(np.float32)
               for k in OUTPUTS}
    grads = {}
    for policy in POLICIES:
        m = JaxShgVqaModel(jcfg.replace(remat=True, remat_policy=policy))

        def loss(p, m=m):
            return _surrogate(m.apply(p, batch, deterministic=True),
                              weights, jnp)

        grads[policy] = jax.device_get(jax.jit(jax.grad(loss))(variables))
    return dict(cfg=cfg, batch=batch, variables=variables, grads=grads,
                weights=weights)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_match_jax_remat(jax_remat, policy):
    cfg = jax_remat["cfg"].replace(remat=True, remat_policy=policy)
    model = _model(cfg, 0.0)
    model.load_state_dict(from_jax_variables(jax_remat["variables"], model))
    batch = {k: t(v) for k, v in jax_remat["batch"].items()}
    weights = {k: t(v) for k, v in jax_remat["weights"].items()}
    loss = _surrogate(model(batch, torch.Generator()), weights, torch)
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
    assert len(got) > 0.8 * len(list(model.parameters()))
    want = from_jax_variables(jax_remat["grads"][policy])
    for name, grad in got.items():
        scale = max(want[name].abs().max().item(), 1.0)
        close(grad / scale, want[name] / scale, 1e-4)


def _head64_cfg(**kw):
    """The tiny hgqa model at the kernels' 64-wide heads, bf16."""
    cfg = tiny_test_config(task="hgqa", compute_dtype="bfloat16", **kw)
    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, hidden_size=128,
                                    num_heads=2, intermediate_size=128),
        decoder=dataclasses.replace(cfg.decoder, num_heads=2, ffn_dim=128))


@pytest.fixture
def stand_in_kernels(monkeypatch):
    """Every training attention site and FFN block through the card paths
    (``_card_attention``, ``_card_ffn_train``) on CPU tensors, the C entries
    replaced by stand-ins that write zeros and count their calls."""
    from test_torch_common import tensor_at

    calls = {"fwd": 0, "bwd": 0, "ffn_fwd": 0, "ffn_bwd": 0}

    def fwd(q, k, v, key, pane, seed, o, lse, strides, b, h, lq, lk, *rest):
        calls["fwd"] += 1
        tensor_at(o, (b, lq, h, 64), torch.bfloat16).zero_()
        tensor_at(lse, (b * h, lq), torch.float32).zero_()
        return 0

    def bwd(q, k, v, key, pane, seed, o, lse, do, delta, dq_acc, dq, dk, dv,
            strides, b, h, lq, lk, *rest):
        calls["bwd"] += 1
        for ptr, n in ((dq, lq), (dk, lk), (dv, lk)):
            tensor_at(ptr, (b, n, h, 64), torch.bfloat16).zero_()
        return 0

    def ffn_fwd(x, w1t, b1, w2t, b2, gamma, beta, seed, y, h, o, m, d, f,
                *rest):
        calls["ffn_fwd"] += 1
        tensor_at(y, (m, d), torch.bfloat16).zero_()
        tensor_at(h, (m, f), torch.bfloat16).zero_()
        return 0

    def ffn_bwd(x, w1t, b1, w2t, b2, gamma, seed, dy, dx, du, do, h, gd, dr,
                part, dgb, m, d, f, *rest):
        calls["ffn_bwd"] += 1
        for ptr, shape, dtype in ((dx, (m, d), torch.bfloat16),
                                  (du, (m, f), torch.bfloat16),
                                  (do, (m, d), torch.bfloat16),
                                  (h, (m, f), torch.bfloat16),
                                  (dgb, (2 * d,), torch.float32)):
            tensor_at(ptr, shape, dtype).zero_()
        return 0

    monkeypatch.setattr(attention, "_lib", lambda: SimpleNamespace(
        shgvqa_attention_fwd_bf16=fwd, shgvqa_attention_bwd_bf16=bwd))
    monkeypatch.setattr(ffn, "_train_lib", lambda: SimpleNamespace(
        shgvqa_ffn_train_fwd_bf16=ffn_fwd, shgvqa_ffn_train_bwd_bf16=ffn_bwd,
        shgvqa_ffn_train_max_d=lambda: 1024,
        shgvqa_ffn_train_bwd_rows=lambda: 64))
    for module in (attention, ffn):
        monkeypatch.setattr(module, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())

    def card_attention(q, k, v, mask=None, dropout_rate=0.0, generator=None):
        b, h, lq, _ = q.shape
        key, pane = attention.decompose_mask(mask, b, h, lq, k.shape[2])
        return attention._card_attention(q, k, v, key, pane,
                                         float(dropout_rate), generator, 0)

    def card_ffn(x, w1t, b1, w2t, b2, gamma, beta, dropout_rate,
                 generator=None, eps=1e-12):
        # fused_ffn_train's operands, then its card path
        args = (x.reshape(-1, x.shape[-1]), w1t.to(x.dtype), b1.float(),
                w2t.to(x.dtype), b2.float(), gamma.float(), beta.float())
        return ffn._card_ffn_train(args, float(dropout_rate), generator,
                                   eps, 0).reshape(x.shape)

    monkeypatch.setattr(layers, "fused_attention", card_attention)
    monkeypatch.setattr(layers, "fused_ffn_train", card_ffn)
    return calls


# a tiny hgqa training step with --pallasFFNTrain: 20 attention sites
# forward (2 l, 2 r, 2 x 2 LXRT cross, 2 x 2 HG cross, 2 decoders x 2
# layers x 2) and 12 FFN blocks (2 l, 2 r, 2 x 2 LXRT cross, 2 x 2 HG
# cross); the LXRT cross layers get no gradient under hgqa, so 16 and 8
# backward.  Remat recomputes the l- and r-layers (4 attention sites, 4
# FFN blocks) and the decoders (8 attention sites)
FORWARD, BACKWARD, FFN_FORWARD, FFN_BACKWARD = 20, 16, 12, 8
RECOMPUTED, FFN_RECOMPUTED = 12, 4


@pytest.mark.parametrize("policy", (None,) + POLICIES)
def test_kernel_launches_per_step(stand_in_kernels, policy):
    """Under '', ``dots`` and ``dots_batch`` every rematerialized attention
    site launches its forward again; under ``dots_attn`` its (o, lse) are
    saved and none does.  The FFN-train kernel is opaque to every policy,
    so each recomputes it."""
    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    cfg = _head64_cfg(use_pallas_ffn_train=True, **kw)
    model = init_weights(ShgVqaModel(cfg), 0).train()
    batch = {k: t(v) for k, v in _labelled_batch(cfg).items()}
    before = fused_attention.launches, fused_attention.bwd_launches
    loss, _ = step.compute_losses(
        cfg, model(batch, torch.Generator().manual_seed(0)), batch)
    assert stand_in_kernels == {"fwd": FORWARD, "bwd": 0,
                                "ffn_fwd": FFN_FORWARD, "ffn_bwd": 0}
    loss.backward()
    again = RECOMPUTED if policy in ("", "dots", "dots_batch") else 0
    ffn_again = FFN_RECOMPUTED if policy is not None else 0
    assert stand_in_kernels == {
        "fwd": FORWARD + again, "bwd": BACKWARD,
        "ffn_fwd": FFN_FORWARD + ffn_again, "ffn_bwd": FFN_BACKWARD}
    assert (fused_attention.launches - before[0],
            fused_attention.bwd_launches - before[1]) == (
        FORWARD + again, BACKWARD)

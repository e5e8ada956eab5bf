"""The port's train step (train/step.py) against the JAX ``make_train_step``
at tiny_test_config size in f32, with every dropout rate at 0 on both
sides: the same losses and metrics at each of three steps, the same
connected-parameter mask, and the same parameters after the steps.  Also:
which parameters the port's backward reaches, the attention sites a
training forward routes through ``fused_attention``, and the eval step's
matched class accuracy.

One JAX init and one jitted JAX train step are shared by the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.models import layers
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.train import step
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from test_torch_common import close, load_port, perturb, t
from test_torch_model import _batch

STEPS, LR, T_TOTAL = 3, 1e-3, 10
LOSS_TOL = 1e-4
# Parameters after the steps, per tensor: the change of the port's
# parameters against the change of the JAX ones, |d_port - d_jax| <=
# UPDATE_TOL * |d_jax| (Frobenius), over the elements with a real gradient.
# Adam's m / sqrt(v) turns a gradient at f32 noise level (first moment
# below NOISE x its RMS over all parameters; e.g. the key biases, whose
# gradient is zero in exact arithmetic) into a step of up to lr_t either
# way, so those elements are held only to Adam's largest move.
UPDATE_TOL, NOISE = 1e-4, 1e-5


def _labelled_batch(cfg, seed=0):
    batch = _batch(cfg, seed=seed)
    rng = np.random.RandomState(seed + 1)
    d, b = cfg.data, 2
    s = d.num_situations
    batch.update(
        rel_labels=rng.randint(1, cfg.num_rel_classes + 1,
                               (b, s, d.num_rel)).astype(np.int32),
        rel_lengths=rng.randint(1, d.num_rel + 1, (b, s)).astype(np.int32),
        act_labels=rng.randint(1, cfg.num_act_classes + 1,
                               (b, s, d.num_act)).astype(np.int32),
        act_lengths=rng.randint(1, d.num_act + 1, (b, s)).astype(np.int32),
        target=np.eye(cfg.num_answers, dtype=np.float32)[[1, 4]])
    return batch


def _mask_by_port_name(mask_tree, variables):
    """The JAX mask tree as {port parameter name: bool}, through the
    converter (each leaf becomes an array of its flag)."""
    full = jax.tree_util.tree_map(
        lambda m, v: np.full(np.shape(v), float(m), np.float32),
        mask_tree, jax.device_get(variables))
    return {k: bool(v.all()) for k, v in from_jax_variables(full).items()}


def run_jax_steps(cfg, batch):
    """Three JAX train steps of ``cfg`` on ``batch`` with dropout off
    (flax's Dropout patched to the identity while tracing: the relation
    queries' HGEmbeddings drops at a fixed 0.1 that no config field
    reaches), from one perturbed init, under the connected-parameter
    mask."""
    model = JaxShgVqaModel(cfg)
    init = jax.jit(lambda r, b: model.init(r, b, deterministic=True))
    variables = jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(init(jax.random.PRNGKey(0), batch)),
        np.random.RandomState(1)))
    mask = jax_step.connected_param_mask(variables, cfg)
    tx = jax_make_optimizer(LR, T_TOTAL, trainable_mask=mask)
    mp = pytest.MonkeyPatch()
    mp.setattr(nn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        train_step = jax.jit(jax_step.make_train_step(cfg, model, tx))
        params, opt_state, metrics = variables, tx.init(variables), []
        for i in range(STEPS):
            params, opt_state, m = train_step(params, opt_state, batch,
                                              jax.random.PRNGKey(i))
            metrics.append(jax.device_get(m))
    finally:
        mp.undo()
    return dict(cfg=cfg, batch=batch, variables=variables, mask=mask,
                params=jax.device_get(params), metrics=metrics)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jax_tiny(task="hgqa")
    return run_jax_steps(cfg, _labelled_batch(cfg))


def port_for(jax_run, cfg, dropout=0.0):
    """The port's model of ``cfg`` with ``jax_run``'s initial weights in
    training mode, every dropout at ``dropout``, its optimizer over the
    trainable parameters and the batch as tensors."""
    model = load_port(ShgVqaModel(cfg), jax_run["variables"]).train()
    layers.set_dropout_rate(model, dropout)
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    batch = {k: t(v) for k, v in jax_run["batch"].items()}
    return cfg, model, opt, batch


def _port(jax_run, dropout=0.0):
    return port_for(jax_run, tiny_test_config(task="hgqa"), dropout)


def check_steps_match(jax_run, cfg, model, opt, batch):
    """Three port train steps against ``jax_run``'s: the mask, every
    metric at each step, and each parameter's change (UPDATE_TOL)."""
    assert step.connected_param_mask(model, cfg) == _mask_by_port_name(
        jax_run["mask"], jax_run["variables"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step = step.make_train_step(cfg, model, opt)
    g = torch.Generator().manual_seed(0)
    for want in jax_run["metrics"]:
        got = train_step(batch, g)
        assert set(want) <= set(got)
        for key in want:
            close(got[key], want[key], LOSS_TOL)
    want_params = from_jax_variables(jax_run["params"])
    moments = dict(zip(map(id, opt.params), opt.m))
    rms_m = torch.cat([m.flatten() for m in opt.m]).square().mean().sqrt()
    # the most an element can move by Adam's ratio in these steps
    max_move = sum(opt.lr_at(i) for i in range(STEPS)) * 0.1 / 0.999 ** 0.5 \
        * STEPS ** 0.5
    for name, p in model.named_parameters():
        d_port = p.detach() - before[name]
        d_jax = want_params[name] - before[name]
        if id(p) not in moments:        # frozen or disconnected: untouched
            assert not d_port.any() and not d_jax.any(), name
            continue
        noise = moments[id(p)].abs() < NOISE * rms_m
        err = (d_port - d_jax)[~noise].norm().item()
        assert err <= UPDATE_TOL * d_jax[~noise].norm().item() + 1e-12, \
            (name, err)
        assert ((d_port - d_jax)[noise].abs() <= 2 * max_move).all(), name


def test_train_steps_match_jax(jax_run):
    check_steps_match(jax_run, *_port(jax_run))


def test_backward_reaches_exactly_the_connected_parameters(jax_run):
    """With dropout at the flagship's rates: the LXRT cross layers and
    pooler get no gradient (so no update); every other parameter does."""
    cfg, model, _, batch = _port(jax_run, dropout=0.1)
    loss, metrics = step.compute_losses(
        cfg, model(batch, torch.Generator().manual_seed(0)), batch)
    loss.backward()
    assert torch.isfinite(metrics["total_loss"])
    connected = step.connected_param_mask(model, cfg)
    for name, p in model.named_parameters():
        assert (p.grad is not None) == connected[name], name
    assert not connected["lxrt.pooler.dense2.weight"]
    assert not connected["lxrt.encoder.x_tied.lang_ffn.output.bias"]
    assert connected["hgq_encoder.x_tied.lang_ffn.output.bias"]


def test_training_forward_routes_every_attention_site(jax_run, monkeypatch):
    """A tiny training forward calls fused_attention once per attention
    site: 2 language + 2 visual + 2x2 LXRT cross + 2x2 HG cross + 2
    decoders x 2 layers x 2 = 20; the eval forward none.  The dropout masks
    come from the generator: the same seed gives the same outputs."""
    cfg, model, _, batch = _port(jax_run, dropout=0.1)
    rates = []
    real = layers.fused_attention

    def spy(q, k, v, mask=None, rate=0.0, g=None):
        rates.append(rate)
        return real(q, k, v, mask, rate, g)

    monkeypatch.setattr(layers, "fused_attention", spy)
    outs = [model(batch, torch.Generator().manual_seed(3)) for _ in range(2)]
    assert len(rates) == 2 * 20 and set(rates) == {0.1}
    for key in outs[0]:
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=0, atol=0)
    rates.clear()
    with torch.inference_mode():
        evals = model.eval()(batch)
    assert rates == []
    assert not torch.allclose(evals["hg_logit"], outs[0]["hg_logit"])


def test_eval_step_matches_jax(jax_run):
    cfg = jax_run["cfg"]
    want = jax.device_get(jax.jit(jax_step.make_eval_step(
        cfg, JaxShgVqaModel(cfg), with_hg_metrics=True))(
            jax_run["variables"], jax_run["batch"]))
    _, model, _, batch = _port(jax_run)
    got = step.make_eval_step(tiny_test_config(task="hgqa"), model,
                              with_hg_metrics=True)(batch)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], 1e-4)

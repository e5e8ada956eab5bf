"""Training the trunk (the published AGQA recipe, no ``--freezeBackbone``)
against the JAX package, at tiny_test_config size in f32 with the slow_r50
trunk at its TOY widths in both packages.

- Three train steps from uint8 frames (``no_aug``, every dropout rate 0)
  against the JAX ``make_train_step`` on the ``VideoShgVqaModel``: the
  losses, the parameter updates (the trunk's included) and the BatchNorm
  statistics, which neither package changes; the trainable mask against
  the JAX drivers' masks by name.
- With ``set_block_kernel`` on, a train step runs the trunk's convs and an
  eval forward the fused bottleneck.
- The dropout sites of one training forward (trunk trained, RandAugment
  on): the same (shape, rate) calls in both packages.

The JAX BatchNorm statistics are the ``batch_stats`` collection, which the
JAX Trainer never differentiates (``shgvqa_tpu/train/loop.py``,
``train_step``); ``make_train_step`` differentiates every collection, so
the JAX side masks ``batch_stats`` to a zero update here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shgvqa_tpu.cli import common as jax_common
from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu.models.shgvqa import VideoShgVqaModel as JaxVideoModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.kernels import bottleneck as bottleneck_kernel
from shgvqa_tpu_torch.models import backbone, layers, shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel
from shgvqa_tpu_torch.train import step
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from test_torch_common import TOY, close, load_port, perturb, t
from test_torch_model import _batch
from test_torch_train_step import (
    LOSS_TOL,
    LR,
    NOISE,
    STEPS,
    T_TOTAL,
    UPDATE_TOL,
)


def _toy_trunks(mp):
    mp.setattr(jax_backbone, "make_backbone",
               lambda name, dtype, quant="": JaxSlowR50(dtype=dtype, **TOY))
    mp.setattr(shgvqa, "make_backbone",
               lambda name, dtype: SlowR50(dtype, **TOY))


def _frames_batch(cfg, seed=0):
    """uint8 frames, a question, and per-frame hypergraph and answer
    labels for 2 clips."""
    batch = _batch(cfg, seed=seed, frames=True)
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


def _jax_mask(variables, cfg):
    """The JAX drivers' trainable mask (``cli/common.py``): the connected
    parameters, composed with the freeze policy when it freezes; the
    ``batch_stats`` collection never trains."""
    mask = jax_step.connected_param_mask(variables, cfg)
    if cfg.freeze_backbone:
        mask = jax.tree_util.tree_map(lambda a, b: bool(a) and bool(b), mask,
                                      jax_common._trainable_mask(variables,
                                                                 cfg))
    return dict(mask, batch_stats=jax.tree_util.tree_map(
        lambda _: False, mask["batch_stats"]))


def _by_port_name(mask_tree, variables):
    full = jax.tree_util.tree_map(
        lambda m, v: np.full(np.shape(v), float(m), np.float32),
        mask_tree, jax.device_get(variables))
    return {k: bool(v.all()) for k, v in from_jax_variables(full).items()}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train steps of the video model with a trained TOY trunk,
    dropout off (flax's Dropout patched to the identity while tracing)."""
    cfg = jax_tiny(task="hgqa", freeze_backbone=False)
    batch = _frames_batch(cfg)
    mp = pytest.MonkeyPatch()
    _toy_trunks(mp)
    try:
        model = JaxVideoModel(cfg)
        init = jax.jit(lambda r, b: model.init(r, b, deterministic=True))
        variables = jax.tree_util.tree_map(jnp.asarray, perturb(
            jax.device_get(init(jax.random.PRNGKey(0), batch)),
            np.random.RandomState(1)))
        mask = _jax_mask(variables, cfg)
        tx = jax_make_optimizer(LR, T_TOTAL, trainable_mask=mask)
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
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


def _port(jax_run, monkeypatch, **overrides):
    _toy_trunks(monkeypatch)
    cfg = tiny_test_config(task="hgqa", freeze_backbone=False, **overrides)
    model = load_port(VideoShgVqaModel(cfg), jax_run["variables"]).train()
    layers.set_dropout_rate(model, 0.0)
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    batch = {k: t(v) for k, v in jax_run["batch"].items()}
    return cfg, model, opt, batch


def test_trained_trunk_steps_match_jax(jax_run, monkeypatch):
    """Losses within 1e-4 at each step; every parameter's update held to
    the JAX one (``test_torch_train_step``'s rule); the BatchNorm
    statistics bit-identical before and after, on both sides."""
    cfg, model, opt, batch = _port(jax_run, monkeypatch)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
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
    max_move = sum(opt.lr_at(i) for i in range(STEPS)) * 0.1 / 0.999 ** 0.5 \
        * STEPS ** 0.5
    trunk_moved = 0
    for name, p in model.named_parameters():
        d_port = p.detach() - before[name]
        d_jax = want_params[name] - before[name]
        if id(p) not in moments:        # disconnected: untouched
            assert not d_port.any() and not d_jax.any(), name
            continue
        noise = moments[id(p)].abs() < NOISE * rms_m
        err = (d_port - d_jax)[~noise].norm().item()
        assert err <= UPDATE_TOL * d_jax[~noise].norm().item() + 1e-12, \
            (name, err)
        assert ((d_port - d_jax)[noise].abs() <= 2 * max_move).all(), name
        trunk_moved += name.startswith("backbone.") and bool(d_port.any())
    assert trunk_moved == sum(1 for n, _ in model.named_parameters()
                              if n.startswith("backbone."))

    want_stats = jax_run["params"]["batch_stats"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(a, b)), want_stats,
        jax.device_get(jax_run["variables"]["batch_stats"])))
    assert stats
    for name, value in model.named_buffers():
        if name in stats:
            assert torch.equal(value, stats[name]), name
            assert torch.equal(value, want_params[name]), name


@pytest.mark.parametrize("freeze", [False, True], ids=["trained", "frozen"])
def test_trainable_mask_matches_the_jax_drivers(jax_run, monkeypatch,
                                                freeze):
    """The port's ``trainable_mask`` against the JAX drivers' mask by
    parameter name; trained, every ``backbone.*`` parameter trains (the
    BatchNorm weight and bias included), frozen none does."""
    _toy_trunks(monkeypatch)
    cfg = tiny_test_config(task="hgqa", freeze_backbone=freeze)
    model = VideoShgVqaModel(cfg)
    got = step.trainable_mask(model, cfg)
    want = _by_port_name(_jax_mask(jax_run["variables"],
                                   jax_tiny(task="hgqa",
                                            freeze_backbone=freeze)),
                         jax_run["variables"])
    assert set(got) < set(want)
    assert got == {n: want[n] for n in got}
    assert not any(v for n, v in want.items() if n not in got)
    trunk = {n: m for n, m in got.items() if n.startswith("backbone.")}
    assert any(n.endswith("bn_a.weight") for n in trunk)
    assert set(trunk.values()) == {not freeze}
    assert not any(n.endswith(("running_mean", "running_var")) for n in got)


def test_block_kernel_switch_with_a_trained_trunk(monkeypatch):
    """``set_block_kernel`` on: a train step runs the trunk's convs (the
    kernel is forward only) and raises nothing; the eval forward runs the
    fused bottleneck (its plain route on the CPU) at the TOY trunk's one
    block of stride 1 and temporal kernel 1."""
    _toy_trunks(monkeypatch)
    cfg = tiny_test_config(task="hgqa", freeze_backbone=False)
    model = init_weights(VideoShgVqaModel(cfg), 0)
    backbone.set_block_kernel(model, True)
    calls = []
    fused = backbone.fused_bottleneck
    monkeypatch.setattr(backbone, "fused_bottleneck",
                        lambda *a: calls.append(a[0].shape) or fused(*a))
    batch = {k: t(v) for k, v in _frames_batch(jax_tiny()).items()}
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    bottleneck_kernel.fused_bottleneck.launches = 0
    metrics = step.make_train_step(cfg, model, opt)(
        batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["total_loss"])
    assert calls == [] and bottleneck_kernel.fused_bottleneck.launches == 0
    assert all(p.grad is not None for n, p in model.named_parameters()
               if n.startswith("backbone."))
    step.make_eval_step(cfg, model)(batch)
    assert len(calls) == 1


def test_dropout_sites_of_a_training_forward_match_jax(jax_run,
                                                      monkeypatch):
    """One training forward from uint8 frames with the trunk trained and
    RandAugment on (plain attention, so every site is a Dropout call):
    the same multiset of (shape, rate) dropout calls in both packages."""
    _toy_trunks(monkeypatch)
    over = dict(task="hgqa", freeze_backbone=False,
                use_pallas_attention_train=False)
    jcfg = jax_tiny(**over)
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data,
                                                 augment_type="rand_aug"))
    cfg = tiny_test_config(**over)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               augment_type="rand_aug"))
    batch, variables = jax_run["batch"], jax_run["variables"]
    jmodel = JaxVideoModel(jcfg)
    counts = {"jax": {}, "port": {}}

    def count(side, shape, rate):
        key = (tuple(int(n) for n in shape), round(float(rate), 6))
        counts[side][key] = counts[side].get(key, 0) + 1

    monkeypatch.setattr(
        nn.Dropout, "__call__",
        lambda self, x, deterministic=None, rng=None:
        count("jax", x.shape, self.rate) or x)
    # counted once, while tracing
    jax.jit(lambda v, b: jmodel.apply(
        v, b, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(1),
              "augment": jax.random.PRNGKey(2)}))(variables, batch)
    monkeypatch.setattr(layers.Dropout, "forward",
                        lambda self, x, g=None:
                        count("port", x.shape, self.rate) or x)
    model = load_port(VideoShgVqaModel(cfg), variables).train()
    model({k: t(v) for k, v in batch.items()},
          torch.Generator().manual_seed(0))
    assert counts["port"] == counts["jax"]
    assert sum(counts["jax"].values()) > 20

"""The AGQA ablation tasks and options of the port against the JAX package
at tiny_test_config size in f32: ``ShgVqaModel`` for tasks 'q', 'vhga' and
'hgvqa' and under ``gt_hg``, ``decoder.linear_cls`` and
``after_cross_attn_feats`` (1e-4); ``mce_vqa_loss`` and ``compute_losses``
per task (1e-5); the connected and trainable masks (``--freezeWeights``,
``--freezeBackbone``) name for name, with the one departure asserted as
such; which parameters the port's backward reaches, for every task and
option; GT-HG without target ids; the attention sites of the new
layers.  ``tests/test_torch_tasks_train_step.py`` holds three train steps
of one combined configuration to the JAX ``make_train_step``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.cli import common as jax_common
from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.losses import vqa as jax_vqa
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.losses.vqa import mce_vqa_loss
from shgvqa_tpu_torch.models import layers, shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from shgvqa_tpu_torch.train import step
from test_torch_common import TOY, close, jax_variables, load_port, t
from test_torch_train_step import _labelled_batch

TOL, LOSS_TOL = 1e-4, 1e-5

# name -> (config overrides, encoder overrides, decoder overrides)
VARIANTS = {
    "q": (dict(task="q"), {}, {}),
    "vqa": (dict(task="vqa"), {}, {}),
    "hgqa": (dict(task="hgqa"), {}, {}),
    "vhga": (dict(task="vhga"), {}, {}),
    "hgvqa": (dict(task="hgvqa"), {}, {}),
    "gt_hg": (dict(task="hgqa", gt_hg=True), {}, {}),
    "linear_cls": (dict(task="hgqa"), {}, dict(linear_cls=True)),
    "after_cross": (dict(task="hgqa", after_cross_attn_feats=True), {}, {}),
    "self": (dict(task="hgqa"), dict(cross_attn_type="self"), {}),
    "cross_self": (dict(task="hgqa"), dict(cross_attn_type="cross_self"),
                   {}),
    "old": (dict(task="hgqa"), dict(cross_attn_type="old"), {}),
    "untied": (dict(task="hgqa"), dict(tie_x_layers=False), {}),
    "vhga_after_cross": (dict(task="vhga", after_cross_attn_feats=True), {},
                         {}),
    "hgvqa_gt_hg_self": (dict(task="hgvqa", gt_hg=True),
                         dict(cross_attn_type="self"), {}),
    "vqa_old_untied": (dict(task="vqa"),
                       dict(cross_attn_type="old", tie_x_layers=False), {}),
    "hgvqa_old_untied": (dict(task="hgvqa"),
                         dict(cross_attn_type="old", tie_x_layers=False), {}),
    "q_mce": (dict(task="q", mce_loss=True), {}, {}),
    "vqa_mce": (dict(task="vqa", mce_loss=True), {}, {}),
}
# the options a model's outputs are held to the JAX model's under
MODEL_VARIANTS = ("q", "vhga", "hgvqa", "gt_hg", "linear_cls", "after_cross")


def _cfgs(name, **more):
    top, enc, dec = VARIANTS[name]

    def build(tiny):
        cfg = tiny(**top, **more)
        return cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, **enc),
            decoder=dataclasses.replace(cfg.decoder, **dec))
    return build(jax_tiny), build(tiny_test_config)


def _batch(cfg, seed=0):
    """A labelled featurized batch of ``cfg``'s task: the answer index of
    each row (one row ignored, -1) and, under GT-HG, the label ids."""
    batch = _labelled_batch(cfg, seed)
    batch["answer_idx"] = np.array([4, -1], np.int32)
    if cfg.task == "q":
        for key in ("visual_feats", "visual_mask"):
            batch.pop(key)
    if cfg.gt_hg:
        batch["rel_tgt_ids"] = batch["rel_labels"].reshape(2, -1)
        batch["act_tgt_ids"] = batch["act_labels"].reshape(2, -1)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """(JAX cfg, port cfg, JAX model, its perturbed variables, batch), one
    JAX init per variant for the module."""
    jcfg, cfg = _cfgs(name)
    jmodel = JaxShgVqaModel(jcfg)
    batch = _batch(jcfg)
    # flax creates a module's parameters when it first runs: the GT-HG
    # decoders and class heads, which the port builds, only run on a batch
    # without label ids
    init_batch = {k: x for k, x in batch.items()
                  if not k.endswith("_tgt_ids")}
    return (jcfg, cfg, jmodel,
            jax_variables(jmodel, init_batch, deterministic=True), batch)


@pytest.mark.parametrize("name", MODEL_VARIANTS)
def test_model_outputs_match_jax(name):
    jcfg, cfg, jmodel, v, batch = _jax_model(name)
    want = jmodel.apply(v, batch, deterministic=True)
    port = load_port(ShgVqaModel(cfg), v)
    with torch.inference_mode():
        got = port({k: t(x) for k, x in batch.items()})
    assert set(got) == set(want)
    if name == "gt_hg":
        assert set(got) == {"logit", "hg_logit"}
    for key in want:
        close(got[key], want[key], TOL)


def test_gt_hg_without_target_ids_follows_jax():
    """Test items carry no label ids: both models run the decoders on the
    class-sized tables, broadcast against the type ids.  Where the table
    has as many rows as the hypergraph has slots (tiny_test_config:
    11 + 1 = 4 x 3 relations, 7 + 1 = 4 x 2 actions) they agree; where it
    has not, both raise TypeError."""
    jcfg, cfg, jmodel, v, batch = _jax_model("gt_hg")
    test_batch = {k: x for k, x in batch.items()
                  if not k.endswith("_tgt_ids")}
    assert "rel_tgt_ids" not in test_batch
    want = jmodel.apply(v, test_batch, deterministic=True)
    port = load_port(ShgVqaModel(cfg), v)
    with torch.inference_mode():
        got = port({k: t(x) for k, x in test_batch.items()})
    assert set(got) == set(want) == {"logit", "hg_logit", "rel_preds",
                                     "act_preds"}
    for key in want:
        close(got[key], want[key], TOL)
    jcfg, cfg = _cfgs("gt_hg", num_rel_classes=13)
    jmodel = JaxShgVqaModel(jcfg)
    with pytest.raises(TypeError):
        jmodel.init(jax.random.PRNGKey(0), test_batch, deterministic=True)
    port = init_weights(ShgVqaModel(cfg), 0).eval()
    with pytest.raises(TypeError, match="incompatible shapes"):
        port({k: t(x) for k, x in test_batch.items()})


@pytest.mark.parametrize("shape", ["some_ignored", "all_ignored"])
def test_mce_vqa_loss_matches_jax(shape):
    rng = np.random.RandomState(2)
    logits = (rng.randn(5, 13) * 3).astype(np.float32)
    idx = np.array([3, -1, 12, 0, -1] if shape == "some_ignored"
                   else [-1] * 5, np.int32)
    close(mce_vqa_loss(t(logits), t(idx)),
          jax_vqa.mce_vqa_loss(jnp.asarray(logits), jnp.asarray(idx)),
          LOSS_TOL)


@pytest.mark.parametrize("name", ["q", "q_mce", "vqa", "vqa_mce", "vhga",
                                  "hgvqa", "gt_hg"])
def test_compute_losses_match_jax(name):
    """Both packages' compute_losses on the same outputs (the JAX model's)
    and batch: every metric, within 1e-5."""
    model_name = {"q_mce": "q", "vqa_mce": "vqa"}.get(name, name)
    if model_name == "vqa":
        jcfg, cfg = _cfgs(name)
        rng = np.random.RandomState(5)
        outputs = {"logit": rng.randn(2, jcfg.num_answers).astype(
            np.float32)}
        batch = _batch(jcfg)
    else:
        _, _, jmodel, v, batch = _jax_model(model_name)
        jcfg, cfg = _cfgs(name)
        outputs = jax.device_get(jmodel.apply(v, batch, deterministic=True))
    _, want = jax_step.compute_losses(jcfg, outputs, batch)
    _, got = step.compute_losses(cfg, {k: t(x) for k, x in outputs.items()},
                                 {k: t(x) for k, x in batch.items()})
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], LOSS_TOL)


def _port_model(name, monkeypatch, **more):
    """The port's model of a variant as the driver builds it (the video
    model with the toy trunk; task 'q' without one), random weights."""
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))
    _, cfg = _cfgs(name, **more)
    cls = ShgVqaModel if cfg.task == "q" else VideoShgVqaModel
    return cfg, init_weights(cls(cfg), 0)


def _jax_departs(cfg, name):
    """Whether the port's connected mask departs from the JAX one at
    parameter ``name`` (the JAX mask connects it, the loss does not reach
    it)."""
    keys = name.split(".")
    enc = cfg.encoder
    if (enc.cross_attn_type == "old" and not enc.tie_x_layers
            and not cfg.after_cross_attn_feats
            and f"x_{enc.x_layers - 1}" in keys and "lang_ffn" in keys):
        return True
    if cfg.task not in ("hgqa", "vhga"):
        return False
    if cfg.after_cross_attn_feats:
        return "lxrt" in keys and keys[keys.index("lxrt") + 1] == "pooler"
    return cfg.gt_hg and ("backbone" in keys or "visual_tokenizer" in keys
                          or any(k.startswith("r_") for k in keys))


def _jax_driver_mask(cfg, model):
    """The JAX driver's optimizer mask (``connected_param_mask`` and, with
    a freeze option, ``_trainable_mask``) over the port model's tree in
    the JAX layout, by port parameter name."""
    tree = {"params": to_jax_variables(model.state_dict())["params"]}
    mask = jax_step.connected_param_mask(tree, cfg)
    if (cfg.freeze_backbone and cfg.task != "q") or cfg.freeze_weights:
        frozen = jax_common._trainable_mask(tree, cfg)
        mask = jax.tree_util.tree_map(lambda a, b: bool(a) and bool(b),
                                      mask, frozen)
    full = jax.tree_util.tree_map(
        lambda m, x: np.full(np.shape(x), float(m), np.float32), mask, tree)
    return {k: bool(x.all()) for k, x in from_jax_variables(full).items()}


@pytest.mark.parametrize("freeze", ["none", "weights", "backbone", "both"])
@pytest.mark.parametrize("name", ["q", "vqa", "hgqa", "vhga", "hgvqa",
                                  "gt_hg", "after_cross", "self", "untied",
                                  "vhga_after_cross", "vqa_old_untied"])
def test_trainable_mask_matches_the_jax_driver(monkeypatch, name, freeze):
    """The port's ``trainable_mask`` equals the JAX driver's mask, name for
    name, but where the JAX mask trains what the loss does not reach
    (ROADMAP C): under 'hgqa' / 'vhga' the LXRT pooler under
    ``after_cross_attn_feats`` and the visual stream under GT-HG without
    it; under 'old' with untied x-layers the last one's language FFN."""
    jcfg, _ = _cfgs(name, freeze_weights=freeze in ("weights", "both"),
                    freeze_backbone=freeze in ("backbone", "both"))
    cfg, model = _port_model(name, monkeypatch,
                             freeze_weights=freeze in ("weights", "both"),
                             freeze_backbone=freeze in ("backbone", "both"))
    got = step.trainable_mask(model, cfg)
    want = _jax_driver_mask(jcfg, model)
    assert got.keys() == want.keys()
    departures = {n for n in got if got[n] != want[n]}
    expected = {n for n in got if want[n] and _jax_departs(cfg, n)}
    assert departures == expected
    assert not any(got[n] for n in expected)
    if freeze == "none" and name in ("after_cross", "vhga_after_cross",
                                     "gt_hg", "vqa_old_untied"):
        assert expected
    if cfg.freeze_weights:
        enc = "bert_encoder" if cfg.task == "q" else "lxrt"
        frozen = {n for n in got if not got[n]}
        assert any(f"{enc}.embeddings." in n for n in frozen)
        assert all(got[n] == step.connected_param_mask(model, cfg)[n]
                   for n in got if ".x_" in n or "pooler" in n)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_backward_reaches_exactly_the_connected_parameters(monkeypatch,
                                                           name):
    """For every task and option, with dropout at the flagship's rates:
    the parameters the loss's backward reaches are exactly
    ``connected_param_mask``'s."""
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))
    jcfg, cfg = _cfgs(name)
    model = init_weights(ShgVqaModel(cfg), 0).train()
    batch = {k: t(x) for k, x in _batch(jcfg).items()}
    loss, metrics = step.compute_losses(
        cfg, model(batch, torch.Generator().manual_seed(0)), batch)
    loss.backward()
    assert torch.isfinite(metrics["total_loss"])
    connected = step.connected_param_mask(model, cfg)
    for n, p in model.named_parameters():
        assert (p.grad is not None) == connected[n], n
    if cfg.task in ("hgqa", "vhga"):
        assert not connected["lxrt.pooler.dense.weight"
                             if "lxrt.pooler.dense.weight" in connected
                             else "lxrt.pooler.dense2.weight"]


def test_every_x_layer_site_routes_the_attention_kernel(monkeypatch):
    """A training forward of untied 'cross_self' calls fused_attention at
    every site: 2 language + 2 visual + 2 steps x 3 LXRT + 2 x 3 HG + 2
    decoders x 2 layers x 2 = 24, and the deaf model's as many as 'hgqa'
    (20)."""
    calls = []
    real = layers.fused_attention

    def spy(q, k, v, mask=None, rate=0.0, g=None):
        calls.append(tuple(q.shape[2:3]) + tuple(k.shape[2:3]))
        return real(q, k, v, mask, rate, g)

    monkeypatch.setattr(layers, "fused_attention", spy)
    for name, cat, want in (("hgvqa", "cross_self", 24), ("vhga", "cross",
                                                          20)):
        jcfg, cfg = _cfgs(name)
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, cross_attn_type=cat, tie_x_layers=False))
        model = init_weights(ShgVqaModel(cfg), 0).train()
        calls.clear()
        model({k: t(x) for k, x in _batch(jcfg).items()},
              torch.Generator().manual_seed(0))
        assert len(calls) == want, (name, calls)
    e, d = cfg.encoder, cfg.data
    lv, lt = e.visual_seq_length, d.max_seq_length
    assert (lv + lt, lv + lt) not in calls

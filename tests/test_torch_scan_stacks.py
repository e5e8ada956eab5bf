"""``--scanLayers`` in the port: JAX's scanned parameter layout
(``models/scan_stacks.py``) and the model that runs it.

- The layout: ``to_jax_variables(..., scan_layers=True)`` of a port model
  has exactly the tree (names and shapes) JAX's scanned model initializes
  (``jax.eval_shape``: traced, not compiled), for the tied and untied cross
  stacks, 'old' and 'self' (whose cross layers stay unrolled); ``unstack``
  inverts ``stack``; ``from_jax_variables`` takes either layout.
- The model: a scanned JAX tree carried into the port gives JAX's scanned
  outputs within 1e-4 (f32, the tiny hgqa model; the port runs its
  per-layer modules).
- The refusals JAX makes: ``vit_init`` / ``shared_weights`` with
  ``scan_layers``, and attention dumps under ``scan_layers``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.models import scan_stacks
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from test_torch_common import close, t
from test_torch_model import _batch

VARIANTS = {
    "cross_tied": {},
    "cross_untied": dict(tie_x_layers=False),
    "old_untied": dict(cross_attn_type="old", tie_x_layers=False),
    "self": dict(cross_attn_type="self"),
}


def _cfgs(variant, task="hgqa", **kw):
    """(port, JAX) configs of the tiny model with ``scan_layers``."""
    out = []
    for make in (tiny_test_config, jax_tiny):
        cfg = make(task=task, **kw)
        out.append(cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, scan_layers=True, **VARIANTS[variant])))
    return out


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


@pytest.mark.parametrize("task", ["hgqa", "vqa"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_scanned_layout_is_jax_scanned_tree(variant, task):
    cfg, jcfg = _cfgs(variant, task)
    state = init_weights(ShgVqaModel(cfg), 0).state_dict()
    scanned = to_jax_variables(state, scan_layers=True)["params"]
    batch = _batch(jcfg)
    want = jax.eval_shape(lambda r: JaxShgVqaModel(jcfg).init(
        r, batch, deterministic=True), jax.random.PRNGKey(0))["params"]
    assert _shapes(scanned) == _shapes(want)
    enc = scanned["lxrt"]["encoder"]
    assert "l_stack" in enc and "r_stack" in enc
    assert ("x_stack" in enc) == (variant != "self")
    # the inverse, and the converter reads either layout
    flat = to_jax_variables(state)["params"]
    assert _shapes(scan_stacks.unstack(scanned)) == _shapes(flat)
    assert _shapes(scan_stacks.stack(flat)) == _shapes(scanned)
    again = from_jax_variables({"params": scanned})
    assert again.keys() == state.keys()
    for key, value in state.items():
        assert torch.equal(again[key], value), key


def test_the_question_model_does_not_scan():
    """Task 'q''s ``bert_encoder`` has no scanned stack in JAX either."""
    cfg, jcfg = _cfgs("cross_tied", task="q")
    state = init_weights(ShgVqaModel(cfg), 0).state_dict()
    scanned = to_jax_variables(state, scan_layers=True)["params"]
    want = jax.eval_shape(lambda r: JaxShgVqaModel(jcfg).init(
        r, _batch(jcfg), deterministic=True), jax.random.PRNGKey(0))
    assert _shapes(scanned) == _shapes(want["params"])
    assert "l_0" in scanned["bert_encoder"]


@pytest.fixture(scope="module", params=["cross_tied", "old_untied", "self"])
def scanned_run(request):
    """A port model's random weights in JAX's scanned layout and JAX's
    scanned forward on them (one jit a variant)."""
    cfg, jcfg = _cfgs(request.param)
    model = init_weights(ShgVqaModel(cfg), 5).eval()
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(
        model.state_dict(), scan_layers=True))
    batch = _batch(jcfg)
    out = jax.jit(lambda v: JaxShgVqaModel(jcfg).apply(
        v, batch, deterministic=True))(variables)
    return dict(cfg=cfg, batch=batch, variables=variables,
                out=jax.device_get(out))


def test_scanned_jax_tree_gives_jax_scanned_outputs(scanned_run):
    cfg = scanned_run["cfg"]
    model = ShgVqaModel(cfg)
    model.load_state_dict(from_jax_variables(
        jax.device_get(scanned_run["variables"]), model))
    with torch.no_grad():
        out = model.eval()({k: t(v) for k, v in scanned_run["batch"].items()})
    for key in ("logit", "hg_logit", "rel_preds", "act_preds"):
        close(out[key], scanned_run["out"][key], 1e-4)


@pytest.mark.parametrize("option", ["vit_init", "shared_weights"])
def test_scan_layers_refuses_what_jax_refuses(option):
    cfg = tiny_test_config(task="hgqa")
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, scan_layers=True, **{option: True}))
    with pytest.raises(ValueError, match="not available with scan_layers"):
        ShgVqaModel(cfg)


def test_scan_layers_refuses_attention_dumps():
    cfg, _ = _cfgs("cross_tied")
    model = init_weights(ShgVqaModel(cfg), 0).eval()
    batch = {k: t(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="unavailable with scan_layers"):
        model(batch, output_attentions=True)

"""Three train steps of one combined configuration of the AGQA ablations,
task 'hgvqa' with untied 'cross_self' x-layers, against the JAX
``make_train_step`` at tiny_test_config size in f32 with every dropout rate
at 0, by ``tests/test_torch_train_step.py``'s rule: the connected mask,
every metric at each step (1e-4) and each parameter's change.  One JAX
init and one jitted JAX train step (~40 s of the file's ~45 s)."""

import dataclasses

import pytest

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.train import step
from test_torch_tasks import _batch
from test_torch_train_step import check_steps_match, port_for, run_jax_steps


def _combined(cfg):
    cfg = cfg.replace(task="hgvqa")
    return cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, cross_attn_type="cross_self", tie_x_layers=False))


@pytest.fixture(scope="module")
def combined():
    jcfg = _combined(jax_tiny())
    return run_jax_steps(jcfg, _batch(jcfg))


def test_combined_train_steps_match_jax(combined):
    cfg, model, opt, batch = port_for(combined, _combined(tiny_test_config()))
    assert {"x_0", "x_1"} <= set(dict(model.lxrt.encoder.named_children()))
    connected = step.connected_param_mask(model, cfg)
    assert not connected["logit_fc.fc1.weight"]
    assert connected["lxrt.encoder.x_1.self_att_layer.self.query.weight"]
    check_steps_match(combined, cfg, model, opt, batch)

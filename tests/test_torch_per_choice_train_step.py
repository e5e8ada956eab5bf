"""Three train steps of per-choice STAR QA, task 'hgvqa' with
``--qaArrangeType add_sep`` and ``--useHGMask``, against the JAX
``make_train_step`` at tiny_test_config size in f32 with every dropout
rate at 0, by ``tests/test_torch_train_step.py``'s rule: the connected
mask, every metric at each step (1e-4) and each parameter's change.  One
JAX init and one jitted JAX train step."""

import pytest

from shgvqa_tpu_torch.train import step
from test_torch_per_choice import per_choice_batch, per_choice_cfgs
from test_torch_train_step import check_steps_match, port_for, run_jax_steps


@pytest.fixture(scope="module")
def per_choice_run():
    jcfg, _ = per_choice_cfgs("hgvqa")
    return run_jax_steps(jcfg, per_choice_batch(jcfg))


def test_per_choice_train_steps_match_jax(per_choice_run):
    _, cfg = per_choice_cfgs("hgvqa")
    cfg, model, opt, batch = port_for(per_choice_run, cfg)
    assert batch["choice_input_ids"].shape[1] == 4
    connected = step.connected_param_mask(model, cfg)
    assert not connected["choice_score_fc.fc1.weight"]
    assert connected["choice_score_fc2.fc1.weight"]
    assert connected["lxrt.pooler.dense2.weight"]
    check_steps_match(per_choice_run, cfg, model, opt, batch)

"""Shared helpers of the port's parity tests, and parity of the port's own
copies of the JAX package's framework-free pieces (config dataclasses,
featurize helpers, clip normalization).

The helpers give both packages the same weights: a flax module is
initialized, every leaf is perturbed with seeded numpy noise (so zero-init
biases, CLS tokens and BN statistics are exercised too), and the same tree
is loaded into the port through ``shgvqa_tpu_torch.convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs import config as jax_config
from shgvqa_tpu.data import featurize as jax_featurize
from shgvqa_tpu.data import transforms as jax_transforms
from shgvqa_tpu_torch.configs import config as torch_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.data import featurize, transforms


# the trunk's topology at toy widths (as tests/test_quant_backbone.py)
TOY = dict(stem_width=8, mids=(8, 8, 8, 8), outs=(16, 16, 16, 16),
           depths=(1, 1, 1, 1))


def perturb(tree, rng):
    """Copy of a nested dict of arrays with seeded noise on every leaf;
    BatchNorm variances stay positive."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = perturb(value, rng)
            continue
        x = np.asarray(value, np.float32)
        noise = rng.randn(*x.shape).astype(np.float32)
        out[key] = (np.abs(x) + 0.5 + 0.5 * np.abs(noise) if key == "var"
                    else x + 0.05 * noise)
    return out


def jax_variables(module, *args, seed=0, **kw):
    """Perturbed variables of a flax module initialized on ``args``."""
    v = module.init(jax.random.PRNGKey(seed), *args, **kw)
    v = perturb(jax.device_get(v), np.random.RandomState(seed + 1))
    return jax.tree_util.tree_map(jnp.asarray, v)


def load_port(model: torch.nn.Module, variables) -> torch.nn.Module:
    state = from_jax_variables(jax.device_get(variables), model)
    model.load_state_dict(state, strict=True)
    return model.eval()


def t(x, dtype=None):
    """numpy -> torch (ints stay ints)."""
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["Config", "EncoderConfig", "DecoderConfig",
                                  "DataConfig", "OptimConfig", "MeshConfig"])
def test_config_copy_matches_jax_defaults(name):
    ours, theirs = getattr(torch_config, name)(), getattr(jax_config, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_tiny_test_config_copy_matches_jax():
    assert (dataclasses.asdict(torch_config.tiny_test_config(task="vqa"))
            == dataclasses.asdict(jax_config.tiny_test_config(task="vqa")))


@pytest.mark.parametrize("s,slots", [(4, 3), (16, 8), (16, 3)])
def test_featurize_copy_matches_jax(s, slots):
    np.testing.assert_array_equal(featurize.hg_segment_ids(s, slots),
                                  jax_featurize.hg_segment_ids(s, slots))
    np.testing.assert_array_equal(
        featurize.situation_causal_mask(s, slots),
        jax_featurize.situation_causal_mask(s, slots))


def test_normalize_clip_matches_jax():
    assert transforms.NORM_STATS == jax_transforms.NORM_STATS
    x = np.random.RandomState(0).rand(2, 3, 4, 4, 3).astype(np.float32)
    mean, std = transforms.NORM_STATS["slow_r50"]
    want = jax_transforms.normalize_clip(x, mean, std)
    close(transforms.normalize_clip(t(x), mean, std), want, 1e-6)

"""The port's slow_r50 trunk against the JAX package's, f32, at the TOY
widths of tests/test_quant_backbone.py (same topology: stem, max-pool, four
stages with projections, temporal kernel 3 in res_4/res_5).  Tolerance:
max |error| / max |output| <= 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.data.transforms import NORM_STATS, normalize_clip
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.models.backbone import SlowR50, make_backbone
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel
from test_torch_common import TOY, close, jax_variables, load_port, t


@pytest.mark.parametrize("t_len,hw", [(4, 32), (3, 40)])
def test_slow_r50_toy_matches_jax(t_len, hw):
    x = np.random.RandomState(0).randn(2, t_len, hw, hw, 3).astype(np.float32)
    mod = JaxSlowR50(dtype=jnp.float32, **TOY)
    v = jax_variables(mod, x)
    want = np.asarray(mod.apply(v, x))
    port = load_port(SlowR50(torch.float32, **TOY), v)
    got = port(t(x))
    assert got.shape == want.shape
    assert want.shape[2] == SlowR50.spatial_out(hw)
    err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


def test_encode_frames_from_uint8_through_toy_trunk():
    """VideoShgVqaModel.encode_frames (uint8 / 255, normalize_clip with the
    slow_r50 stats, the trunk) against the same steps of the JAX package
    (models/shgvqa.py:335-347), f32, with the toy trunk swapped in."""
    frames = np.random.RandomState(1).randint(
        0, 256, (2, 4, 32, 32, 3)).astype(np.uint8)
    mod = JaxSlowR50(dtype=jnp.float32, **TOY)
    v = jax_variables(mod, frames.astype(np.float32))
    x = jnp.asarray(frames, jnp.float32) / jnp.asarray(255.0, jnp.float32)
    want = mod.apply(v, normalize_clip(x, *NORM_STATS["slow_r50"]))
    model = VideoShgVqaModel(tiny_test_config(task="hgqa")).eval()
    model.backbone = load_port(SlowR50(torch.float32, **TOY), v)
    with pytest.raises(TypeError, match="uint8"):
        model.encode_frames(t(frames.astype(np.float32)))
    close(model.encode_frames(t(frames)), want, 1e-4)


def test_make_backbone_ports_only_slow_r50():
    assert isinstance(make_backbone("slow_r50"), SlowR50)
    with pytest.raises(NotImplementedError, match="item 17"):
        make_backbone("resnext101")

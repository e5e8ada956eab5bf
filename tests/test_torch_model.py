"""The port's task models against the JAX package's at tiny_test_config size
(f32), with the same weights carried by shgvqa_tpu_torch.convert, plus the
converter's round trip and the options the port does not take yet."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.models.shgvqa import VideoShgVqaModel as JaxVideoModel
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from test_torch_common import TOY, close, jax_variables, load_port, t

TOL = 1e-4
OUTPUTS = ("logit", "hg_logit", "rel_preds", "act_preds")


def _batch(cfg, bsz=2, seed=0, frames=False):
    rng = np.random.RandomState(seed)
    d, e = cfg.data, cfg.encoder
    mask = np.ones((bsz, d.max_seq_length), np.int32)
    mask[1, d.max_seq_length // 2:] = 0             # a padded question
    batch = {
        "input_ids": rng.randint(
            1, e.vocab_size, (bsz, d.max_seq_length)).astype(np.int32),
        "input_mask": mask,
        "segment_ids": np.zeros((bsz, d.max_seq_length), np.int32),
    }
    if frames:
        batch["frames"] = rng.randint(
            0, 255, (bsz, e.visual_t + 8, d.image_size, d.image_size, 3)
        ).astype(np.uint8)
    else:
        batch["visual_feats"] = rng.randn(
            bsz, e.visual_t + 8, e.visual_hw, e.visual_hw, e.visual_feat_dim
        ).astype(np.float32)
        batch["visual_mask"] = np.ones((bsz, e.visual_seq_length), np.int32)
    return batch


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def hgqa():
    jmodel = JaxShgVqaModel(jax_tiny(task="hgqa"))
    batch = _batch(jax_tiny())
    return jmodel, jax_variables(jmodel, batch, deterministic=True), batch


@pytest.mark.parametrize("jax_ffn", ["plain", "pallas_interpret"])
def test_shgvqa_hgqa_matches_jax(hgqa, jax_ffn):
    jmodel, v, batch = hgqa
    pallas_ffn.enable(jax_ffn == "pallas_interpret")
    pallas_ffn._FORCE_INTERPRET = jax_ffn == "pallas_interpret"
    try:
        want = jmodel.apply(v, batch, deterministic=True)
    finally:
        pallas_ffn.enable(False)
        pallas_ffn._FORCE_INTERPRET = False
    port = load_port(ShgVqaModel(tiny_test_config(task="hgqa")), v)
    with torch.inference_mode():
        got = port(_torch_batch(batch))
    assert set(got) == set(OUTPUTS)
    for key in OUTPUTS:
        close(got[key], want[key], TOL)


def test_shgvqa_vqa_matches_jax():
    jmodel = JaxShgVqaModel(jax_tiny(task="vqa"))
    batch = _batch(jax_tiny(), seed=1)
    v = jax_variables(jmodel, batch, deterministic=True)
    port = load_port(ShgVqaModel(tiny_test_config(task="vqa")), v)
    with torch.inference_mode():
        got = port(_torch_batch(batch))
    assert set(got) == {"logit"}
    close(got["logit"], jmodel.apply(v, batch, deterministic=True)["logit"],
          TOL)


@pytest.mark.slow
def test_video_model_from_uint8_frames_matches_jax():
    """Frames -> answer through the full-width slow_r50 trunk (32x32 frames)
    and the tiny head, as tests/test_quant_backbone.py builds it.  Marked
    slow: ~52 s on one CPU core.  tests/test_torch_backbone.py covers the
    frames path (encode_frames) through the toy trunk in tier-1."""
    jmodel = JaxVideoModel(jax_tiny(task="hgqa", freeze_backbone=True))
    batch = _batch(jax_tiny(), frames=True)
    v = jax_variables(jmodel, batch, deterministic=True)
    want = jmodel.apply(v, batch, deterministic=True)
    port = load_port(VideoShgVqaModel(
        tiny_test_config(task="hgqa", freeze_backbone=True)), v)
    with torch.inference_mode():
        got = port(_torch_batch(batch))
    for key in OUTPUTS:
        close(got[key], want[key], TOL)


def test_converter_round_trip_is_strict(hgqa):
    """JAX init -> device_get -> converter -> load_state_dict(strict), for
    the head (params) and the toy trunk (params and batch_stats): every leaf
    lands, transposed where the layouts differ; a leaf left over or missing
    raises."""
    head = jax.device_get(hgqa[1])
    trunk_init = jax.jit(JaxSlowR50(dtype=jnp.float32, **TOY).init)
    trunk = jax.device_get(trunk_init(
        jax.random.PRNGKey(0), np.zeros((1, 4, 32, 32, 3), np.float32)))
    ports = (ShgVqaModel(tiny_test_config(task="hgqa")),
             SlowR50(torch.float32, **TOY))
    for v, port in zip((head, trunk), ports):
        state = from_jax_variables(v, port)
        assert (len(state) == len(jax.tree_util.tree_leaves(v))
                == len(port.state_dict()))
        port.load_state_dict(state, strict=True)
    sd_head, sd_trunk = (port.state_dict() for port in ports)
    np.testing.assert_array_equal(
        sd_head["logit_fc.fc1.weight"].numpy(),
        head["params"]["logit_fc"]["fc1"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(
        sd_trunk["stem_conv.weight"].numpy(),
        trunk["params"]["stem_conv"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        sd_trunk["res_2.block_0.bn_a.running_var"].numpy(),
        trunk["batch_stats"]["res_2"]["block_0"]["bn_a"]["var"])

    extra = {"params": dict(trunk["params"], stray={"bias": np.zeros(3)}),
             "batch_stats": trunk["batch_stats"]}
    with pytest.raises(KeyError, match="left over"):
        from_jax_variables(extra, ports[1])
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables({"params": trunk["params"]}, ports[1])
    with pytest.raises(KeyError, match="unknown parameter leaf"):
        from_jax_variables({"params": {"x": {"gamma": np.zeros(2)}}})


@pytest.mark.parametrize("override", [
    dict(task="q"), dict(task="vhga"), dict(task="hgvqa"),
    dict(gt_hg=True), dict(use_hg_mask=True), dict(output_attention=True),
    dict(use_pallas_attention=True), dict(encoder="cross_self"),
    dict(encoder="scan_layers"), dict(quant_backbone="int8"),
    dict(backbone="resnext101"), dict(backbone_chunks=2),
])
def test_unported_options_raise(override):
    cfg = tiny_test_config(task="hgqa")
    if override.get("encoder") == "cross_self":
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, cross_attn_type="cross_self"))
    elif override.get("encoder") == "scan_layers":
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, scan_layers=True))
    else:
        cfg = cfg.replace(**override)
    with pytest.raises(NotImplementedError, match="not ported"):
        VideoShgVqaModel(cfg)


def test_training_mode_raises():
    cfg = tiny_test_config(task="hgqa")
    model = ShgVqaModel(cfg).train()
    batch = _torch_batch(_batch(jax_tiny()))
    with pytest.raises(NotImplementedError, match="inference only"):
        model(batch)

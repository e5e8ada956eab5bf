"""The port's MViT-B trunk (``models/mvit.py``) against the JAX package's,
f32, at the TOY dims of ``tests/test_mvit_convert.py`` (embed 8, depth 4,
Q-stride blocks 1 and 3, KV stride (1, 4, 4)), with the checks of
``tests/test_torch_backbones_extra.py``; and the time axis: MViT and Swin
halve it, which JAX's CLI does not count (its conv tokenizer then answers
from the cls token alone), so the port derives ``visual_t`` from the trunk
and raises where the tokenizer would get 8 steps or fewer.  At
``--clipLEN 32`` the whole model with a TOY MViT matches the JAX model
built with the consistent ``visual_t``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs import cli as jax_cli
from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models import mvit as jax_mvit
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.models.visual import VisualTokenizer as JaxVisualTokenizer
from shgvqa_tpu_torch.configs import cli
from shgvqa_tpu_torch.configs.config import tiny_test_config, trunk_steps
from shgvqa_tpu_torch.models import mvit, shgvqa
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel
from shgvqa_tpu_torch.utils import convert_mvit
from test_torch_backbones_extra import (
    FEATURE_TOL,
    assert_trees_equal,
    jax_shape,
    load_through_trainer,
    meta_shape,
    one_thread,  # noqa: F401
    rel_err,
    round_trip,
    trunk_pair,
    video_parity,
)

import convert_mvit as tool_mvit  # noqa: E402  (tools/, on the path)
import test_mvit_convert as jax_mvit_test  # noqa: E402

TOY = dict(embed_dim=8, depth=4, num_heads=1, stage_blocks=(1, 3),
           kv_stride=(1, 4, 4))


@pytest.fixture(scope="module")
def pair():
    x = np.random.RandomState(0).randn(2, 8, 32, 32, 3).astype(np.float32)
    return trunk_pair(jax_mvit.MViTB(**TOY),
                      mvit.MViTB(torch.float32, frames=8, image_size=32,
                                 **TOY), x)


def test_toy_features_match_jax(pair):
    want, got, _, port = pair
    assert got.shape == want.shape == (2, 4, 2, 2, 32)
    assert want.shape[1] == port.temporal_out(8) == trunk_steps("mvit_B", 8)
    assert want.shape[2] == port.spatial_out(32)
    assert want.shape[-1] == port.out_channels
    assert rel_err(got, want) <= FEATURE_TOL


def test_convert_round_trip_is_bit_equal(pair):
    _, _, v, port = pair
    round_trip(v, port)


def test_schedule_is_jaxs():
    for args in ((16, 96, 1, (1, 3, 14), (1, 8, 8)), (4, 8, 1, (1, 3),
                                                       (1, 4, 4))):
        assert mvit.mvit_schedule(*args) == jax_mvit.mvit_schedule(*args)


@pytest.mark.parametrize("separate_qkv", [False, True])
def test_hub_converter_is_the_tools_and_loads(tmp_path, separate_qkv):
    """The JAX test's toy pytorchvideo MViT (fused or separate q/k/v): the
    port's converter gives the tool's tree, which loads strictly."""
    jt = jax_mvit_test
    sd = {k: v.detach().numpy()
          for k, v in jt._make_torch(separate_qkv).state_dict().items()}
    heads = [row[2] for row in jt.SCHEDULE]
    tree = convert_mvit.convert(sd, heads)
    assert_trees_equal(tree, tool_mvit.convert(sd, heads))
    assert convert_mvit.default_heads() == [
        row[2] for row in jax_mvit.mvit_schedule(16, 96, 1, (1, 3, 14),
                                                 (1, 8, 8))]
    load_through_trainer(tree, mvit.MViTB(
        torch.float32, frames=8, image_size=32, embed_dim=jt.EMBED,
        depth=jt.DEPTH, num_heads=jt.HEADS0, stage_blocks=jt.STAGES,
        kv_stride=jt.KV0), tmp_path)


def test_full_width_shape_on_meta_is_jaxs():
    frames = (2, 32, 224, 224, 3)
    want = jax_shape("mvit_B", frames)
    assert want == (2, 16, 7, 7, 768)
    assert meta_shape("mvit_B", frames, frames=32, image_size=224) == want


@pytest.mark.parametrize("trunk", ["mvit_B", "video_swin_impl"])
def test_halved_time_raises_where_jax_answers_from_the_cls_token(trunk):
    """At ``--clipLEN 16`` with ``--noCaps`` JAX's CLI sets visual_t = 8,
    the trunk gives 8 steps and JAX's conv tokenizer returns 1 token (the
    cls token) with no error; the port's parse raises naming the trunk and
    ``--clipLEN``.  At ``--clipLEN 32``: 8 steps after the tokenizer, 393
    tokens.  The capsule path (no ``--noCaps``): JAX's visual_t = 16 makes
    a 785-entry mask against 393 tokens, and its model raises; the port's
    visual_t is the trunk's 8."""
    argv = ["--taskHGQA", "--noCaps", "--backbone", trunk]
    jcfg = jax_cli.parse_reference_flags(argv)
    assert jcfg.encoder.visual_t == 8
    tokens = jax.eval_shape(
        lambda f: JaxVisualTokenizer(32).init_with_output(
            jax.random.PRNGKey(0), f)[0],
        jax.ShapeDtypeStruct((2, trunk_steps(trunk, 16), 7, 7, 64),
                             jnp.float32))
    assert tokens.shape == (2, 1, 32)
    with pytest.raises(ValueError, match=f"{trunk}.*--clipLEN 16"):
        cli.parse_reference_flags(argv)
    cfg = cli.parse_reference_flags(argv + ["--clipLEN", "32"])
    assert cfg.encoder.visual_t == 8
    assert cfg.encoder.visual_seq_length == 393
    caps = ["--taskHGQA", "--backbone", trunk]
    assert jax_cli.parse_reference_flags(caps).encoder.visual_t == 16
    assert cli.parse_reference_flags(caps).encoder.visual_t == 8

    # JAX's capsule head on the trunk's 8 steps against its 16-step mask
    jcfg = jax_tiny(task="hgqa")
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, no_caps=False, visual_t=4, visual_hw=2,
        visual_feat_dim=16))
    b, lt, s = 2, jcfg.data.max_seq_length, jcfg.data.num_situations
    batch = {"input_ids": np.ones((b, lt), np.int32),
             "input_mask": np.ones((b, lt), np.int32),
             "segment_ids": np.zeros((b, lt), np.int32),
             "visual_feats": np.zeros((b, 2, 2, 2, 16), np.float32),
             "visual_mask": np.ones((b, jcfg.encoder.visual_seq_length),
                                    np.int32),
             "hg_mask": np.ones((b, s, jcfg.data.num_rel
                                 + jcfg.data.num_act), np.int32)}
    model = JaxShgVqaModel(jcfg)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda: model.apply(
            model.init(jax.random.PRNGKey(0), batch), batch))


def test_the_port_model_raises_on_too_few_steps(monkeypatch):
    """The model itself refuses features of 8 steps or fewer on the conv
    tokenizer path (a config not made by the CLI)."""
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype, **kw: mvit.MViTB(
                            dtype, frames=16, image_size=32, **TOY))
    cfg = tiny_test_config(task="hgqa", backbone="mvit_B")
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, visual_t=8))
    model = VideoShgVqaModel(cfg).eval()
    frames = torch.zeros(2, 16, 32, 32, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="mvit_B trunk gives 8 time steps"):
        with torch.no_grad():
            model({"frames": frames,
                   "input_ids": torch.ones(2, 12, dtype=torch.int32),
                   "input_mask": torch.ones(2, 12, dtype=torch.int32),
                   "segment_ids": torch.zeros(2, 12, dtype=torch.int32)})


def test_mvit_video_model_at_clip_len_32_matches_jax(monkeypatch):
    """A TOY MViT in ``VideoShgVqaModel`` on 32 frames of 32 pixels: 16
    steps of 2 x 2 x 32 into the conv tokenizer (visual_t 8), hg_logit and
    one train step against the JAX model of the consistent visual_t."""
    frames = np.random.RandomState(3).randint(
        0, 255, (2, 32, 32, 32, 3)).astype(np.uint8)
    video_parity(
        monkeypatch, jax_mvit.MViTB(**TOY),
        mvit.MViTB(torch.float32, frames=32, image_size=32, **TOY),
        dict(visual_t=8, visual_hw=2, visual_feat_dim=32), frames,
        dict(image_size=32))

"""The port's ResNeXt-101 and SlowFast trunks (``models/backbones_extra.py``)
against the JAX package's, f32, at TOY widths, plus the helpers the MViT
and Swin trunk tests share.

For each trunk: features within 1e-4 (max |error| / max |output|) of JAX's
on the same perturbed weights, carried by ``convert.py``; ``convert.py``'s
round trip bit-equal; the port's hub converter's tree bit-equal to
``tools/convert_*.py``'s on one random hub-named state dict (the JAX
tests' toy torch modules build it); that tree as a msgpack through
``Trainer.load_backbone``; full-width output shapes on ``meta`` equal to
``jax.eval_shape``'s.  Also: the block switch on a slowfast trunk routes
exactly the blocks the kernel takes (5), the reference import of slowfast
and resnext101 trunks as JAX's, the registry's refusals as JAX's, and a
TOY slowfast trunk in ``VideoShgVqaModel``: hg_logit and one train step's
losses within 1e-4 of JAX's."""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu.models import backbones_extra as jax_extra
from shgvqa_tpu.models.shgvqa import VideoShgVqaModel as JaxVideoModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from shgvqa_tpu.utils import ref_import as jax_ref_import
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import to_jax_variables
from shgvqa_tpu_torch.models import backbone, backbones_extra, layers, shgvqa
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel
from shgvqa_tpu_torch.train import step
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from shgvqa_tpu_torch.utils import convert_resnext101, convert_slowfast
from shgvqa_tpu_torch.utils import ref_import
from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize
from test_torch_common import close, load_port, perturb, t
from test_torch_train_step import LOSS_TOL, LR, T_TOTAL
from test_torch_train_trunk import _jax_mask

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import convert_resnext101 as tool_resnext  # noqa: E402
import convert_slowfast as tool_slowfast  # noqa: E402
import test_resnext_convert as jax_resnext_test  # noqa: E402
import test_slowfast_convert as jax_slowfast_test  # noqa: E402

RESNEXT = dict(depths=(2, 1, 1, 1), groups=4, width_per_group=2,
               stem_width=8, outs=(16, 32, 64, 128))
SLOWFAST = dict(depths=(2, 1, 1, 1), stem_width=16, mids=(8, 16, 32, 64),
                outs=(32, 64, 128, 256))
FEATURE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# helpers shared with test_torch_mvit.py and test_torch_video_swin.py

def trunk_pair(jax_mod, port_mod, x, seed=0):
    """(JAX features, port features, JAX variables, port trunk) on frames
    ``x``: one jitted JAX init (perturbed) and apply."""
    v = jax.jit(jax_mod.init)(jax.random.PRNGKey(seed), x)
    v = jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(v), np.random.RandomState(seed + 1)))
    want = np.asarray(jax.jit(jax_mod.apply)(v, x))
    port = load_port(port_mod, v)
    with torch.no_grad():
        got = port(t(x)).numpy()
    return want, got, v, port


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def round_trip(variables, port):
    """``to_jax_variables`` of the port's state gives JAX's variables back
    bit for bit."""
    assert_trees_equal(to_jax_variables(port.state_dict()),
                       jax.device_get(variables))


def load_through_trainer(tree, trunk, tmp_path):
    """The hub converter's tree, written as the trunk-file msgpack, loaded
    strictly by ``Trainer.load_backbone`` into ``trunk``; returns it."""
    path = tmp_path / "trunk.msgpack"
    path.write_bytes(msgpack_serialize(tree))
    logged = []
    stand_in = types.SimpleNamespace(
        model=types.SimpleNamespace(backbone=trunk),
        metrics=types.SimpleNamespace(log=logged.append),
        _reset_opt=lambda: None)
    Trainer.load_backbone(stand_in, str(path))
    assert logged and "Loaded pretrained backbone" in logged[0]
    assert_trees_equal(to_jax_variables(trunk.state_dict()), tree)
    return trunk


def meta_shape(name, frames_shape, **geometry):
    """The full-width trunk's output shape on ``meta``, bf16."""
    with torch.device("meta"):
        trunk = backbone.make_backbone(name, torch.bfloat16, **geometry)
        with torch.no_grad():
            return tuple(trunk(torch.empty(frames_shape)).shape)


def jax_shape(name, frames_shape):
    mod = jax_backbone.make_backbone(name, jnp.bfloat16)
    x = jax.ShapeDtypeStruct(frames_shape, jnp.float32)
    out = jax.eval_shape(
        lambda a: mod.init_with_output(jax.random.PRNGKey(0), a)[0], x)
    return tuple(out.shape)


def video_parity(monkeypatch, jax_trunk, port_trunk, cfg_kw, frames,
                 data_kw):
    """hg_logit (eval) and one train step's losses of ``VideoShgVqaModel``
    with the given TOY trunks (frozen) in both packages, f32, dropout off,
    from uint8 ``frames``."""
    enc = dict(cfg_kw)
    jcfg = jax_tiny(task="hgqa", freeze_backbone=True)
    jcfg = jcfg.replace(encoder=dataclasses.replace(jcfg.encoder, **enc),
                        data=dataclasses.replace(jcfg.data, **data_kw))
    cfg = tiny_test_config(task="hgqa", freeze_backbone=True)
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, **enc),
                      data=dataclasses.replace(cfg.data, **data_kw))
    rng = np.random.RandomState(0)
    d, e, b = cfg.data, cfg.encoder, 2
    mask = np.ones((b, d.max_seq_length), np.int32)
    mask[1, d.max_seq_length // 2:] = 0
    s = d.num_situations
    batch = dict(
        input_ids=rng.randint(1, e.vocab_size, (b, d.max_seq_length)
                              ).astype(np.int32),
        input_mask=mask,
        segment_ids=np.zeros((b, d.max_seq_length), np.int32),
        frames=frames,
        rel_labels=rng.randint(1, cfg.num_rel_classes + 1,
                               (b, s, d.num_rel)).astype(np.int32),
        rel_lengths=rng.randint(1, d.num_rel + 1, (b, s)).astype(np.int32),
        act_labels=rng.randint(1, cfg.num_act_classes + 1,
                               (b, s, d.num_act)).astype(np.int32),
        act_lengths=rng.randint(1, d.num_act + 1, (b, s)).astype(np.int32),
        target=np.eye(cfg.num_answers, dtype=np.float32)[[1, 4]])

    monkeypatch.setattr(jax_backbone, "make_backbone",
                        lambda name, dtype, quant="": jax_trunk)
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype, **kw: port_trunk)
    jmodel = JaxVideoModel(jcfg)
    init = jax.jit(lambda r, x: jmodel.init(r, x, deterministic=True))
    v = jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(init(jax.random.PRNGKey(0), batch)),
        np.random.RandomState(1)))
    want = jax.jit(lambda p, x: jmodel.apply(p, x, deterministic=True))(
        v, batch)
    port = load_port(VideoShgVqaModel(cfg), v)
    tb = {k: t(x) for k, x in batch.items()}
    with torch.inference_mode():
        got = port(tb)
    close(got["hg_logit"], want["hg_logit"], FEATURE_TOL)
    assert port.head.cfg.encoder.visual_seq_length == e.visual_seq_length

    # the JAX drivers' mask (test_torch_train_trunk); a trunk without
    # BatchNorm has no batch_stats
    mask = (_jax_mask(v, jcfg) if "batch_stats" in v
            else _jax_mask(dict(v, batch_stats={}), jcfg))
    mask = {k: m for k, m in mask.items() if k in v}
    tx = jax_make_optimizer(LR, T_TOTAL, trainable_mask=mask)
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    train_step = jax.jit(jax_step.make_train_step(jcfg, jmodel, tx))
    _, _, metrics = train_step(v, tx.init(v), batch, jax.random.PRNGKey(0))
    port.train()
    layers.set_dropout_rate(port, 0.0)
    opt = make_optimizer(port, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(port, cfg))
    got = step.make_train_step(cfg, port, opt)(
        tb, torch.Generator().manual_seed(0))
    for key, value in jax.device_get(metrics).items():
        close(got[key], value, LOSS_TOL)


# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    rng = np.random.RandomState(0)
    out = {}
    x = rng.randn(2, 2, 32, 32, 3).astype(np.float32)
    out["resnext101"] = trunk_pair(
        jax_extra.ResNeXt101(**RESNEXT),
        backbones_extra.ResNeXt101(torch.float32, **RESNEXT), x)
    x = rng.randn(2, 8, 32, 32, 3).astype(np.float32)
    out["slowfast"] = trunk_pair(
        jax_extra.SlowFastR50(**SLOWFAST),
        backbones_extra.SlowFastR50(torch.float32, **SLOWFAST), x)
    return out


@pytest.mark.parametrize("name", ["resnext101", "slowfast"])
def test_toy_features_match_jax(pairs, name):
    want, got, _, port = pairs[name]
    assert got.shape == want.shape
    assert want.shape[-1] == port.out_channels
    assert want.shape[2] == port.spatial_out(32)
    assert want.shape[1] == port.temporal_out(want.shape[1])
    assert rel_err(got, want) <= FEATURE_TOL


@pytest.mark.parametrize("name", ["resnext101", "slowfast"])
def test_convert_round_trip_is_bit_equal(pairs, name):
    _, _, v, port = pairs[name]
    round_trip(v, port)


def _hub_state_dict(test_module, ctor, norm):
    torch.manual_seed(0)
    m = ctor()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, norm):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 1.5)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.5, 0.5)
    return {k: v.detach().numpy() for k, v in m.state_dict().items()
            if "num_batches_tracked" not in k}


def test_slowfast_hub_converter_is_the_tools_and_loads(tmp_path):
    jt = jax_slowfast_test
    sd = _hub_state_dict(jt, jt._ToySlowFast, torch.nn.BatchNorm3d)
    tree = convert_slowfast.convert(sd, jt.DEPTHS)
    assert_trees_equal(tree, tool_slowfast.convert(sd, depths=jt.DEPTHS))
    trunk = backbones_extra.SlowFastR50(
        torch.float32, alpha=jt.ALPHA, beta_inv=jt.BETA_INV,
        fusion_ratio=jt.FUSION_RATIO, fusion_kernel=jt.FUSION_K,
        depths=jt.DEPTHS, stem_width=jt.STEM_W, mids=jt.MIDS, outs=jt.OUTS)
    load_through_trainer(tree, trunk, tmp_path)


def test_resnext_hub_converter_is_the_tools_and_loads(tmp_path):
    jt = jax_resnext_test
    sd = _hub_state_dict(jt, jt._ToyResNeXt, torch.nn.BatchNorm2d)
    tree = convert_resnext101.convert(sd, jt.DEPTHS)
    assert_trees_equal(tree, tool_resnext.convert(sd, depths=jt.DEPTHS))
    trunk = backbones_extra.ResNeXt101(
        torch.float32, depths=jt.DEPTHS, groups=jt.GROUPS,
        width_per_group=jt.WIDTH_PER_GROUP, stem_width=jt.STEM_W,
        outs=jt.OUTS)
    load_through_trainer(tree, trunk, tmp_path)


@pytest.mark.parametrize("name,depths", [
    ("slowfast_r50", (3, 4, 6, 3)), ("slowfast_r101", (3, 4, 23, 3)),
    ("resnext101", (3, 4, 23, 3))])
def test_reference_checkpoint_trunk_imports_as_jaxs(monkeypatch, name,
                                                    depths):
    """A reference checkpoint's ``vid_encoder.backbone.*`` trunk at the
    trunk's real depths (toy widths) through the port's importer and the
    JAX one: the same tree."""
    jt = jax_resnext_test if name == "resnext101" else jax_slowfast_test
    monkeypatch.setattr(jt, "DEPTHS", depths)
    ctor = jt._ToyResNeXt if name == "resnext101" else jt._ToySlowFast
    norm = (torch.nn.BatchNorm2d if name == "resnext101"
            else torch.nn.BatchNorm3d)
    sd = {f"vid_encoder.backbone.{k}": v
          for k, v in _hub_state_dict(jt, ctor, norm).items()}
    assert_trees_equal(ref_import._convert_backbone(sd, name),
                       jax_ref_import._convert_backbone(sd, name))


def test_registry_refusals_are_jaxs():
    for args in (("video_swin",), ("resnext101", jnp.float32, "int8")):
        with pytest.raises(NotImplementedError) as want:
            jax_backbone.make_backbone(*args)
        port_args = (args[0], torch.float32, *args[2:])
        with pytest.raises(NotImplementedError) as got:
            backbone.make_backbone(*port_args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,frames", [
    ("resnext101", (2, 16, 224, 224, 3)),
    ("slowfast_r50", (2, 16, 256, 256, 3)),
    ("slowfast_r101", (2, 16, 256, 256, 3))])
def test_full_width_shapes_on_meta_are_jaxs(name, frames):
    want = jax_shape(name, frames)
    assert meta_shape(name, frames) == want
    assert want[-1] == (2304 if name.startswith("slowfast") else 2048)


@pytest.mark.parametrize("name,want", [
    ("slowfast_r50", [(8, 64, 64, 256)] * 2 + [(8, 32, 32, 512)] * 3),
    ("slow_r50", [(32, 56, 56, 64)] + [(32, 56, 56, 256)] * 2
     + [(32, 28, 28, 512)] * 3)])
def test_block_switch_routes_the_blocks_the_kernel_takes(monkeypatch, name,
                                                         want):
    """Full width on ``meta`` (not the CPU, where the plain version takes
    any widths): with ``set_block_kernel`` on, slowfast routes its slow
    res_2 blocks 1-2 and res_3 blocks 1-3 (res_2 block 0 takes 64 + 16
    fused channels; every fast block has temporal kernel 3), slow_r50 its
    six blocks, each at a shape ``kernels.bottleneck.takes``."""
    calls = []

    def spy(x, wa, *args):
        calls.append(tuple(x.shape))
        assert backbone.takes(x.shape[-1], wa.shape[0], args[6].shape[0])
        return x.new_empty(*x.shape[:3], args[6].shape[0])

    monkeypatch.setattr(backbone, "fused_bottleneck", spy)
    frames = (2, 16, 256 if name.startswith("slowfast") else 224) + (
        256 if name.startswith("slowfast") else 224, 3)
    with torch.device("meta"):
        trunk = backbone.make_backbone(name, torch.bfloat16)
        backbone.set_block_kernel(trunk, True)
        with torch.no_grad():
            trunk(torch.empty(frames))
    assert calls == want


def test_slowfast_video_model_matches_jax(monkeypatch):
    """A TOY slowfast trunk in ``VideoShgVqaModel``: 10 frames of 64 pixels
    (T kept, 2 x 2 grid, 288 channels) into the conv tokenizer."""
    frames = np.random.RandomState(2).randint(
        0, 255, (2, 10, 64, 64, 3)).astype(np.uint8)
    video_parity(
        monkeypatch, jax_extra.SlowFastR50(**SLOWFAST),
        backbones_extra.SlowFastR50(torch.float32, **SLOWFAST),
        dict(visual_t=2, visual_hw=2, visual_feat_dim=288), frames,
        dict(image_size=64))


@pytest.mark.parametrize("extra,error,match", [
    (["--backbone", "video_swin"], NotImplementedError,
     "'video_swin_impl' provides"),
    (["--backbone", "resnext101", "--quantBackbone", "int8",
      "--freezeBackbone"], NotImplementedError, "implemented for slow_r50"),
    (["--backbone", "mvit_B"], ValueError, "mvit_B gives 8 time steps from "
     "--clipLEN 16"),
    (["--backbone", "video_swin_impl"], ValueError,
     "video_swin_impl gives 8 time steps from --clipLEN 16")])
def test_driver_refuses_as_the_registry_and_the_time_axis(tmp_path, extra,
                                                          error, match):
    """The agqa_hgqa driver on these flags raises before any step: the
    registry's refusals (JAX's messages: ``test_registry_refusals_are_jaxs``)
    and a halving trunk at the default --clipLEN 16 with --noCaps."""
    from shgvqa_tpu_torch.cli import agqa_hgqa

    argv = ["--taskHGQA", "--noCaps", "--tiny", "--syntheticData", "8",
            "--batchSize", "2", "--epochs", "1", "--output", str(tmp_path),
            "--dataDir", str(tmp_path), *extra]
    with pytest.raises(error, match=match):
        agqa_hgqa.main(argv, device="cpu")

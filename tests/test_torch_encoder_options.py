"""The visual encoder's options in the port against the JAX package at
tiny_test_config size in f32: the capsule path (without and with
``--crossAttn``), ``--sharedWeights``, ``--patches`` and ``--vitInit``.

- ``ViTBlock`` (1e-5, with its probabilities) and ``patchify_clip``
  (exact);
- ``LXRTModel`` (embeddings, tri-stream encoder, pooler) on featurized
  inputs and ``VideoShgVqaModel`` from uint8 frames (the toy-width trunk;
  no trunk under ``--patches``), 1e-4, for each option;
- ``Trainer.load_vit_layers`` on a random timm-style state_dict against
  the JAX ``Trainer.load_vit_layers`` (exact), and the driver's
  ``--vitWeights`` / ``--startIndex`` load and its missing-file notice;
- the kernel switches on models without the conv tokenizer or the trunk.

One jitted JAX apply per option and model, on seeded random weights whose
tree comes from ``jax.eval_shape`` (no init compiled)."""

import contextlib
import dataclasses
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu.models.encoder import LXRTModel as JaxLXRTModel
from shgvqa_tpu.models.shgvqa import VideoShgVqaModel as JaxVideoModel
from shgvqa_tpu.models.visual import patchify_clip as jax_patchify_clip
from shgvqa_tpu.models.vit import ViTBlock as JaxViTBlock
from shgvqa_tpu.train.loop import Trainer as JaxTrainer
from shgvqa_tpu_torch.cli import common
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.models import shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50, set_block_kernel
from shgvqa_tpu_torch.models.encoder import LXRTModel
from shgvqa_tpu_torch.models.layers import extend_mask, init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from shgvqa_tpu_torch.models.visual import patchify_clip, set_tok_kernel
from shgvqa_tpu_torch.models.vit import ViTBlock
from shgvqa_tpu_torch.train.loop import Trainer
from test_torch_common import TOY, close, load_port, perturb, t

TOL = 1e-4
# encoder overrides of each option (the tiny config's 2 frames of 2 x 2
# features: 9 visual tokens on every path)
OPTIONS = {
    "capsules": dict(no_caps=False),
    "capsules_crossAttn": dict(no_caps=False, caps_cross_attn=True),
    "sharedWeights": dict(shared_weights=True),
    "patches": dict(patches=True),
    "vitInit": dict(vit_init=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def toy_trunks():
    """Both packages' trunks at the toy widths."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_backbone, "make_backbone",
               lambda name, dtype, quant="": JaxSlowR50(dtype=dtype, **TOY))
    mp.setattr(shgvqa, "make_backbone",
               lambda name, dtype: SlowR50(dtype, **TOY))
    yield
    mp.undo()


def option_cfgs(option, task="hgqa"):
    """(JAX cfg, port cfg) of an option."""
    def build(tiny):
        cfg = tiny(task=task)
        return cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                       **OPTIONS[option]))
    return build(jax_tiny), build(tiny_test_config)


def random_variables(init, seed=0):
    """Seeded random variables of a flax init's tree (its shapes from
    ``jax.eval_shape``): norm scales 1 + 0.05 N, BatchNorm variances
    1 + |0.05 N|, every other leaf 0.05 N."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, x in tree.items():
            if isinstance(x, dict):
                out[key] = fill(x)
                continue
            noise = 0.05 * rng.randn(*x.shape).astype(np.float32)
            out[key] = jnp.asarray(np.abs(noise) + 1.0 if key == "var"
                                   else noise + (key == "scale"))
        return out
    return fill(jax.tree_util.tree_map(
        lambda x: x, jax.eval_shape(init),
        is_leaf=lambda x: not isinstance(x, dict)))


def _text(cfg, rng, bsz=2):
    d, e = cfg.data, cfg.encoder
    mask = np.ones((bsz, d.max_seq_length), np.int32)
    mask[1, d.max_seq_length // 2:] = 0             # a padded question
    return {"input_ids": rng.randint(1, e.vocab_size, (bsz, d.max_seq_length)
                                     ).astype(np.int32),
            "input_mask": mask,
            "segment_ids": np.zeros((bsz, d.max_seq_length), np.int32)}


# -- the blocks --------------------------------------------------------------

def test_vit_block_matches_jax():
    """A pre-LN ViT block (4 heads of 8, MLP ratio 2) and its
    probabilities, on perturbed JAX weights."""
    jblock = JaxViTBlock(num_heads=4, head_dim=8, mlp_ratio=2)
    x = np.random.RandomState(0).randn(2, 9, 32).astype(np.float32)
    v = jax.jit(jblock.init)(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(v), np.random.RandomState(1)))
    want, want_probs = jblock.apply(v, x, None, True, True)
    port = load_port(ViTBlock(32, 4, 8, 2), v)
    with torch.inference_mode():
        got, probs = port(t(x), None, None, True)
        mask = extend_mask(torch.zeros(2, 9), torch.float32)
        close(port(t(x), mask), want, 1e-5)       # the mask is ignored
    close(got, want, 1e-5)
    close(probs, want_probs, 1e-5)


def test_patchify_clip_matches_jax():
    """Uniformly subsampled frames cut into non-overlapping patches,
    (row, column, channel) order: bit-equal, also on uint8 frames."""
    frames = np.random.RandomState(0).randint(
        0, 255, (2, 5, 12, 12, 3)).astype(np.uint8)
    for visual_t, hw in ((3, 2), (5, 3), (1, 4)):
        want = np.asarray(jax_patchify_clip(frames, visual_t, hw))
        got = patchify_clip(t(frames), visual_t, hw)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not divisible"):
        patchify_clip(t(frames), 2, 5)


# -- the encoder ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lxrt_run(option):
    """(port cfg, variables, inputs, JAX outputs) of the tiny LXRTModel of
    ``option``."""
    jcfg, cfg = option_cfgs(option)
    e = cfg.encoder
    rng = np.random.RandomState(0)
    text = _text(cfg, rng)
    feats = rng.randn(2, e.frames_t, e.visual_hw, e.visual_hw,
                      e.visual_feat_dim).astype(np.float32)
    vmask = np.ones((2, e.visual_seq_length), np.int32)
    vmask[0, -3:] = 0                               # padded visual tokens
    args = (text["input_ids"], text["input_mask"], text["segment_ids"],
            feats, vmask)
    jmodel = JaxLXRTModel(jcfg.encoder, "float32")
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), *args))
    want = jax.device_get(jax.jit(lambda v, *a: jmodel.apply(v, *a))(
        variables, *args))
    return cfg, variables, args, want


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_lxrt_model_matches_jax(option):
    """Pooled output, both streams and both pre-cross snapshots.  With
    capsules and no --crossAttn the encoder has no x-layers (the streams
    are their snapshots); under --sharedWeights no r-layers."""
    cfg, variables, args, want = lxrt_run(option)
    port = load_port(LXRTModel(cfg.encoder), variables)
    with torch.inference_mode():
        got = port(*(t(a) for a in args))
    for g, w in zip(got[:5], want[:5]):
        close(g, w, TOL)
    names = {n.split(".")[0] for n, _ in port.encoder.named_parameters()}
    assert ("x_tied" in names) == (option != "capsules")
    assert ("r_0" in names) == (option != "sharedWeights")
    assert ("caps_tokenizer" in names) == option.startswith("capsules")


@functools.lru_cache(maxsize=None)
def video_run(option):
    """(port cfg, variables, batch, JAX outputs) of the tiny 'vqa'
    VideoShgVqaModel of ``option`` from uint8 frames (4 frames, 32 x 32:
    the toy trunk's 1 x 1 features; under --patches 2 x 2 patches of 16 x
    16 of 2 frames subsampled)."""
    jcfg, cfg = option_cfgs(option, task="vqa")
    jcfg, cfg = (c.replace(data=dataclasses.replace(c.data, clip_len=4))
                 for c in (jcfg, cfg))
    e = cfg.encoder
    frames_t = e.frames_t if option != "patches" else cfg.data.clip_len
    rng = np.random.RandomState(1)
    batch = _text(cfg, rng)
    batch["frames"] = rng.randint(
        0, 255, (2, frames_t, 32, 32, 3)).astype(np.uint8)
    jmodel = JaxVideoModel(jcfg)
    variables = random_variables(lambda: jmodel.init(
        jax.random.PRNGKey(0), batch, deterministic=True))
    want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, deterministic=True))(variables, batch))
    return cfg, variables, batch, want


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_video_model_matches_jax(option):
    """uint8 frames -> logit; under --patches no trunk is built and the
    tokenizer's input width is a patch's 16 * 16 * 3 pixels."""
    cfg, variables, batch, want = video_run(option)
    model = VideoShgVqaModel(cfg)
    assert (model.backbone is None) == (option == "patches")
    port = load_port(model, variables)
    with torch.inference_mode():
        got = port({k: t(v) for k, v in batch.items()})
    close(got["logit"], want["logit"], TOL)
    if option == "patches":
        tok = port.head.lxrt.encoder.visual_tokenizer
        assert tok.linear_encoding.weight.shape == (32, 16 * 16 * 3)


@pytest.mark.parametrize("option", ["capsules", "patches", "vitInit"])
def test_kernel_switches_on_every_option(option):
    """The tokenizer and trunk switches on a model without the conv
    tokenizer (capsules) or without the trunk (patches): nothing to route
    and no error; on the capsule and ViT paths the trunk's blocks still
    take the block switch.  The outputs stay the plain path's (the CPU
    takes each kernel's plain version)."""
    cfg, variables, batch, want = video_run(option)
    port = load_port(VideoShgVqaModel(cfg), variables)
    set_tok_kernel(port, True)
    set_block_kernel(port, True)
    blocks = [m for m in port.modules() if hasattr(m, "use_kernel")
              and type(m).__name__ == "Bottleneck3D"]
    assert bool(blocks) == (option != "patches")
    assert all(m.use_kernel for m in blocks)
    with torch.inference_mode():
        got = port({k: t(v) for k, v in batch.items()})
    close(got["logit"], want["logit"], TOL)


def test_capsule_path_takes_the_int8_trunk(monkeypatch):
    """--quantBackbone int8 under the capsule path: the int8 trunk (toy
    widths) is calibrated on the frames and feeds the capsule tokenizer;
    its features equal the int8 trunk's own forward on the normalized
    frames, and the answer is finite."""
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype, quant="": SlowR50(
                            dtype, quant=quant, **TOY))
    _, cfg = option_cfgs("capsules", task="vqa")
    cfg = cfg.replace(quant_backbone="int8", freeze_backbone=True)
    model = init_weights(VideoShgVqaModel(cfg), 4).eval()
    assert model.backbone.quant
    rng = np.random.RandomState(2)
    batch = {k: t(v) for k, v in _text(cfg, rng).items()}
    batch["frames"] = t(rng.randint(0, 255, (2, cfg.encoder.frames_t, 32, 32,
                                            3)).astype(np.uint8))
    model.calibrate_quant(batch["frames"])
    with torch.inference_mode():
        feats = model.encode_frames(batch["frames"])
        want = model.backbone(model.normalize_frames(batch["frames"]))
        out = model(batch)
    assert torch.equal(feats, want)
    assert feats.shape[1] == cfg.encoder.visual_t
    assert torch.isfinite(out["logit"]).all()


# -- --vitInit's weights -------------------------------------------------------

def timm_state_dict(num_blocks, d, mlp, seed=0):
    """A random timm ViT state_dict (torch tensors) of ``num_blocks``
    blocks of width d, MLP width ``mlp``, with the patch embedding a real
    checkpoint also holds."""
    rng = np.random.RandomState(seed)
    sd = {"patch_embed.proj.weight": rng.randn(d, 3, 32, 32),
          "cls_token": rng.randn(1, 1, d)}
    for i in range(num_blocks):
        p = f"blocks.{i}"
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)),
                            ("attn.qkv.bias", (3 * d,)),
                            ("attn.proj.weight", (d, d)),
                            ("attn.proj.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (mlp, d)),
                            ("mlp.fc1.bias", (mlp,)),
                            ("mlp.fc2.weight", (d, mlp)),
                            ("mlp.fc2.bias", (d,))):
            sd[f"{p}.{name}"] = rng.randn(*shape)
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}


class _JaxTrainerStandIn:
    """What the JAX ``Trainer.load_vit_layers`` reads of its trainer."""

    _encoder_root = staticmethod(JaxTrainer._encoder_root)
    load_vit_layers = JaxTrainer.load_vit_layers

    def __init__(self, params):
        self.params = params
        self.logged = []

    @property
    def metrics(self):
        return self

    def log(self, msg):
        self.logged.append(msg)

    def _reset_opt(self):
        pass


@pytest.mark.parametrize("start", [0, 2])
def test_load_vit_layers_matches_jax(tmp_path, start):
    """Blocks [start, start + 2) of a 4-block checkpoint into the two ViT
    r-layers: every parameter of the model equal to the JAX trainer's
    load of the same file into the same weights; the optimizer restarts.
    A model without ViT r-layers and a checkpoint too short raise."""
    _, cfg = option_cfgs("vitInit")
    cfg = cfg.replace(output=str(tmp_path / "out"))
    path = str(tmp_path / "vit.bin")
    torch.save(timm_state_dict(4, 32, 64), path)
    model = init_weights(ShgVqaModel(cfg), 3)
    trainer = Trainer(cfg, 1, model)
    before = to_jax_variables(model.state_dict())
    trainer.optimizer.m[0].fill_(1.0)
    trainer.load_vit_layers(path, start)
    assert not trainer.optimizer.m[0].any()
    jax_trainer = _JaxTrainerStandIn(jax.tree_util.tree_map(jnp.asarray,
                                                            before))
    jax_trainer.load_vit_layers(path, start)
    want = from_jax_variables(jax.device_get(jax_trainer.params))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    sd = torch.load(path, weights_only=True)
    assert torch.equal(got["lxrt.encoder.r_1.qkv.weight"],
                       sd[f"blocks.{start + 1}.attn.qkv.weight"])
    with pytest.raises(ValueError, match="cannot take 2 blocks"):
        trainer.load_vit_layers(path, 3)
    plain = Trainer(tiny_test_config(task="hgqa", output=str(tmp_path)), 1,
                    init_weights(ShgVqaModel(tiny_test_config()), 0))
    with pytest.raises(ValueError, match="not ViT blocks"):
        plain.load_vit_layers(path)


def test_driver_loads_vit_weights_or_says_it_did_not(tmp_path, monkeypatch):
    """``load_pretrained_weights`` under --vitInit: ``--vitWeights`` at
    ``--startIndex`` loads; without a file the JAX driver's notice; under
    --patches no trunk file is looked for."""
    cfg, extras = common.parse_reference_flags_with_extras(
        ["--taskHGQA", "--vitInit", "--dataDir", str(tmp_path), "--output",
         str(tmp_path / "out"), "--fromScratch"], dataset="agqa")
    assert cfg.encoder.vit_init and extras["start_index"] == 7
    calls = []

    class Spy:
        def load_backbone(self, path):
            calls.append(("backbone", path))

        def load_vit_layers(self, path, start):
            calls.append(("vit", os.path.basename(path), start))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        common.load_pretrained_weights(Spy(), cfg, extras)
    assert "no ViT weights at" in out.getvalue() and calls == []
    (tmp_path / "vit_base_patch32_224.bin").write_bytes(b"")
    common.load_pretrained_weights(Spy(), cfg, dict(extras, start_index=4))
    assert calls == [("vit", "vit_base_patch32_224.bin", 4)]
    (tmp_path / "slow_r50_flax.msgpack").write_bytes(b"")
    calls.clear()
    common.load_pretrained_weights(Spy(), cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, vit_init=False,
                                    patches=True)), extras)
    assert calls == []

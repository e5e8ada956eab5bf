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
from shgvqa_tpu.kernels import attention as pallas_attn
from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.models.shgvqa import VideoShgVqaModel as JaxVideoModel
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models import layers, shgvqa
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from test_torch_common import TOY, close, jax_variables, load_port, perturb, t

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


def test_video_model_with_pallas_attention_matches_jax(monkeypatch):
    """``--pallasAttention`` (``use_pallas_attention``): frames -> answer
    with every attention site outside training on ``fused_attention`` at
    rate 0 (its plain version on the CPU), against the JAX model with the
    flag on as its Trainer sets it (``pallas_attn.enable``; off the TPU the
    JAX sites take their jnp path).  Both trunks at the TOY widths."""
    monkeypatch.setattr(jax_backbone, "make_backbone",
                        lambda name, dtype, quant="": JaxSlowR50(dtype=dtype,
                                                                 **TOY))
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))
    jmodel = JaxVideoModel(jax_tiny(task="hgqa", freeze_backbone=True,
                                    use_pallas_attention=True))
    batch = _batch(jax_tiny(), frames=True)
    v = jax_variables(jmodel, batch, deterministic=True)
    pallas_attn.enable(True)
    try:
        want = jmodel.apply(v, batch, deterministic=True)
    finally:
        pallas_attn.enable(False)
    port = load_port(VideoShgVqaModel(tiny_test_config(
        task="hgqa", freeze_backbone=True, use_pallas_attention=True)), v)
    calls = []
    fused = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention",
                        lambda *a: calls.append(a[4:]) or fused(*a))
    with torch.inference_mode():
        got = port(_torch_batch(batch))
    assert calls and all(rest == (0.0,) for rest in calls)
    for key in OUTPUTS:
        close(got[key], want[key], TOL)


def test_video_model_with_the_int8_trunk_matches_jax(monkeypatch):
    """The JAX model's perturbed weights, its scales recalibrated on the
    batch (an apply with ``mutable=["quant_stats"]``), carried to the port
    with the scales: logit and hg_logit by the quant-step criterion."""
    monkeypatch.setattr(
        jax_backbone, "make_backbone",
        lambda name, dtype, quant="": JaxSlowR50(dtype=dtype,
                                                 quant=bool(quant), **TOY))
    monkeypatch.setattr(
        shgvqa, "make_backbone",
        lambda name, dtype, quant="": SlowR50(dtype, quant=bool(quant),
                                              **TOY))
    over = dict(task="hgqa", freeze_backbone=True, quant_backbone="int8")
    jmodel = JaxVideoModel(jax_tiny(**over))
    batch = _batch(jax_tiny(), frames=True)
    init = jax.device_get(jax.jit(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                              deterministic=True))(batch))
    v = {k: jax.tree_util.tree_map(jnp.asarray, perturb(
        init[k], np.random.RandomState(i)))
        for i, k in enumerate(("params", "batch_stats"))}
    v["quant_stats"] = jax.tree_util.tree_map(jnp.zeros_like,
                                              init["quant_stats"])
    calibrate = jax.jit(lambda v, b: jmodel.apply(
        v, b, deterministic=True, mutable=["quant_stats"])[1])
    v["quant_stats"] = calibrate(v, batch)["quant_stats"]
    want = jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True))(
        v, batch)
    v = jax.device_get(v)
    port = load_port(VideoShgVqaModel(tiny_test_config(**over)), v)
    assert port.backbone.calibrated
    with torch.inference_mode():
        got = port({k: torch.as_tensor(a) for k, a in batch.items()})
    for key in ("logit", "hg_logit"):
        a = np.asarray(got[key], np.float64).ravel()
        b = np.asarray(want[key], np.float64).ravel()
        corr = np.corrcoef(a, b)[0, 1]
        err = np.abs(a - b).max() / np.abs(b).max()
        assert corr > 0.999 and err < 0.05, (key, corr, err)


def test_attention_kernel_eval_routes_every_site(monkeypatch):
    """With ``use_pallas_attention`` every attention site outside training
    calls ``fused_attention`` (rate 0) in place of ``attend``, and
    ``set_attention_kernel_eval`` turns it off again; the default config
    leaves it off."""
    calls = {"fused": 0, "attend": 0}
    fused, attend = layers.fused_attention, layers.attend

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(layers, "fused_attention", counted("fused", fused))
    monkeypatch.setattr(layers, "attend", counted("attend", attend))
    batch = _torch_batch(_batch(jax_tiny()))
    cfg = tiny_test_config(task="hgqa")
    assert not cfg.use_pallas_attention
    model = init_weights(ShgVqaModel(cfg), 0).eval()
    with torch.inference_mode():
        want = model(batch)
        sites = calls["attend"]
        assert sites > 0 and calls["fused"] == 0
        layers.set_attention_kernel_eval(model, True)
        got = model(batch)
        assert calls == {"fused": sites, "attend": sites}
        layers.set_attention_kernel_eval(model, False)
        model(batch)
        assert calls == {"fused": sites, "attend": 2 * sites}
    for key in OUTPUTS:
        close(got[key], np.asarray(want[key]), 1e-5)
    flagged = ShgVqaModel(tiny_test_config(task="hgqa",
                                           use_pallas_attention=True))
    kernel_eval = [m.kernel_eval for m in flagged.modules()
                   if hasattr(m, "kernel_eval")]
    assert len(kernel_eval) > 0 and all(kernel_eval)


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
    dict(backbone="slowfast_r101"), dict(backbone="mvit_B"),
    dict(backbone="video_swin"), dict(backbone="slowfast_r50"),
    dict(encoder="scan_layers"), dict(backbone="video_swin_impl"),
    dict(backbone="resnext101"),
    dict(backbone="resnext101", quant_backbone="int8", freeze_backbone=True),
])
def test_unported_options_raise(override):
    """What the port does not build raises naming it: plain 'video_swin'
    as the reference does; --quantBackbone int8 with a
    trunk other than slow_r50, as the JAX package does.  Every other trunk
    of the JAX registry builds (queue A item 17's trunk half; built on
    ``meta`` here: tests/test_torch_backbones_extra.py, test_torch_mvit.py
    and test_torch_video_swin.py hold them to JAX).  (The tasks and
    options of queue A item 15 build too: tests/test_torch_tasks.py, and
    per-choice QA and --outputAttn: ``test_item_15_options_build``; the
    int8 trunk and --backboneChunks: tests/test_torch_quant_backbone.py;
    the capsule, patch and ViT encoders and shared weights:
    ``test_item_17_encoder_options_build`` and
    tests/test_torch_encoder_options.py.  The scanned stacks build since
    queue A position 14: the same per-layer modules,
    tests/test_torch_scan_stacks.py.)"""
    cfg = tiny_test_config(task="hgqa")
    if "encoder" in override:
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, **{override["encoder"]: True}))
    else:
        cfg = cfg.replace(**override)
    refusals = {"video_swin": "'video_swin_impl' provides",
                "int8": "implemented for slow_r50"}
    why = [m for k, m in refusals.items()
           if k in (override.get("encoder"), override.get("backbone"),
                    override.get("quant_backbone"))]
    with torch.device("meta"):
        if why:
            with pytest.raises(NotImplementedError, match=why[0]):
                VideoShgVqaModel(cfg)
        else:
            trunk = VideoShgVqaModel(cfg).backbone
            assert trunk.out_channels == {
                "resnext101": 2048, "mvit_B": 768, "slow_r50": 2048,
                "video_swin_impl": 1024}.get(cfg.backbone, 2304)


@pytest.mark.parametrize("field,value,present,absent", [
    ("shared_weights", True, {"l_0", "visual_tokenizer"},
     {"r_0", "caps_tokenizer"}),
    ("patches", True, {"visual_tokenizer", "r_0"}, {"caps_tokenizer"}),
    ("no_caps", False, {"caps_tokenizer", "caps_mask", "caps_proj", "r_0"},
     {"visual_tokenizer", "x_tied"}),
    ("vit_init", True, {"r_0", "visual_tokenizer"}, {"caps_tokenizer"}),
], ids=["shared_weights", "patches", "capsules", "vit_init"])
def test_item_17_encoder_options_build(field, value, present, absent):
    """The encoder options of queue A item 17 build the video model: the
    capsule tokenizer, mask and projection and no x-layers (no
    --crossAttn); one layer stack under shared weights; the patch path
    without a trunk; ViT r-layers.  A forward in eval mode gives the
    model's outputs (tests/test_torch_encoder_options.py holds them to
    JAX)."""
    cfg = tiny_test_config(task="hgqa")
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  **{field: value}))
    model = VideoShgVqaModel(cfg)
    init_weights(model.head, 0)
    enc = dict(model.head.lxrt.encoder.named_children())
    assert present <= set(enc) and not absent & set(enc)
    assert (model.backbone is None) == (field == "patches")
    if field == "vit_init":
        assert hasattr(enc["r_0"], "qkv")
    batch = _torch_batch(_batch(jax_tiny(), frames=True))
    batch.pop("frames")
    e = model.head.cfg.encoder
    batch["visual_feats"] = torch.randn(2, e.frames_t, e.visual_hw,
                                        e.visual_hw, e.visual_feat_dim)
    batch["visual_mask"] = torch.ones(2, e.visual_seq_length)
    with torch.inference_mode():
        out = model.head(batch)
    assert set(out) == set(OUTPUTS)
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("override", [
    dict(qa_arrange_type="add_sep"), dict(qa_arrange_type="no_sep"),
    dict(output_attention=True)], ids=["add_sep", "no_sep", "outputAttn"])
def test_item_15_options_build(override):
    """Per-choice QA builds the choice head and no answer head;
    ``--outputAttn`` builds the plain model (the dumps are a forward
    option)."""
    cfg = tiny_test_config(task="hgqa")
    arrange = override.get("qa_arrange_type")
    if arrange:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   qa_arrange_type=arrange))
    else:
        cfg = cfg.replace(**override)
    names = {n.split(".")[1] for n, _ in
             VideoShgVqaModel(cfg).named_parameters() if n.startswith("head.")}
    assert ("choice_score_fc" in names) == bool(arrange)
    assert ("logit_fc" in names) != bool(arrange)


def test_training_mode_raises():
    """``--remat``, the option only training reads that used to raise in
    training mode, runs since ROADMAP queue A position 15: the training
    forward gives the outputs of the model without remat (the same
    generator's draws), and eval mode ignores it."""
    cfg = tiny_test_config(task="hgqa", remat=True)
    model = init_weights(ShgVqaModel(cfg), 0).train()
    plain = init_weights(ShgVqaModel(cfg.replace(remat=False)), 0).train()
    batch = _torch_batch(_batch(jax_tiny()))
    got = model(batch, torch.Generator().manual_seed(0))
    want = plain(batch, torch.Generator().manual_seed(0))
    assert set(got) == set(OUTPUTS)
    for key in OUTPUTS:
        assert torch.equal(got[key], want[key]), key
    with torch.inference_mode():
        assert set(model.eval()(batch)) == set(OUTPUTS)

"""The int8 frozen trunk (``--quantBackbone int8``) and ``--backboneChunks``
of the port against the JAX package (``shgvqa_tpu/models/backbone.py``
``SlowR50.quant``, ``tests/test_quant_backbone.py``), on the CPU in f32 at
the JAX test's TOY widths.

- the calibration (``calibrate_quant``, the counterpart of an apply with
  ``mutable=["quant_stats"]``) against JAX ``init``'s scales, 1e-6
  relative; the int8 trunk with JAX's variables against JAX's int8 trunk
  (correlation > 0.999, max |error| < 0.05 max |JAX|, the JAX test's
  quant-step criterion) and against the port's float trunk (the JAX
  bounds: max 0.1, mean 0.02 of max |ref|);
- ``--backboneChunks 2`` against 1 in training with RandAugment: the
  normalized frames and the features bit-equal (the frames -> answer
  model with the int8 trunk against JAX's is
  ``test_torch_model.py::test_video_model_with_the_int8_trunk_matches_jax``);
- checkpoints: the ``params`` and ``batch_stats`` identical across the
  flag, a plain checkpoint into an int8 model and back, the converted trunk
  file and a reference ``.pth`` into an int8 model; the guards and the CLI;
- the JAX driver's calibration fault: its ``init`` calibrates the random
  trunk and ``Trainer.load_backbone`` replaces only ``params`` and
  ``batch_stats``, so its scales stay the random trunk's; the port's
  driver calibrates the loaded trunk on the same example batch;
- the int8 trunk inside a ``--stepsPerLoop`` chunk makes no host read.
"""

import contextlib
import dataclasses
import io
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu.train.loop import Trainer as JaxTrainer
from shgvqa_tpu_torch.cli import agqa_hgqa, common
from shgvqa_tpu_torch.configs.cli import parse_reference_flags
from shgvqa_tpu_torch.configs.config import check_ported, tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.entry import build_model
from shgvqa_tpu_torch.models import backbone, shgvqa
from shgvqa_tpu_torch.models.backbone import (
    SlowR50,
    calibrate_quant,
    make_backbone,
)
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel
from shgvqa_tpu_torch.train import graph
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.step import trainable_mask
from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize
from test_torch_common import TOY, perturb
from test_torch_driver import FLAGS
from test_torch_reference_writer import (
    R50_TOY,
    reference_state_dict,
    save_torch,
)
from test_torch_steps_per_loop import _frames_batches, _no_host_reads


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(bsz=2, t=4, hw=32, seed=0):
    return np.random.RandomState(seed).randn(bsz, t, hw, hw, 3).astype(
        np.float32)


def _quant_error(got, want):
    """(correlation, max |got - want| / max |want|)."""
    a, b = np.asarray(got, np.float64).ravel(), np.asarray(want,
                                                          np.float64).ravel()
    return (np.corrcoef(a, b)[0, 1],
            np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _scales(module):
    return {k: v for k, v in module.state_dict().items()
            if k.rpartition(".")[2] in backbone.QUANT_STATS}


@pytest.fixture(scope="module")
def toy():
    """JAX's int8 TOY trunk initialized (so calibrated) on the frames, its
    variables as numpy, and the frames."""
    x = _frames()
    v = jax.device_get(jax.jit(JaxSlowR50(
        dtype=jnp.float32, quant=True, **TOY).init)(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    return v, x


def _port_trunk(variables, quant=True):
    trunk = SlowR50(quant=quant, **TOY).eval()
    trunk.load_state_dict(from_jax_variables(variables, trunk))
    return trunk


# ---------------------------------------------------------------------------
# The trunk

def test_calibration_matches_jax_init(toy):
    v, x = toy
    trunk = _port_trunk({k: v[k] for k in ("params", "batch_stats")})
    assert not trunk.calibrated
    calibrate_quant(trunk, torch.from_numpy(x))
    assert trunk.calibrated
    want = from_jax_variables({"quant_stats": v["quant_stats"]})
    got = _scales(trunk)
    assert got.keys() == want.keys() and len(got) == 13
    for k, w in want.items():
        assert got[k].shape == () and w.shape == ()
        np.testing.assert_allclose(got[k].item(), w.item(), rtol=1e-6)


def test_int8_trunk_matches_jax_and_tracks_the_float_trunk(toy):
    v, x = toy
    trunk = _port_trunk(v)
    assert trunk.calibrated                    # the scales came with them
    want = np.asarray(jax.jit(JaxSlowR50(
        dtype=jnp.float32, quant=True, **TOY).apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = trunk(torch.from_numpy(x)).numpy()
        ref = _port_trunk({k: v[k] for k in ("params", "batch_stats")},
                          quant=False)(torch.from_numpy(x)).numpy()
    corr, err = _quant_error(got, want)
    assert corr > 0.999 and err < 0.05, (corr, err)
    rel = np.abs(got - ref) / np.abs(ref).max()
    assert rel.max() < 0.1 and rel.mean() < 0.02


def test_calibration_accumulates_a_running_max_and_gates_the_forward(toy):
    v, x = toy
    trunk = _port_trunk({k: v[k] for k in ("params", "batch_stats")})
    with pytest.raises(RuntimeError, match="no scales"):
        with torch.no_grad():
            trunk(torch.from_numpy(x))
    calibrate_quant(trunk, torch.from_numpy(x))
    before = {k: t.clone() for k, t in _scales(trunk).items()}
    calibrate_quant(trunk, torch.from_numpy(3 * x))
    after = _scales(trunk)
    assert all(after[k] >= before[k] and after[k] > 0 for k in before)
    with pytest.raises(ValueError, match="int8 trunk"):
        calibrate_quant(SlowR50(**TOY), torch.from_numpy(x))


def test_loads_set_the_flag_and_cross_the_flag_both_ways(toy):
    v, _ = toy
    quant = _port_trunk(v)
    plain = SlowR50(**TOY)
    plain.load_state_dict(quant.state_dict())          # scales dropped
    again = SlowR50(quant=True, **TOY)
    again.load_state_dict(plain.state_dict())          # none: zeros, off
    assert not again.calibrated
    assert all(float(s) == 0.0 for s in _scales(again).values())
    again.load_state_dict(quant.state_dict())
    assert again.calibrated
    for k, t in quant.state_dict().items():
        assert torch.equal(again.state_dict()[k], t)
    partial = dict(quant.state_dict())
    del partial["res_2.block_0.s_a"]
    with pytest.raises(KeyError, match="incomplete"):
        SlowR50(quant=True, **TOY).load_state_dict(partial)


def test_param_tree_is_identical_across_the_flag(toy):
    v, _ = toy
    quant = init_weights(SlowR50(quant=True, **TOY), 3)
    plain = init_weights(SlowR50(**TOY), 3)
    vq, vf = (to_jax_variables(m.state_dict()) for m in (quant, plain))
    assert set(vq) == {"params", "batch_stats", "quant_stats"}
    assert set(vf) == {"params", "batch_stats"}
    for col in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, vq[col],
                               vf[col])
    # the JAX tree's paths and shapes, scales included
    for col in ("params", "batch_stats", "quant_stats"):
        assert (jax.tree_util.tree_structure(vq[col])
                == jax.tree_util.tree_structure(v[col]))
        jax.tree_util.tree_map(lambda a, b: a.shape == np.shape(b) or
                               pytest.fail(f"{col}: {a.shape}"), vq[col],
                               v[col])


def test_guards_and_the_cli_flag():
    with pytest.raises(NotImplementedError, match="slow_r50"):
        make_backbone("resnext101", quant="int8")
    with pytest.raises(ValueError, match="int8"):
        make_backbone("slow_r50", quant="int4")
    assert make_backbone("slow_r50", quant="int8").quant
    assert not make_backbone("slow_r50").quant
    with pytest.raises(ValueError, match="frozen"):
        VideoShgVqaModel(tiny_test_config(task="hgqa", freeze_backbone=False,
                                          quant_backbone="int8"))
    cfg = parse_reference_flags(
        "--train train --taskHGQA --noCaps --quantBackbone int8 "
        "--backboneChunks 4".split(), dataset="agqa")
    assert (cfg.quant_backbone, cfg.freeze_backbone,
            cfg.backbone_chunks) == ("int8", True, 4)
    check_ported(cfg, video=True, train=True)
    plain = parse_reference_flags("--train train --taskHGQA --noCaps".split(),
                                  dataset="agqa")
    assert plain.quant_backbone == "" and not plain.freeze_backbone


# ---------------------------------------------------------------------------
# The frames -> answer model

def _toy_trunks(monkeypatch, widths=TOY):
    monkeypatch.setattr(
        jax_backbone, "make_backbone",
        lambda name, dtype, quant="": JaxSlowR50(dtype=dtype,
                                                 quant=bool(quant), **widths))
    monkeypatch.setattr(
        shgvqa, "make_backbone",
        lambda name, dtype, quant="": SlowR50(dtype, quant=bool(quant),
                                              **widths))


def _video_batch(cfg, bsz=2, seed=0):
    rng = np.random.RandomState(seed)
    d, e = cfg.data, cfg.encoder
    return {
        "input_ids": rng.randint(1, e.vocab_size,
                                 (bsz, d.max_seq_length)).astype(np.int32),
        "input_mask": np.ones((bsz, d.max_seq_length), np.int32),
        "segment_ids": np.zeros((bsz, d.max_seq_length), np.int32),
        "frames": rng.randint(0, 255, (bsz, e.visual_t + 8, d.image_size,
                                       d.image_size, 3)).astype(np.uint8),
    }


@pytest.mark.parametrize("aug_path", ["subbatch", "capacity"])
def test_backbone_chunks_give_the_unchunked_bits(monkeypatch, aug_path):
    """Training mode with RandAugment: 2 chunks of 2 clips against the
    batch of 4, the same generator seed: the trunk's normalized input and
    its features bit-equal (the batch's draws are taken once and sliced;
    every op and the int8 trunk compute each clip alone), and the draws
    leave the generator where the unchunked run leaves it."""
    _toy_trunks(monkeypatch)
    runs = {}
    for chunks in (1, 2):
        cfg = tiny_test_config(task="hgqa", quant_backbone="int8",
                               freeze_backbone=True, backbone_chunks=chunks)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   augment_type="rand_aug"))
        model = build_model(cfg, "cpu", seed=0)
        frames = torch.as_tensor(_video_batch(cfg, bsz=4)["frames"])
        model.calibrate_quant(frames)
        model.train()
        model.aug_path = aug_path
        inputs = []
        model.backbone.register_forward_pre_hook(
            lambda _m, args: inputs.append(args[0].clone()))
        g = torch.Generator().manual_seed(5)
        feats = model.encode_frames(frames, g)
        runs[chunks] = (torch.cat(inputs), feats, g.get_state())
        assert len(inputs) == chunks
    for a, b in zip(runs[1], runs[2]):
        assert torch.equal(a, b)


def test_backbone_chunks_need_a_frozen_trunk_and_a_divisor(monkeypatch):
    _toy_trunks(monkeypatch)
    cfg = tiny_test_config(task="hgqa", backbone_chunks=3,
                           freeze_backbone=True)
    model = build_model(cfg, "cpu", seed=0)
    calls = []
    model.backbone.register_forward_pre_hook(lambda *a: calls.append(1))
    frames = torch.as_tensor(_video_batch(cfg, bsz=4)["frames"])
    model.encode_frames(frames)                # 4 % 3: the whole batch
    model.encode_frames(frames[:3])            # three chunks of one
    assert len(calls) == 4


# ---------------------------------------------------------------------------
# Checkpoints and imports

@pytest.fixture
def trainers(tmp_path, monkeypatch):
    """Trainers of a tiny video model with the int8 trunk and with the
    plain one (the trunk at full depth, toy widths, as the reference
    writer needs)."""
    _toy_trunks(monkeypatch, R50_TOY)

    def make(quant, seed):
        cfg = tiny_test_config(task="hgqa", output=str(tmp_path / quant),
                               freeze_backbone=True, quant_backbone=quant)
        model = build_model(cfg, "cpu", seed=seed)
        return Trainer(cfg, 1, model, trainable_mask(model, cfg))

    return make


def test_checkpoints_cross_the_flag(trainers):
    plain, quant = trainers("", 0), trainers("int8", 1)
    plain.ckpt.save("LAST", plain.state_dict())
    quant.load(plain.ckpt.path("LAST"))
    assert not quant.model.backbone.calibrated
    for k, t in plain.model.state_dict().items():
        assert torch.equal(quant.model.state_dict()[k], t)
    frames = torch.randint(0, 255, (2, 10, 32, 32, 3), dtype=torch.uint8)
    quant.model.calibrate_quant(frames)
    quant.ckpt.save("LAST", quant.state_dict())
    saved = torch.load(quant.ckpt.path("LAST"), weights_only=True)
    assert len(_scales(quant.model)) == 49         # s_stem + 16 x 3
    assert all(f"backbone.{k}" in saved["params"]
               for k in _scales(quant.model.backbone))
    fresh = trainers("int8", 2)
    fresh.load(quant.ckpt.path("LAST"))
    assert fresh.model.backbone.calibrated
    for k, t in quant.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], t)
    other = trainers("", 3)
    other.load(quant.ckpt.path("LAST"))
    for k, t in other.model.state_dict().items():
        assert torch.equal(quant.model.state_dict()[k], t)


def test_trunk_file_and_reference_pth_load_into_an_int8_model(trainers,
                                                              tmp_path):
    source = trainers("", 4).model
    tree = to_jax_variables(source.backbone.state_dict())
    trunk_file = tmp_path / "slow_r50_flax.msgpack"
    trunk_file.write_bytes(msgpack_serialize(tree))
    reference = tmp_path / "BEST.pth"
    save_torch(reference_state_dict(to_jax_variables(source.state_dict()),
                                    source.head.cfg), reference)
    for load in ("load_backbone", "load_reference"):
        quant = trainers("int8", 5)
        quant.model.calibrate_quant(torch.randint(
            0, 255, (2, 10, 32, 32, 3), dtype=torch.uint8))
        getattr(quant, load)(str(trunk_file if load == "load_backbone"
                                 else reference))
        # the files carry no scales: the loaded trunk is uncalibrated
        assert not quant.model.backbone.calibrated, load
        for k, t in source.backbone.state_dict().items():
            assert torch.equal(quant.model.backbone.state_dict()[k], t)


# ---------------------------------------------------------------------------
# The drivers

def _shrink(monkeypatch):
    parse = common.parse_reference_flags_with_extras

    def narrow(argv, dataset=None):
        cfg, extras = parse(argv, dataset)
        return cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, hidden_size=32,
                                        num_heads=4, intermediate_size=64),
            decoder=dataclasses.replace(cfg.decoder, num_heads=4,
                                        ffn_dim=64)), extras

    monkeypatch.setattr(common, "parse_reference_flags_with_extras", narrow)
    _toy_trunks(monkeypatch)


def _main(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return agqa_hgqa.main(argv, device="cpu")


def _pretrained_trunk(path):
    """A converted trunk file of random TOY weights with spread BatchNorm
    statistics (a stand-in for the pretrained trunk)."""
    trunk = init_weights(SlowR50(**TOY), 11)
    tree = perturb(to_jax_variables(trunk.state_dict()),
                   np.random.RandomState(11))
    path.write_bytes(msgpack_serialize(tree))
    return tree


def test_jax_driver_keeps_the_random_trunks_scales_the_port_calibrates(
        tmp_path, monkeypatch):
    """The JAX fault, not copied.  JAX's driver calibrates at
    ``trainer.init_params(example)``, on the random trunk
    (``shgvqa_tpu/cli/common.py:340-341``), then loads the pretrained trunk
    with ``Trainer.load_backbone``, which replaces ``params`` and
    ``batch_stats`` only (``shgvqa_tpu/train/loop.py:685-706``; run here
    on a stand-in trainer): its scales stay the random trunk's.  The port's
    driver calibrates after the load, on the same example batch (the first
    of the train split's epoch 0): its scales are the loaded trunk's, as
    JAX computes them for it (1e-6)."""
    _shrink(monkeypatch)
    trunk_file = tmp_path / "slow_r50_flax.msgpack"
    pretrained = _pretrained_trunk(trunk_file)
    argv = FLAGS + ["--tiny", "--syntheticData", "8", "--batchSize", "2",
                    "--epochs", "1", "--output", str(tmp_path / "out"),
                    "--dataDir", str(tmp_path), "--quantBackbone", "int8",
                    "--backboneWeights", str(trunk_file)]
    models = []
    made = common.build_model
    monkeypatch.setattr(common, "build_model",
                        lambda *a, **k: models.append(made(*a, **k))
                        or models[-1])
    _main(argv)
    model = models[0]
    cfg, extras = common.parse_reference_flags_with_extras(argv,
                                                           dataset="agqa")
    data = common.build_data(cfg, extras, cfg.data.train_split)
    cfg = common.resolve_num_answers(cfg, data)
    src = common.build_item_source(cfg, extras, data, common.build_tokenizer(
        cfg, extras, [x["question"] for x in data.datums]))
    example = next(common.Batcher(src, num_items=len(src), batch_size=2,
                                  shuffle=True, drop_last=True,
                                  seed=cfg.seed).epoch(0))["frames"]
    x = model.normalize_frames(torch.as_tensor(example)).numpy()
    # JAX: init (the random trunk's scales), then load_backbone
    jtrunk = JaxSlowR50(dtype=jnp.float32, quant=True, **TOY)
    random = jax.device_get(jax.jit(jtrunk.init)(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)))
    stub = SimpleNamespace(
        params={"params": {"backbone": random["params"]},
                "batch_stats": {"backbone": random["batch_stats"]},
                "quant_stats": {"backbone": random["quant_stats"]}},
        metrics=SimpleNamespace(log=lambda msg: None),
        _reset_opt=lambda: None)
    JaxTrainer.load_backbone(stub, str(trunk_file))
    jax_scales = stub.params["quant_stats"]["backbone"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), jax_scales,
        random["quant_stats"]))
    # the loaded trunk's calibration, in JAX
    zeros = jax.tree_util.tree_map(np.zeros_like, random["quant_stats"])
    _, upd = jax.jit(lambda v, x: jtrunk.apply(
        v, x, mutable=["quant_stats"]))({**pretrained, "quant_stats": zeros},
                                        jnp.asarray(x))
    loaded = from_jax_variables({"quant_stats": upd["quant_stats"]})
    stale = from_jax_variables({"quant_stats": jax_scales})
    port = _scales(model.backbone)
    assert model.backbone.calibrated and port.keys() == loaded.keys()
    for k in port:
        np.testing.assert_allclose(port[k].item(), loaded[k].item(),
                                   rtol=1e-6)
    assert max(abs(stale[k].item() / loaded[k].item() - 1)
               for k in port) > 0.1


def test_driver_test_takes_the_checkpoints_scales_or_calibrates(
        tmp_path, monkeypatch):
    """``--test --load X``: an int8 LAST's scales are used as they are; a
    plain LAST's trunk is calibrated on the first test batch.  The int8
    train run at ``--backboneChunks 2`` writes LAST with its scales."""
    _shrink(monkeypatch)
    calls = []
    calibrate = VideoShgVqaModel.calibrate_quant
    monkeypatch.setattr(VideoShgVqaModel, "calibrate_quant",
                        lambda self, f: calls.append(f.shape[0])
                        or calibrate(self, f))
    base = FLAGS + ["--tiny", "--syntheticData", "8", "--batchSize", "2",
                    "--dataDir", str(tmp_path)]
    outs = {}
    for quant in ("int8", ""):
        outs[quant] = tmp_path / (quant or "plain")
        _main(base + ["--epochs", "1", "--output", str(outs[quant])]
              + (["--quantBackbone", "int8", "--backboneChunks", "2"]
                 if quant else []))
    assert calls == [2]                  # the int8 run's example batch
    saved = torch.load(outs["int8"] / "LAST", weights_only=True)["params"]
    assert "backbone.s_stem" in saved
    # the first test batch holds one clip (AGQA's eval batch: B // 4)
    for quant, want in (("int8", [2]), ("", [2, 1])):
        _main(base + ["--quantBackbone", "int8", "--output",
                      str(tmp_path / f"test_{quant or 'plain'}"), "--test",
                      "test", "--load", str(outs[quant] / "LAST")])
        assert calls == want, quant


def test_int8_chunk_body_makes_no_host_read(tmp_path, monkeypatch):
    """The frozen int8 trunk in 2-chunk micro-batches inside a
    ``--stepsPerLoop 2`` chunk: after the first chunk (the capture's
    warm-up on a card) every host read in the chunk body raises; the
    scales are read through device tensors only."""
    _toy_trunks(monkeypatch)
    cfg = tiny_test_config(task="hgqa", output=str(tmp_path), log_freq=1,
                           steps_per_loop=2, freeze_backbone=True,
                           quant_backbone="int8", backbone_chunks=2)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, epochs=1))
    model = build_model(cfg, "cpu", seed=0)
    trainer = Trainer(cfg, 3, model, trainable_mask(model, cfg))
    batches = _frames_batches(cfg, 4)
    model.calibrate_quant(batches[0]["frames"])
    body, guarded = graph.StepChunks._body, []

    def checked(self):
        if not guarded:
            guarded.append(False)
            return body(self)
        guarded.append(True)
        with _no_host_reads():
            return body(self)

    monkeypatch.setattr(graph.StepChunks, "_body", checked)
    trainer.train(lambda epoch: iter(batches))
    assert guarded == [False, True] and trainer.step == 4

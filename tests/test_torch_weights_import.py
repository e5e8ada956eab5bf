"""The port's weight imports and plain optimizers against the JAX package's,
on the CPU at ``tiny_test_config`` size (f32; one bf16 case) with the toy
slow_r50 of ``tests/test_slow_r50_convert.py`` (the real topology at narrow
widths) swapped into both packages' ``make_backbone``, at 64-pixel frames
(2 x 2 trunk positions, the config's ``visual_hw``).

- ``convert.to_jax_variables`` against ``from_jax_variables``;
- ``utils/flax_msgpack.py`` against flax (bytes both ways, the chunked
  form refused), ``utils/convert_slow_r50.py`` against
  ``tools/convert_slow_r50.py`` (the tree, and the CLI's bytes);
- ``Trainer.load_backbone`` in both packages, and the port's strict load;
- a reference ``.pth`` through both importers (plain, ``module.``
  prefixed, extensionless): the state, the mapped lists, the outputs in f32
  and bf16, the errors;
- reference checkpoints of the AGQA ablations (tasks 'q', 'vhga',
  'hgvqa', the 'self' / 'cross_self' / 'old' cross layers, untied
  x-layers, ``--linearCls``) through both importers, and their outputs;
- the BERT import's lists and tensors;
- the ``agqa_hgqa`` drivers: ``--test --load`` of a ``.pth`` in both, the
  train path's imports and messages;
- ``--optim adam|adamax|rms|sgd`` over three steps under the clip and the
  trainable mask, and their state through a checkpoint.

The weight files are written by ``tests/test_torch_reference_writer.py``,
whose ``reference_state_dict`` the first test pins to the JAX importer.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shgvqa_tpu.cli import agqa_hgqa as jax_agqa_hgqa
from shgvqa_tpu.cli import common as jax_common
from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data import transforms as jax_transforms
from shgvqa_tpu.kernels import attention as pallas_attn
from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu.models import backbone as jax_backbone
from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.models.shgvqa import VideoShgVqaModel as JaxVideoModel
from shgvqa_tpu.train import optimizer as jax_opt
from shgvqa_tpu.train.loop import Trainer as JaxTrainer
from shgvqa_tpu.utils import ref_import as jax_ref
from shgvqa_tpu.utils import torch_import as jax_torch_import
from shgvqa_tpu_torch.cli import agqa_hgqa, common
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.data.transforms import NORM_STATS, normalize_clip
from shgvqa_tpu_torch.entry import build_model, example_batch
from shgvqa_tpu_torch.models import shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50, calibrate_frozen_bn
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from shgvqa_tpu_torch.train import optimizer
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.step import trainable_mask
from shgvqa_tpu_torch.utils import convert_slow_r50, flax_msgpack, ref_import
from shgvqa_tpu_torch.utils import torch_import
from test_torch_common import close, perturb
from test_torch_driver import FLAGS
from test_torch_reference_writer import (
    R50_TOY,
    bert_state_dict,
    pytorchvideo_state_dict,
    reference_state_dict,
    save_torch,
)

REPO = Path(__file__).resolve().parent.parent
OUTPUTS = ("logit", "hg_logit", "rel_preds", "act_preds")
IMAGE = 64


@pytest.fixture(autouse=True, scope="module")
def toy_trunks():
    """The toy slow_r50 in both packages; one intra-op thread (the suite
    runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backbone, "make_backbone",
                   lambda name, dtype, quant="": JaxSlowR50(dtype=dtype,
                                                            **R50_TOY))
        mp.setattr(shgvqa, "make_backbone",
                   lambda name, dtype: SlowR50(dtype, **R50_TOY))
        yield
    torch.set_num_threads(threads)


def _cfgs(dtype="float32", output=""):
    jcfg, pcfg = (tiny(task="hgqa", compute_dtype=dtype, output=output)
                  for tiny in (jax_tiny, tiny_test_config))
    return tuple(c.replace(data=dataclasses.replace(c.data, image_size=IMAGE))
                 for c in (jcfg, pcfg))


def _frames_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    d, e = cfg.data, cfg.encoder
    mask = np.ones((2, d.max_seq_length), np.int32)
    mask[1, d.max_seq_length // 2:] = 0
    return {
        "input_ids": rng.randint(1, e.vocab_size,
                                 (2, d.max_seq_length)).astype(np.int32),
        "input_mask": mask,
        "segment_ids": np.zeros((2, d.max_seq_length), np.int32),
        "frames": rng.randint(0, 255, (2, e.visual_t + 8, IMAGE, IMAGE, 3)
                              ).astype(np.uint8),
    }


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(w).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def setup():
    """The JAX video model, perturbed variables (host numpy), a frames
    batch, both configs and the jitted JAX forward."""
    jcfg, pcfg = _cfgs()
    jmodel = JaxVideoModel(jcfg)
    batch = _frames_batch(jcfg)
    v = jax.jit(lambda key, b: jmodel.init(key, b, deterministic=True))(
        jax.random.PRNGKey(0), batch)
    v = perturb(_host(v), np.random.RandomState(1))
    apply = jax.jit(lambda variables, b: jmodel.apply(variables, b,
                                                      deterministic=True))
    return dict(jcfg=jcfg, pcfg=pcfg, v=v, batch=batch, apply=apply)


def _other(v, seed):
    """Another perturbation of the same tree, so an import that left a leaf
    alone would show."""
    return perturb(v, np.random.RandomState(seed))


def _port_model(cfg, variables):
    model = VideoShgVqaModel(cfg)
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    return model.eval()


def _port_outputs(model, batch):
    with torch.inference_mode():
        return model({k: torch.as_tensor(x) for k, x in batch.items()})


# -- the writer's oracle and the converter's inverse ------------------------

def test_reference_writer_is_pinned_to_the_jax_importer(setup):
    v = setup["v"]
    sd = reference_state_dict(v, setup["pcfg"])
    got, report = jax_ref.reference_to_variables(sd, _other(v, 7),
                                                 setup["jcfg"])
    _assert_trees_equal(_host(got), v)
    assert report["skipped"] == []
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(report["mapped"]) == n_leaves


@pytest.mark.parametrize("start", ["jax", "port"])
def test_to_jax_variables_inverts_from_jax_variables(setup, start):
    v = setup["v"]
    model = _port_model(setup["pcfg"], v)
    if start == "jax":
        _assert_trees_equal(to_jax_variables(model.state_dict()), v)
        return
    model.load_state_dict(from_jax_variables(_other(v, 3), model))
    want = model.state_dict()
    back = from_jax_variables(to_jax_variables(want), model)
    assert back.keys() == want.keys()
    for k, t in want.items():
        assert torch.equal(back[k], t), k


# -- the msgpack format and the slow_r50 converter --------------------------

def _trunk_sd(v, seed=0, head_classes=None):
    return pytorchvideo_state_dict(v["params"]["backbone"],
                                   v["batch_stats"]["backbone"],
                                   head_classes=head_classes, seed=seed)


def _msgpack_trees(v):
    rng = np.random.RandomState(2)
    return {
        "trunk": convert_slow_r50.convert(_trunk_sd(v)),
        "mixed": {"b": {"half": rng.randn(2, 300).astype(np.float16),
                        "ints": np.arange(70000, dtype=np.int64),
                        "scalar": np.float32(1.5), "empty": np.zeros((0, 3))},
                  "a": rng.randn(17, 1, 3).astype(np.float32),
                  "x" * 40: {f"k{i}": np.full(i, i, np.int32)
                             for i in range(20)}},
    }


@pytest.mark.parametrize("name", ["trunk", "mixed"])
def test_msgpack_reads_flax_bytes(setup, name):
    tree = _msgpack_trees(setup["v"])[name]
    got = flax_msgpack.msgpack_restore(flax.serialization.msgpack_serialize(
        tree))
    _assert_trees_equal(got, tree)


@pytest.mark.parametrize("name", ["trunk", "mixed"])
def test_msgpack_writer_is_byte_equal_to_flax(setup, name):
    tree = _msgpack_trees(setup["v"])[name]
    assert (flax_msgpack.msgpack_serialize(tree)
            == flax.serialization.msgpack_serialize(tree))


def test_chunked_form_raises(monkeypatch):
    tree = {"w": np.zeros((40,), np.float32)}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    chunked = flax.serialization.msgpack_serialize(tree)
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.msgpack_restore(chunked)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunk size"):
        flax_msgpack.msgpack_serialize(tree)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_slow_r50", REPO / "tools" / "convert_slow_r50.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_convert_matches_the_jax_tool(setup):
    sd = _trunk_sd(setup["v"])
    _assert_trees_equal(convert_slow_r50.convert(sd), _jax_tool().convert(sd))


def test_cli_output_is_byte_equal_to_the_jax_tool(setup, tmp_path,
                                                  monkeypatch):
    """A pytorchvideo ``.pyth`` (``{"model_state": ...}`` with a
    ``blocks.5`` head and ``num_batches_tracked``) through both CLIs."""
    sd = _trunk_sd(setup["v"], head_classes=5)
    torch.save({"model_state": {k: torch.from_numpy(x)
                                for k, x in sd.items()}},
               tmp_path / "in.pyth")
    monkeypatch.setattr(sys, "argv", ["convert_slow_r50.py",
                                      str(tmp_path / "in.pyth"),
                                      str(tmp_path / "jax.msgpack")])
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_tool().main()
        convert_slow_r50.main([str(tmp_path / "in.pyth"),
                               str(tmp_path / "port.msgpack")])
    assert ((tmp_path / "port.msgpack").read_bytes()
            == (tmp_path / "jax.msgpack").read_bytes())


# -- the trunk through both Trainers ----------------------------------------

@contextlib.contextmanager
def _jax_trainer(cfg, variables):
    """A JAX Trainer holding ``variables``; the Pallas switches it sets are
    put back after."""
    flags = (pallas_attn._ENABLED, pallas_attn._TRAIN_ENABLED,
             pallas_ffn._ENABLED, pallas_ffn._TRAIN_ENABLED)
    try:
        trainer = JaxTrainer(cfg, 1, model=JaxVideoModel(cfg))
        trainer.params = jax.tree_util.tree_map(jnp.asarray, variables)
        yield trainer
    finally:
        (pallas_attn._ENABLED, pallas_attn._TRAIN_ENABLED,
         pallas_ffn._ENABLED, pallas_ffn._TRAIN_ENABLED) = flags


def _port_trainer(cfg, variables):
    return Trainer(cfg, 1, _port_model(cfg, variables))


def test_load_backbone_matches_the_jax_trainer(setup, tmp_path):
    v = setup["v"]
    trunk = _other(v, 11)
    path = tmp_path / "slow_r50_flax.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        convert_slow_r50.convert(_trunk_sd(trunk))))
    jcfg, pcfg = _cfgs(output=str(tmp_path))
    with _jax_trainer(jcfg, v) as jt:
        jt.load_backbone(str(path))
        want_vars = _host(jt.params)
    port = _port_trainer(pcfg, v)
    port.load_backbone(str(path))
    model = port.model
    batch = setup["batch"]
    mean, std = NORM_STATS["slow_r50"]
    clip = batch["frames"].astype(np.float32) / 255.0
    want_feats = JaxSlowR50(dtype=jnp.float32, **R50_TOY).apply(
        {"params": want_vars["params"]["backbone"],
         "batch_stats": want_vars["batch_stats"]["backbone"]},
        jax_transforms.normalize_clip(clip, mean, std))
    with torch.inference_mode():
        feats = model.backbone(normalize_clip(torch.from_numpy(clip), mean,
                                              std))
    close(feats, want_feats, 1e-4)
    close(_port_outputs(model, batch)["hg_logit"],
          setup["apply"](want_vars, batch)["hg_logit"], 1e-4)


def test_a_backbone_file_of_another_width_raises_in_the_port(setup,
                                                             tmp_path):
    """The port loads the trunk with ``load_state_dict(strict=True)``: a
    file of another width raises before anything is loaded (the JAX
    ``load_backbone`` swaps the subtree in, ROADMAP C)."""
    wide = SlowR50(torch.float32, stem_width=16, mids=R50_TOY["mids"],
                   outs=R50_TOY["outs"])
    tree = to_jax_variables(wide.state_dict())
    path = tmp_path / "wide.msgpack"
    path.write_bytes(flax_msgpack.msgpack_serialize(tree))
    _, pcfg = _cfgs(output=str(tmp_path))
    port = _port_trainer(pcfg, setup["v"])
    before = {k: t.clone() for k, t in port.model.state_dict().items()}
    with pytest.raises(ValueError, match="stem_conv.weight"):
        port.load_backbone(str(path))
    for k, t in port.model.state_dict().items():
        assert torch.equal(t, before[k]), k


# -- a reference .pth through both importers --------------------------------

def _write_pth(setup, tmp_path, spelling, seed=0):
    """The perturbed model written as a reference ``.pth``; returns the
    path ``--load`` gets."""
    prefix = "module." if spelling == "module" else ""
    sd = reference_state_dict(setup["v"], setup["pcfg"], seed=seed,
                              prefix=prefix)
    save_torch(sd, tmp_path / "BEST.pth")
    return str(tmp_path / ("BEST" if spelling == "extensionless"
                           else "BEST.pth"))


def _jax_import(setup, path, start):
    sd = jax_ref.load_reference_checkpoint(path)
    got, report = jax_ref.reference_to_variables(sd, start, setup["jcfg"])
    return _host(got), report


@pytest.mark.parametrize("spelling", ["pth", "module", "extensionless"])
def test_reference_pth_imports_bit_equal_to_jax(setup, tmp_path, spelling):
    path = _write_pth(setup, tmp_path, spelling)
    start = _other(setup["v"], 5)
    want, jax_report = _jax_import(setup, path, start)
    _, pcfg = _cfgs(output=str(tmp_path))
    port = _port_trainer(pcfg, start)
    port.load(path)
    want_state = from_jax_variables(want, port.model)
    got = port.model.state_dict()
    for k, t in want_state.items():
        assert torch.equal(got[k], t), k
    _, report = ref_import.reference_to_variables(
        ref_import.load_reference_checkpoint(path),
        to_jax_variables(got), port.model.head.cfg)
    assert report["mapped"] == jax_report["mapped"]
    assert report["skipped"] == jax_report["skipped"] == []


def test_reference_pth_outputs_match_jax_in_f32(setup, tmp_path):
    path = _write_pth(setup, tmp_path, "pth")
    want, _ = _jax_import(setup, path, _other(setup["v"], 5))
    _, pcfg = _cfgs(output=str(tmp_path))
    port = _port_trainer(pcfg, _other(setup["v"], 6))
    port.load(path)
    got = _port_outputs(port.model, setup["batch"])
    outs = setup["apply"](want, setup["batch"])
    for key in OUTPUTS:
        close(got[key], outs[key], 1e-4)


def test_reference_pth_outputs_match_jax_in_bf16(setup, tmp_path):
    """``compute_dtype=bfloat16`` in both packages from the same imported
    f32 weights: every output within 3e-2 relative Frobenius (about one
    bf16 rounding through the encoder, ROADMAP C)."""
    path = _write_pth(setup, tmp_path, "pth")
    jcfg, pcfg = _cfgs("bfloat16", output=str(tmp_path))
    want, _ = _jax_import(setup, path, _other(setup["v"], 5))
    outs = jax.jit(lambda variables, b: JaxVideoModel(jcfg).apply(
        variables, b, deterministic=True))(want, setup["batch"])
    port = _port_trainer(pcfg, _other(setup["v"], 6))
    port.load(path)
    got = _port_outputs(port.model, setup["batch"])
    for key in OUTPUTS:
        w = np.asarray(outs[key], np.float32)
        g = got[key].float().numpy()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 3e-2, (key, rel)


@pytest.mark.parametrize("fault,error", [("shape", ValueError),
                                         ("missing", KeyError)])
def test_reference_pth_errors_match_jax(setup, tmp_path, fault, error):
    sd = reference_state_dict(setup["v"], setup["pcfg"])
    key = "lxrt_encoder.model.bert.encoder.layer.0.intermediate.dense.weight"
    if fault == "shape":
        sd[key] = np.zeros((sd[key].shape[0] + 1, sd[key].shape[1]),
                           np.float32)
    else:
        del sd[key]
    save_torch(sd, tmp_path / "BEST.pth")
    path = str(tmp_path / "BEST.pth")
    with pytest.raises(error):
        _jax_import(setup, path, setup["v"])
    _, pcfg = _cfgs(output=str(tmp_path))
    with pytest.raises(error):
        _port_trainer(pcfg, setup["v"]).load(path)


# -- reference checkpoints of the AGQA ablations ----------------------------

# name -> (config overrides, encoder overrides, decoder overrides)
REF_VARIANTS = {
    "q": (dict(task="q"), {}, {}),
    "vhga": (dict(task="vhga"), {}, {}),
    "hgvqa": (dict(task="hgvqa"), {}, {}),
    "self": ({}, dict(cross_attn_type="self"), {}),
    "cross_self": ({}, dict(cross_attn_type="cross_self"), {}),
    "old": ({}, dict(cross_attn_type="old"), {}),
    "untied": ({}, dict(tie_x_layers=False), {}),
    "linear_cls": ({}, {}, dict(linear_cls=True)),
}


def _variant_cfgs(name):
    top, enc, dec = REF_VARIANTS[name]

    def build(tiny):
        cfg = tiny(**{"task": "hgqa", **top})
        return cfg.replace(encoder=dataclasses.replace(cfg.encoder, **enc),
                           decoder=dataclasses.replace(cfg.decoder, **dec))
    return build(jax_tiny), build(tiny_test_config)


@pytest.mark.parametrize("name", sorted(REF_VARIANTS))
def test_reference_variant_imports_bit_equal_to_jax(name):
    """A reference-layout state_dict of a task or cross variant (random
    arrays: a perturbed port head in the JAX layout, written by
    ``reference_state_dict`` with another variant's entries beside it)
    through both importers onto other weights: the JAX importer gives the
    written tree back, the port's the same bits and the same mapped list;
    both heads then give the same outputs (f32, 1e-4)."""
    jcfg, pcfg = _variant_cfgs(name)
    port = ShgVqaModel(pcfg)
    state = {k: torch.from_numpy(np.random.RandomState(3).randn(
        *v.shape).astype(np.float32) * 0.05) for k, v in
        init_weights(port, 0).state_dict().items()}
    port.load_state_dict(state)
    v = to_jax_variables(port.state_dict())
    sd = reference_state_dict(v, pcfg, seed=2)
    start = _other(v, 4)
    want, jax_report = jax_ref.reference_to_variables(sd, start, jcfg)
    _assert_trees_equal(_host(want), v)
    got, report = ref_import.reference_to_variables(sd, start, pcfg)
    _assert_trees_equal(got, _host(want))
    assert report == jax_report and not report["skipped"]
    assert len(report["mapped"]) == len(state)
    fresh = ShgVqaModel(pcfg)
    fresh.load_state_dict(from_jax_variables(got, fresh), strict=True)
    batch = _feature_batch(jcfg)
    outs = JaxShgVqaModel(jcfg).apply(
        jax.tree_util.tree_map(jnp.asarray, want), batch, deterministic=True)
    with torch.inference_mode():
        mine = fresh.eval()({k: torch.as_tensor(x) for k, x in batch.items()})
    assert set(mine) == set(outs)
    for key in outs:
        close(mine[key], outs[key], 1e-4)


def _feature_batch(cfg, seed=0):
    """A featurized batch (visual features, no frames; none for 'q')."""
    batch = _frames_batch(cfg, seed)
    del batch["frames"]
    if cfg.task != "q":
        e = cfg.encoder
        batch["visual_feats"] = np.random.RandomState(seed).randn(
            2, e.visual_t + 8, e.visual_hw, e.visual_hw, e.visual_feat_dim
        ).astype(np.float32)
    return batch


# -- BERT -------------------------------------------------------------------

def test_bert_import_matches_jax(setup, tmp_path):
    v = setup["v"]
    tower = _other(v, 9)["params"]["head"]["lxrt"]
    path = tmp_path / "pytorch_model.bin"
    save_torch(bert_state_dict(tower, extra_layers=1), path)
    lxrt = v["params"]["head"]["lxrt"]
    sd = jax_torch_import.load_torch_state_dict(str(path))
    want, jax_report = jax_torch_import.bert_to_lxrt_params(sd, lxrt)
    _, report = torch_import.bert_to_lxrt_params(
        torch_import.load_torch_state_dict(str(path)), lxrt)
    assert report == jax_report
    assert len(report["loaded"]) == 5 + 2 * 16       # embeddings, l_0, l_1
    assert report["skipped"] == ["pooler/dense (not in model)"]
    _, pcfg = _cfgs(output=str(tmp_path))
    port = _port_trainer(pcfg, v)
    port.load_bert_pretrained(str(path))
    got = port.model.head.lxrt.state_dict()
    for k, t in from_jax_variables({"params": _host(want)},
                                   port.model.head.lxrt).items():
        assert torch.equal(got[k], t), k


def test_bert_import_into_the_question_only_model_matches_jax(setup,
                                                             tmp_path):
    """Task 'q''s ``bert_encoder`` (its ``l_{i}`` at the top, a
    single-CLS pooler): the same tree and lists as the JAX importer, bert's
    pooler loaded; the port's ``Trainer`` (a model without a trunk) loads
    it and refuses a trunk file."""
    _, pcfg = _variant_cfgs("q")
    model = init_weights(ShgVqaModel(pcfg.replace(output=str(tmp_path))), 0)
    tree = to_jax_variables(model.bert_encoder.state_dict())["params"]
    tower = _other({"params": {"embeddings": tree["embeddings"], "encoder": {
        k: x for k, x in tree.items() if k.startswith("l_")}}}, 9)["params"]
    path = tmp_path / "pytorch_model.bin"
    save_torch(bert_state_dict(tower, extra_layers=1), path)
    sd = jax_torch_import.load_torch_state_dict(str(path))
    want, jax_report = jax_torch_import.bert_to_lxrt_params(sd, tree)
    got, report = torch_import.bert_to_lxrt_params(
        torch_import.load_torch_state_dict(str(path)), tree)
    _assert_trees_equal(got, _host(want))
    assert report == jax_report and not report["skipped"]
    assert len(report["loaded"]) == 5 + 2 * 16 + 2   # and the pooler
    trainer = Trainer(model.cfg, 1, model)
    trainer.load_bert_pretrained(str(path))
    state = model.bert_encoder.state_dict()
    for k, t in from_jax_variables({"params": got},
                                   model.bert_encoder).items():
        assert torch.equal(state[k], t), k
    with pytest.raises(ValueError, match="no backbone"):
        trainer.load_backbone(str(path))


# -- the drivers ------------------------------------------------------------

def _narrow(parse):
    def narrow(argv, dataset=None):
        cfg, extras = parse(argv, dataset)
        return cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, hidden_size=32,
                                        num_heads=4, intermediate_size=64),
            decoder=dataclasses.replace(cfg.decoder, num_heads=4,
                                        ffn_dim=64)), extras
    return narrow


@pytest.fixture
def narrow_drivers(monkeypatch):
    """Both drivers at the flagship flags with narrow widths."""
    monkeypatch.setattr(common, "parse_reference_flags_with_extras",
                        _narrow(common.parse_reference_flags_with_extras))
    monkeypatch.setattr(jax_common, "parse_reference_flags_with_extras",
                        _narrow(jax_common.parse_reference_flags_with_extras))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _driver_argv(out, data_dir, *extra):
    flags = [f for f in FLAGS if f not in ("--pallasFFNTrain", "--imageSize",
                                           "32")]
    return flags + ["--imageSize", str(IMAGE), "--tiny", "--syntheticData",
                    "8", "--batchSize", "2", "--output", str(out),
                    "--dataDir", str(data_dir), *extra]


def _driver_model_tree(tmp_path):
    """A model of the driver's shapes (``--epochs 0`` writes its LAST), its
    weights perturbed and its trunk's BatchNorm statistics calibrated on
    64-pixel frames: the tree a reference checkpoint is written from."""
    _run(lambda a: agqa_hgqa.main(a, device="cpu"),
         _driver_argv(tmp_path / "init", tmp_path, "--epochs", "0"))
    state = torch.load(tmp_path / "init" / "LAST",
                       weights_only=True)["params"]
    v = perturb(to_jax_variables(state), np.random.RandomState(4))
    cfg, _ = common.parse_reference_flags_with_extras(
        _driver_argv(tmp_path, tmp_path), dataset="agqa")
    cfg = cfg.replace(num_answers=v["params"]["head"]["logit_fc"]["fc2"][
        "Dense_0"]["bias"].shape[0])
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_jax_variables(v, model))
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (2, cfg.encoder.visual_t + 8, IMAGE, IMAGE, 3)
    ).astype(np.uint8))
    with torch.no_grad():
        calibrate_frozen_bn(model.backbone, model.normalize_frames(frames))
    return cfg, to_jax_variables(model.state_dict())


def test_test_protocol_from_a_reference_pth_matches_the_jax_driver(
        tmp_path, narrow_drivers):
    cfg, v = _driver_model_tree(tmp_path)
    save_torch(reference_state_dict(v, cfg, prefix="module."),
               tmp_path / "BEST.pth")
    preds = {}
    for name, main in (("port", lambda a: agqa_hgqa.main(a, device="cpu")),
                       ("jax", jax_agqa_hgqa.main)):
        out = tmp_path / name
        _, stdout = _run(main, _driver_argv(out, tmp_path, "--test", "test",
                                            "--load",
                                            str(tmp_path / "BEST")))
        assert "Oracle score: 1.0000" in stdout
        preds[name] = {f: json.loads((out / f).read_text())
                       for f in ("predict.json", "predict_hg.json")}
    assert preds["port"] == preds["jax"]
    # the hg answers follow the clip (a saturated model gives one answer)
    answers = {p["prediction"] for p in preds["port"]["predict_hg.json"]}
    assert len(answers) > 1


def test_train_run_loads_the_pretrained_files_then_starts_fresh(
        tmp_path, narrow_drivers):
    """No ``--fromScratch``, ``--backboneWeights`` and ``--bertWeights``:
    the trunk is the file's, the language tower bert's, and LAST (written
    at ``--epochs 0``) holds zero moments at step 0."""
    cfg, v = _driver_model_tree(tmp_path)
    trunk = tmp_path / "trunk.msgpack"
    trunk.write_bytes(flax_msgpack.msgpack_serialize(
        convert_slow_r50.convert(pytorchvideo_state_dict(
            v["params"]["backbone"], v["batch_stats"]["backbone"]))))
    bert = tmp_path / "bert.bin"
    save_torch(bert_state_dict(v["params"]["head"]["lxrt"], extra_layers=2),
               bert)
    argv = [f for f in _driver_argv(tmp_path / "run", tmp_path, "--epochs",
                                    "0", "--backboneWeights", str(trunk),
                                    "--bertWeights", str(bert))
            if f != "--fromScratch"]
    _, stdout = _run(lambda a: agqa_hgqa.main(a, device="cpu"), argv)
    logged = (tmp_path / "run" / "log.log").read_text()
    assert f"Loaded pretrained backbone from {trunk} (265 tensors" in logged
    assert (f"Loaded BERT pretrained weights from {bert} into 'lxrt': "
            "85 tensors; skipped 1") in logged
    last = torch.load(tmp_path / "run" / "LAST", weights_only=True)
    want = from_jax_variables(v)
    for k, t in last["params"].items():
        imported = k.startswith(("backbone.", "head.lxrt.embeddings.",
                                 "head.lxrt.encoder.l_"))
        assert torch.equal(t, want[k]) == imported, k
    opt = last["opt_state"]
    assert opt["step_count"] == 0 and last["step"] == 0
    assert all(not t.any() for t in opt["m"] + opt["v"])


def test_train_run_reports_absent_weight_files_as_the_jax_driver(
        tmp_path, narrow_drivers):
    argv = [f for f in _driver_argv(tmp_path, tmp_path, "--epochs", "0")
            if f != "--fromScratch"]
    _, stdout = _run(lambda a: agqa_hgqa.main(a, device="cpu"), argv)
    # shgvqa_tpu/cli/common.py:373-376, :395-398
    for line in (f"no pretrained backbone at {tmp_path}/slow_r50_flax.msgpack"
                 "; backbone stays at random init (convert via "
                 "tools/convert_slow_r50.py)",
                 f"no BERT weights at {tmp_path}/pytorch_model.bin; encoder "
                 "stays at scratch init (pass --fromScratch to silence, or "
                 "fetch per tools/fetch_bert_vocab.py notes)"):
        assert line in stdout.splitlines()


def _tiny_trainer(tmp_path, optim="bert"):
    """A Trainer of the tiny video model at 64-pixel frames and a labelled
    batch (``tests/test_torch_driver.py``'s, with the toy slow_r50)."""
    _, cfg = _cfgs(output=str(tmp_path))
    cfg = cfg.replace(log_freq=1, optim=dataclasses.replace(cfg.optim,
                                                            optim=optim))
    model = build_model(cfg, "cpu", seed=0)
    batch = example_batch(cfg, 2, 0, with_labels=True)
    batch.pop("visual_mask")
    batch["frames"] = _frames_batch(cfg)["frames"]
    batch = {k: torch.as_tensor(x) for k, x in batch.items()}
    batch.update(ques_id=["q0", "q1"], n_valid=2)
    return Trainer(cfg, 2, model, trainable_mask(model, cfg)), batch


@pytest.mark.parametrize("load", ["backbone", "bert", "reference"])
def test_an_import_resets_the_optimizer(tmp_path, load):
    trainer, batch = _tiny_trainer(tmp_path)
    trainer.train(lambda ep: [batch], None)
    opt = trainer.optimizer
    assert opt.step_count == 2 and any(t.any() for t in opt.m)
    v = to_jax_variables(trainer.model.state_dict())
    path = tmp_path / "weights"
    if load == "backbone":
        path.write_bytes(flax_msgpack.msgpack_serialize(
            {"params": v["params"]["backbone"],
             "batch_stats": v["batch_stats"]["backbone"]}))
        trainer.load_backbone(str(path))
    elif load == "bert":
        save_torch(bert_state_dict(v["params"]["head"]["lxrt"]), path)
        trainer.load_bert_pretrained(str(path))
    else:
        save_torch(reference_state_dict(v, trainer.model.head.cfg),
                   tmp_path / "BEST.pth")
        trainer.load(str(tmp_path / "BEST"))
    assert opt.step_count == 0
    assert all(not t.any() for t in opt.m + opt.v)


# -- --optim rms|adam|adamax|sgd --------------------------------------------

SHAPES = {"a": (3, 4), "b": (5,), "frozen": (2, 2)}
MASK = {"a": True, "b": True, "frozen": False}


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for name, value in values.items():
            setattr(self, name, torch.nn.Parameter(torch.tensor(value)))


@pytest.mark.parametrize("name", optimizer.PLAIN_OPTIMIZERS)
def test_plain_optimizer_matches_jax_over_three_steps(name):
    """Three steps with the clip idle, active and idle; the frozen leaf
    untouched (tests/test_torch_optimizer.py's tolerance)."""
    rng = np.random.RandomState(0)
    values = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for scale in (0.3, 10.0, 0.8)]
    kw = dict(lr=1e-2, t_total=10, grad_clip=5.0, name=name)
    tx = jax_opt.make_optimizer(trainable_mask=MASK, **kw)
    jparams = {k: jnp.asarray(x) for k, x in values.items()}
    state = tx.init(jparams)
    model = _Params(values)
    opt = optimizer.make_optimizer(model, trainable_mask=MASK, **kw)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(x) for k, x in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for pname, p in model.named_parameters():
            p.grad = torch.tensor(g[pname])
        norm = opt.step()
        close(norm, np.sqrt(sum((g[k] ** 2).sum() for k in ("a", "b"))),
              1e-5)
        for pname, p in model.named_parameters():
            close(p, jparams[pname], 1e-6)
    np.testing.assert_array_equal(model.frozen.detach().numpy(),
                                  values["frozen"])
    assert opt.step_count == 3


@pytest.mark.parametrize("name", optimizer.PLAIN_OPTIMIZERS)
def test_plain_optimizer_state_resumes_from_a_checkpoint(tmp_path, name):
    """Four steps, LAST, a new trainer loads it, one more step in each: the
    same parameters and state as the trainer that went on."""
    trainer, batch = _tiny_trainer(tmp_path / "a", optim=name)
    assert trainer.optimizer.name == name
    trainer.train(lambda ep: [batch, batch], None)
    resumed, _ = _tiny_trainer(tmp_path / "b", optim=name)
    resumed.load(str(tmp_path / "a" / "LAST"))
    step_batch = {k: x for k, x in batch.items()
                  if k not in ("ques_id", "n_valid")}
    for t in (trainer, resumed):
        t._train_step(step_batch, torch.Generator().manual_seed(5))
    a, b = trainer.state_dict(), resumed.state_dict()
    for k, t in a["params"].items():
        assert torch.equal(t, b["params"][k]), k
    for key in ("m", "v"):
        assert len(a["opt_state"][key]) == len(b["opt_state"][key])
        assert all(torch.equal(x, y) for x, y in
                   zip(a["opt_state"][key], b["opt_state"][key]))
    # two epochs of two steps, then one
    assert a["opt_state"]["step_count"] == b["opt_state"]["step_count"] == 5

"""The port's STAR path against the JAX package: ``data/star.py``'s items,
array for array, on ``make_star_data`` and on a small ``from_files``
fixture (the real schema: choice lists, relation pairs and action tags
through the triplet and action vocabularies); ``STAREvaluator``'s scores,
breakdown and dumps; a forward with ``use_hg_mask`` and a mask that is not
a prefix (f32, 1e-4), also through ``--pallasAttention``, the head-sliced
switch and the training kernels' paths; three global-mode train steps under ``use_hg_mask``
against the JAX ``make_train_step`` (the rule of
``test_torch_train_step.py``); ``cli.star.main(..., device="cpu")`` for two
epochs of two steps at ``--stepsPerLoop 2`` on synthetic STAR, then
``--test`` from LAST (oracle 1.0, ``by_qtype``, both predict files); and
what the STAR driver still refuses (its capsule encoder runs:
tests/test_torch_capsules.py)."""

import contextlib
import dataclasses
import io
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data import star as jax_star
from shgvqa_tpu.data import synthetic as jax_synthetic
from shgvqa_tpu.data.agqa import SyntheticFrameLoader as JaxFrames
from shgvqa_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from shgvqa_tpu.evalsuite.star import STAREvaluator as JaxEvaluator
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from shgvqa_tpu_torch.cli import common, star
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.data import star as port_star
from shgvqa_tpu_torch.data import synthetic
from shgvqa_tpu_torch.data.agqa import SyntheticFrameLoader
from shgvqa_tpu_torch.data.tokenization import (
    BertTokenizer,
    build_vocab_from_corpus,
)
from shgvqa_tpu_torch.evalsuite.star import STAREvaluator
from shgvqa_tpu_torch.models import layers, shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.train import step
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from test_torch_common import TOY, close, load_port, perturb, t
from test_torch_model import _batch

STEPS, LR, T_TOTAL = 3, 1e-3, 10
# the forward's and the train step's tolerances (test_torch_model.py,
# test_torch_train_step.py)
TOL, LOSS_TOL, UPDATE_TOL, NOISE = 1e-4, 1e-4, 1e-4, 1e-5
# README.md's STAR line with --noCaps (the no-caps STAR path; README.md as
# printed, the capsule encoder, runs in tests/test_torch_capsules.py)
FLAGS = ["--taskHGQA", "--useHGMask", "--qType", "Interaction",
         "--qaArrangeType", "add_sep_all", "--noCaps"]
# the test's sizes under those flags
SMALL = ["--numSituations", "4", "--numRel", "4", "--numAct", "2",
         "--imageSize", "32", "--computeDtype", "float32", "--lr", "1e-3",
         "--logFreq", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _star_cfgs(**over):
    """The JAX and port tiny configs on the STAR dataset, 4 situations of 4
    relations (16 relation queries: the square solver) and 2 actions."""
    out = []
    for tiny in (jax_tiny, tiny_test_config):
        cfg = tiny(task="hgqa", **over)
        out.append(cfg.replace(data=dataclasses.replace(
            cfg.data, dataset="star", num_rel=4, clip_len=4)))
    return out


# -- data --------------------------------------------------------------------

def _tokenizers(tmp_path, texts):
    vocab = tmp_path / "vocab.txt"
    build_vocab_from_corpus(texts, vocab)
    return JaxTokenizer(str(vocab)), BertTokenizer(str(vocab))


def _assert_items_equal(jsrc, psrc):
    assert len(jsrc) == len(psrc) > 0
    for i in range(len(jsrc)):
        want, got = jsrc[i], psrc[i]
        assert set(want) == set(got)
        for key in want:
            if isinstance(want[key], str):
                assert got[key] == want[key]
            else:
                np.testing.assert_array_equal(got[key], want[key])
                assert np.asarray(got[key]).dtype == np.asarray(
                    want[key]).dtype, key


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
def test_synthetic_items_match_jax(tmp_path, test_mode):
    jcfg, pcfg = _star_cfgs()
    jdata = jax_star.STARData.synthetic(jcfg, "train", n=24, seed=3)
    pdata = port_star.STARData.synthetic(pcfg, "train", n=24, seed=3)
    assert pdata.datums == jdata.datums
    jtok, ptok = _tokenizers(tmp_path, [d["question"] for d in pdata.datums]
                             + ["a the", "0 1 2 3"])
    jframes, pframes = JaxFrames(4, 16), SyntheticFrameLoader(4, 16)
    jsrc = jax_star.STARItemSource(
        jdata, jtok, jcfg, lambda vid, fids=None: jframes(vid), test_mode)
    psrc = port_star.STARItemSource(
        pdata, ptok, pcfg, lambda vid, fids=None: pframes(vid), test_mode)
    _assert_items_equal(jsrc, psrc)
    if not test_mode:
        assert psrc[0]["hg_mask"].shape == (4, 6)
        assert 0 < psrc[0]["hg_mask"].mean() < 1


def test_make_star_data_matches_jax():
    assert (synthetic.make_star_data(n=12, seed=5, max_rel=4)
            == jax_synthetic.make_star_data(n=12, seed=5, max_rel=4))


def _write_star_files(root):
    """STAR_{split}_updated.json with the real schema, the triplet
    vocabulary keyed by (subject, relation, object) tuples (a pickle under
    its .json name, as load_json_or_pickle reads it) and the action tags."""
    rng = np.random.RandomState(0)
    objs, rels, acts = ["o1", "o2", "o3"], ["r1", "r2"], ["c1", "c2", "c3"]
    triplets = {("p", r, o): 1 + i for i, (r, o) in enumerate(
        (r, o) for r in rels for o in objs)}
    datums = []
    for q in range(10):
        qtype = ("Interaction", "Sequence", "Prediction", "Feasibility")[q % 4]
        situations = {}
        for f in range(int(rng.randint(3, 9))):
            n = int(rng.randint(0, 3))
            situations[f"{f * 7:06d}"] = {
                "rel_pairs": [["p", objs[int(rng.randint(3))]]
                              for _ in range(n)],
                "rel_labels": [rels[int(rng.randint(2))] for _ in range(n)],
                "actions": [acts[int(rng.randint(3))]
                            for _ in range(int(rng.randint(0, 3)))],
            }
        datums.append({
            "question_id": f"{qtype}_T{q % 3}_{q:04d}",
            "video_id": f"V{q % 4}", "question": f"what did the person do {q}?",
            "choices": [{"choice_id": c, "choice": f"took the o{c}"}
                        for c in range(4)],
            "answer_choice": q % 4, "situations": situations})
    (root / "STAR_train_updated.json").write_text(json.dumps(datums))
    (root / "relationship_triplets.json").write_bytes(pickle.dumps(
        {"rel_triplets_rp2idx": triplets}))
    (root / "action_dictionaries.json").write_text(json.dumps(
        {"actions_rp2idx": {a: 1 + i for i, a in enumerate(acts)}}))
    (root / "nopred_nofeas_vid_ids_train.json").write_text(json.dumps(["V1"]))


@pytest.mark.parametrize("qtype", ["Interaction", "Prediction"])
def test_from_files_items_match_jax(tmp_path, qtype):
    _write_star_files(tmp_path)
    cfgs = []
    for cfg in _star_cfgs():
        cfgs.append(cfg.replace(data=dataclasses.replace(
            cfg.data, data_dir=str(tmp_path), qtype=qtype,
            qa_arrange_type="no_sep_all")))
    jdata = jax_star.STARData.from_files(cfgs[0], "train")
    pdata = port_star.STARData.from_files(cfgs[1], "train")
    assert pdata.datums == jdata.datums and len(pdata) > 0
    assert pdata.rel_vocab == jdata.rel_vocab
    jtok, ptok = _tokenizers(tmp_path, [d["question"] for d in pdata.datums]
                             + ["took the o0 o1 o2 o3 0 1 2 3"])
    fids = []
    jsrc = jax_star.STARItemSource(jdata, jtok, cfgs[0],
                                   lambda vid, f: np.zeros((1,)))
    psrc = port_star.STARItemSource(
        pdata, ptok, cfgs[1],
        lambda vid, f: fids.append((vid, f)) or np.zeros((1,)))
    _assert_items_equal(jsrc, psrc)
    vid, frames = fids[0]
    assert frames == port_star.trim_keyframes(pdata.datums[0], 4)
    assert frames == sorted(frames)


def test_evaluator_matches_jax(tmp_path):
    datums, _ = synthetic.make_star_data(n=40, seed=2)
    id2datum = {d["question_id"]: d for d in datums}
    rng = np.random.RandomState(1)
    preds = {q: int(rng.randint(4)) for q in list(id2datum)[:30]}
    ours, theirs = STAREvaluator(id2datum), JaxEvaluator(id2datum)
    assert ours.evaluate(preds) == theirs.evaluate(preds)
    assert ours.evaluate_by_qtype(preds) == theirs.evaluate_by_qtype(preds)
    assert ours.oracle_score(id2datum) == theirs.oracle_score(id2datum) == 1.0
    assert ours.evaluate({}) == 0.0
    ours.dump_result(preds, tmp_path / "a.json")
    theirs.dump_result(preds, tmp_path / "b.json")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


def test_helpers_match_jax():
    fids = [f"{i:06d}" for i in range(37)]
    for n in (0, 4, 16, 40):
        assert port_star.sample_frames(fids, n) == jax_star.sample_frames(
            fids, n)
    datums, _ = synthetic.make_star_data(n=24, seed=4)
    assert port_star.get_merged_data(datums) == jax_star.get_merged_data(
        datums)
    assert set(port_star.QA_ARRANGERS) == set(jax_star.QA_ARRANGERS) == {
        "add_sep_all", "no_sep_all", "add_sep", "no_sep"}
    for name, fn in port_star.QA_ARRANGERS.items():
        assert fn("q?", {"0": "a", "1": "b"}) == jax_star.QA_ARRANGERS[name](
            "q?", {"0": "a", "1": "b"})


# -- the model ---------------------------------------------------------------

def _labelled_star_batch(cfg, seed=0):
    """A tiny batch with labels and an hg_mask that is not a prefix: the
    slots with a label, which the lengths do not keep in front."""
    batch = _batch(cfg, seed=seed)
    rng = np.random.RandomState(seed + 1)
    d, b = cfg.data, 2
    s = d.num_situations
    out = {}
    for kind, slots, classes in (("rel", d.num_rel, cfg.num_rel_classes),
                                 ("act", d.num_act, cfg.num_act_classes)):
        lengths = rng.randint(0, slots + 1, (b, s)).astype(np.int32)
        labels = rng.randint(1, classes + 1, (b, s, slots)).astype(np.int32)
        labels[np.arange(slots)[None, None] >= lengths[..., None]] = 0
        out[kind] = labels
        batch[f"{kind}_labels"], batch[f"{kind}_lengths"] = labels, lengths
    mask = np.concatenate([out["act"] > 0, out["rel"] > 0], -1)
    mask[0, 0] = mask[0, 0][::-1]                   # holes inside a situation
    batch["hg_mask"] = mask.astype(np.int32)
    batch["target"] = np.eye(cfg.num_answers, dtype=np.float32)[[1, 3]]
    return batch


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model under use_hg_mask and the global matcher: its init,
    an eval forward and three train steps with dropout off (flax's Dropout
    patched to the identity while tracing)."""
    cfg, _ = _star_cfgs(use_hg_mask=True, loss_hg_per_frame=False)
    model = JaxShgVqaModel(cfg)
    batch = _labelled_star_batch(cfg)
    assert 0 < batch["hg_mask"].mean() < 1
    init = jax.jit(lambda r, b: model.init(r, b, deterministic=True))
    variables = jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(init(jax.random.PRNGKey(0), batch)),
        np.random.RandomState(1)))
    forward = jax.device_get(jax.jit(
        lambda v, b: model.apply(v, b, deterministic=True))(variables, batch))
    mask = jax_step.connected_param_mask(variables, cfg)
    tx = jax_make_optimizer(LR, T_TOTAL, trainable_mask=mask)
    mp = pytest.MonkeyPatch()
    mp.setattr(nn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        train_step = jax.jit(jax_step.make_train_step(cfg, model, tx))
        params, opt_state, metrics = variables, tx.init(variables), []
        for i in range(STEPS):
            params, opt_state, m = train_step(params, opt_state, batch,
                                              jax.random.PRNGKey(i))
            metrics.append(jax.device_get(m))
    finally:
        mp.undo()
    return dict(batch=batch, variables=variables, forward=forward,
                params=jax.device_get(params), metrics=metrics)


def _port(jax_run):
    _, cfg = _star_cfgs(use_hg_mask=True, loss_hg_per_frame=False)
    model = load_port(ShgVqaModel(cfg), jax_run["variables"])
    batch = {k: t(v) for k, v in jax_run["batch"].items()}
    return cfg, model, batch


def test_forward_with_the_hg_mask_matches_jax(jax_run):
    _, model, batch = _port(jax_run)
    with torch.inference_mode():
        got = model.eval()(batch)
        unmasked = model({k: v for k, v in batch.items() if k != "hg_mask"})
    for key in ("logit", "hg_logit", "rel_preds", "act_preds"):
        close(got[key], jax_run["forward"][key], TOL)
    # the mask reaches the hg cross attention
    assert not torch.allclose(got["hg_logit"], unmasked["hg_logit"],
                              atol=1e-3)


def test_global_matcher_train_steps_match_jax(jax_run):
    cfg, model, batch = _port(jax_run)
    model.train()
    layers.set_dropout_rate(model, 0.0)
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step = step.make_train_step(cfg, model, opt)
    g = torch.Generator().manual_seed(0)
    for want in jax_run["metrics"]:
        got = train_step(batch, g)
        for key in want:
            close(got[key], want[key], LOSS_TOL)
    want_params = from_jax_variables(jax_run["params"])
    moments = dict(zip(map(id, opt.params), opt.m))
    rms_m = torch.cat([m.flatten() for m in opt.m]).square().mean().sqrt()
    max_move = sum(opt.lr_at(i) for i in range(STEPS)) * 0.1 / 0.999 ** 0.5 \
        * STEPS ** 0.5
    for name, p in model.named_parameters():
        d_port = p.detach() - before[name]
        d_jax = want_params[name] - before[name]
        if id(p) not in moments:
            assert not d_port.any() and not d_jax.any(), name
            continue
        noise = moments[id(p)].abs() < NOISE * rms_m
        err = (d_port - d_jax)[~noise].norm().item()
        assert err <= UPDATE_TOL * d_jax[~noise].norm().item() + 1e-12, \
            (name, err)
        assert ((d_port - d_jax)[noise].abs() <= 2 * max_move).all(), name



def test_hg_mask_through_every_attention_path(jax_run):
    """The hg mask (not a prefix) as the key mask of the kernels' paths, on
    the CPU their plain versions: ``--pallasAttention`` and the head-sliced
    switch against the plain eval forward, and the training kernels
    against the plain attention (the loss and every gradient, dropout 0)."""
    cfg, model, batch = _port(jax_run)
    model.eval()
    with torch.inference_mode():
        want = model(batch)["hg_logit"]
        for switch in (layers.set_attention_kernel_eval,
                       layers.set_headsliced_kernel):
            switch(model, True)
            got = model(batch)["hg_logit"]
            switch(model, False)
            close(got, want.numpy(), TOL)
    model.train()
    layers.set_dropout_rate(model, 0.0)
    runs = {}
    for on in (True, False):
        layers.set_attention_kernel(model, on)
        model.zero_grad()
        loss, _ = step.compute_losses(cfg, model(batch), batch)
        loss.backward()
        runs[on] = (loss.detach(), {n: p.grad.clone() for n, p in
                                    model.named_parameters()
                                    if p.grad is not None})
    close(runs[True][0], runs[False][0].numpy(), LOSS_TOL)
    assert runs[True][1].keys() == runs[False][1].keys()
    for name, grad in runs[False][1].items():
        close(runs[True][1][name], grad.numpy(), TOL)

# -- the driver ----------------------------------------------------------------

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
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = star.main(argv, device="cpu")
    return result, out.getvalue()


def test_star_driver_trains_and_tests_on_the_cpu(tmp_path, monkeypatch):
    """README.md's STAR line + --noCaps at --stepsPerLoop 2: 16 synthetic
    questions (4 Interaction, 2 steps of 2 an epoch: one chunk), 8 valid,
    two epochs; then --test from LAST."""
    _shrink(monkeypatch)
    out = tmp_path / "train"
    base = FLAGS + SMALL + ["--batchSize", "2", "--dataDir", str(tmp_path),
                            "--syntheticData", "16", "--syntheticValid", "8"]
    result, stdout = _main(base + ["--epochs", "2", "--stepsPerLoop", "2",
                                   "--output", str(out)])
    assert "star driver: task=hgqa device=cpu" in stdout
    assert result["steps"] == 4 and len(result["history"]) == 2
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    assert all(np.isfinite(r["total_loss"]) for r in records)
    logged = (out / "log.log").read_text()
    assert "valid rel class acc" in logged and "Epoch 1: valid" in logged
    assert {"CURRENT", "LAST"} <= {p.name for p in out.iterdir()}

    test_out = tmp_path / "test"
    result, stdout = _main(base + ["--test", "test", "--load",
                                   str(out / "LAST"), "--output",
                                   str(test_out)])
    assert "Oracle score: 1.0000" in stdout
    assert set(result) == {"task", "acc", "hg_acc", "by_qtype"}
    assert set(result["by_qtype"]) == {"Interaction", "Sequence",
                                       "Prediction", "Feasibility"}
    for name in ("predict.json", "predict_hg.json"):
        preds = json.loads((test_out / name).read_text())
        assert len(preds) == 2 and set(preds[0]) == {"questionId",
                                                     "prediction"}


@pytest.mark.parametrize("extra,match", [
    (["--scanLayers"], None),
    (["--loadLXMERTQA", "{snap}"], None),
], ids=["scanLayers", "loadLXMERTQA"])
def test_star_driver_refuses_what_is_not_ported(tmp_path, monkeypatch, extra,
                                                match):
    """What the STAR driver used to refuse on its capsule encoder (no
    ``--noCaps``) runs now (ROADMAP queue A positions 14 and 15):
    ``--scanLayers`` trains an epoch (finite losses), and
    ``--loadLXMERTQA`` loads an encoder snapshot and a QA head whose
    answers '1', '3' and 'x' initialize labels 1 and 3 and zero 0 and 2
    of the 4-way head (STAR's ``ans2label``).  Nothing is refused
    (``match`` None)."""
    _shrink(monkeypatch)
    argv = ([a for a in FLAGS if a not in ("--noCaps", "--taskHGQA")]
            + SMALL + ["--taskHGQA", "--batchSize", "2", "--syntheticData",
                       "8", "--dataDir", str(tmp_path)])
    if "{snap}" in extra:
        # a snapshot of this model's encoder and a QA head over 3 answers
        _main(argv + ["--epochs", "0", "--output", str(tmp_path / "init")])
        params = torch.load(tmp_path / "init" / "LAST",
                            weights_only=True)["params"]
        lxrt = {k[len("head.lxrt."):]: v for k, v in params.items()
                if k.startswith("head.lxrt.")}
        torch.save({"lxrt": lxrt}, tmp_path / "snap_LXRT")
        d = params["head.logit_fc.fc2.weight"].shape[1]
        np.savez(tmp_path / "snap_qa_head.npz",
                 weight=np.ones((3, d), np.float32), bias=np.ones(3),
                 answers=np.array(["1", "3", "x"]))
        extra = [a.format(snap=tmp_path / "snap_LXRT") for a in extra]
    assert match is None
    result, stdout = _main(argv + extra + ["--epochs", "1", "--output",
                                           str(tmp_path / "out")])
    assert result["steps"] >= 1
    records = [json.loads(x) for x in
               (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["total_loss"]) for r in records)
    if "--loadLXMERTQA" in extra:
        assert result["load_lxmert_qa"] == (2, 2)


@pytest.mark.parametrize("extra", [
    ["--qaArrangeType", "add_sep", "--taskHGVQA"],
    ["--qaArrangeType", "no_sep"],
    ["--outputAttn"],
], ids=["add_sep", "no_sep", "outputAttn"])
def test_star_driver_runs_what_item_15_ported(tmp_path, monkeypatch, extra):
    """Per-choice QA ('hgvqa' with ``add_sep``, 'hgqa' with ``no_sep``) and
    ``--outputAttn`` train an epoch through the STAR driver: finite
    losses, (B, 4) answers into the STAR evaluator, and with
    ``--outputAttn`` the valid split's dump files."""
    _shrink(monkeypatch)
    argv = [a for a in FLAGS if a not in ("--taskHGQA", "--qaArrangeType",
                                          "add_sep_all")] + SMALL + extra
    if "--taskHGVQA" not in extra:
        argv.append("--taskHGQA")
    out = tmp_path / "out"
    result, _ = _main(argv + ["--batchSize", "2", "--epochs", "1",
                              "--syntheticData", "16", "--syntheticValid",
                              "4", "--output", str(out), "--dataDir",
                              str(tmp_path)])
    assert result["steps"] == 2 and len(result["history"]) == 1
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["total_loss"]) for r in records)
    dumped = (out / "val_attentions_cross_2.json").exists()
    assert dumped == ("--outputAttn" in extra)
    if dumped:
        entries = json.loads((out / "val_attentions_cross_2.json")
                             .read_text())
        assert entries and all(e["attention"] and "rel_pred" in e
                               for e in entries)

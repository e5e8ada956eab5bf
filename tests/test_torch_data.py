"""The port's own copies of the JAX package's framework-free driver pieces,
held to the originals: the reference-flag parser, the synthetic AGQA data,
the tokenizer, the featurize helpers, the AGQA item source and ``Batcher``
(bit-equal batches over two epochs), the AGQA evaluator, the IO helpers and
the metric records; plus the port's ``prefetch``, checkpoints and the
driver-level refusals."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from shgvqa_tpu.configs import cli as jax_cli
from shgvqa_tpu.configs import config as jax_config
from shgvqa_tpu.data import agqa as jax_agqa
from shgvqa_tpu.data import featurize as jax_featurize
from shgvqa_tpu.data import pipeline as jax_pipeline
from shgvqa_tpu.data import synthetic as jax_synthetic
from shgvqa_tpu.data import tokenization as jax_tokenization
from shgvqa_tpu.evalsuite import agqa as jax_evalsuite
from shgvqa_tpu.train import metrics as jax_metrics
from shgvqa_tpu.utils import io as jax_io
from shgvqa_tpu_torch.configs import cli
from shgvqa_tpu_torch.configs import config as port_config
from shgvqa_tpu_torch.data import agqa, featurize, pipeline, synthetic
from shgvqa_tpu_torch.data import tokenization
from shgvqa_tpu_torch.evalsuite import agqa as evalsuite
from shgvqa_tpu_torch.train import metrics
from shgvqa_tpu_torch.train.checkpoint import CheckpointManager
from shgvqa_tpu_torch.utils import io

FLAGSHIP = ["--taskHGQA", "--noCaps", "--crossAttnType", "cross",
            "--llayers", "5", "--xlayers", "2", "--rlayers", "5",
            "--dlayers", "5", "--backbone", "slow_r50"]
ARGVS = {
    "flagship": FLAGSHIP,
    "tiny": FLAGSHIP + ["--tiny", "--syntheticData", "24", "--batchSize", "2",
                        "--epochs", "2", "--output", "out", "--dataDir", "d"],
    "pallasFFNTrain": FLAGSHIP + ["--pallasFFNTrain", "--LossHGPerFrame",
                                  "--freezeBackbone", "--fromScratch"],
    "test": ["--test", "test", "--load", "snap/LAST", "--novelComp",
             "--computeDtype", "float32", "--noPallasFFN"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_gives_the_jax_config_and_extras(name):
    argv = ARGVS[name]
    ours, ours_extras = cli.parse_reference_flags_with_extras(argv, "agqa")
    theirs, theirs_extras = jax_cli.parse_reference_flags_with_extras(
        argv, "agqa")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours_extras == theirs_extras
    assert (dataclasses.asdict(cli.parse_reference_flags(argv))
            == dataclasses.asdict(jax_cli.parse_reference_flags(argv)))


def test_parser_accepts_every_jax_flag():
    ours = {a.dest: (a.option_strings, a.default)
            for a in cli.build_parser()._actions}
    theirs = {a.dest: (a.option_strings, a.default)
              for a in jax_cli.build_parser()._actions}
    assert ours == theirs


def test_unported_flags_still_raise():
    """The global matcher (no --LossHGPerFrame) and the options of queue A
    item 15 (per-choice QA and --outputAttn too) train now; an option only
    training reads and the port does not run still raises in training, the
    scanned stacks raise, and the int8 trunk and --backboneChunks pass."""
    cfg = cli.parse_reference_flags(FLAGSHIP + ["--pallasFFNTrain"])
    assert not cfg.loss_hg_per_frame
    port_config.check_ported(cfg, video=True, train=True)
    for flags in (["--freezeWeights"], ["--mceLoss"], ["--untieXLayers"],
                  ["--GTHG"], ["--linearCls"], ["--afterCrossAttnFeats"],
                  ["--crossAttnType", "cross_self"]):
        port_config.check_ported(cli.parse_reference_flags(
            FLAGSHIP + flags), video=True, train=True)
    cfg = cli.parse_reference_flags(FLAGSHIP + ["--remat"])
    port_config.check_ported(cfg, video=True)       # inference: fine
    with pytest.raises(NotImplementedError, match="item 19"):
        port_config.check_ported(cfg, video=True, train=True)
    for flags in (["--outputAttn"], ["--qaArrangeType", "add_sep"],
                  ["--quantBackbone", "int8", "--backboneChunks", "2"]):
        port_config.check_ported(cli.parse_reference_flags(
            FLAGSHIP + flags), video=True, train=True)
    for flags, item in ((["--scanLayers"], "19"),):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            port_config.check_ported(cli.parse_reference_flags(
                FLAGSHIP + flags), video=True)


def _jax_cfg():
    return jax_config.tiny_test_config().replace(data=dataclasses.replace(
        jax_config.tiny_test_config().data, clip_len=10, image_size=16))


def _port_cfg():
    return port_config.tiny_test_config().replace(data=dataclasses.replace(
        port_config.tiny_test_config().data, clip_len=10, image_size=16))


def test_synthetic_data_matches_jax():
    ours = synthetic.make_agqa_data(n=40, seed=3)
    theirs = jax_synthetic.make_agqa_data(n=40, seed=3)
    assert ours == theirs
    assert (synthetic.rule_answer(2, 3) == jax_synthetic.rule_answer(2, 3))
    np.testing.assert_array_equal(synthetic.make_frames(4, 16, seed=7),
                                  jax_synthetic.make_frames(4, 16, seed=7))


def test_tokenizer_and_question_encoding_match_jax(tmp_path):
    datums = synthetic.make_agqa_data(n=30, seed=1)[0]
    corpus = [d["question"] for d in datums] + ["Héllo, WORLD! 你好 unknown##"]
    ours = tokenization.build_vocab_from_corpus(corpus, tmp_path / "a.txt")
    theirs = jax_tokenization.build_vocab_from_corpus(corpus,
                                                      tmp_path / "b.txt")
    assert ours == theirs
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    tok = tokenization.BertTokenizer(tmp_path / "a.txt")
    jtok = jax_tokenization.BertTokenizer(tmp_path / "a.txt")
    for text in corpus + ["Was the person holding the unseenword?"]:
        assert tok.tokenize(text) == jtok.tokenize(text)
    enc = featurize.encode_questions(corpus, tok, 12)
    jenc = jax_featurize.encode_questions(corpus, jtok, 12)
    for k in jenc:
        np.testing.assert_array_equal(enc[k], jenc[k])


def test_hg_label_featurization_matches_jax():
    rng = np.random.RandomState(0)
    labels = [list(rng.randint(1, 9, rng.randint(0, 6))) for _ in range(11)]
    for s, k in ((4, 3), (16, 8), (3, 2)):
        ours = featurize.pack_hg_labels(labels, s, k)
        theirs = jax_featurize.pack_hg_labels(labels, s, k)
        for key in theirs:
            np.testing.assert_array_equal(ours[key], theirs[key])
        act = featurize.pack_hg_labels(labels, s, 2)["labels"]
        np.testing.assert_array_equal(
            featurize.hg_token_mask(act, ours["labels"]),
            jax_featurize.hg_token_mask(act, ours["labels"]))
    np.testing.assert_array_equal(featurize.uniform_subsample_indices(7, 16),
                                  jax_featurize.uniform_subsample_indices(7, 16))


def _sources(tmp_path, test_mode):
    """The same AGQA split through the port's and the JAX package's data,
    tokenizer and item source."""
    cfg, jcfg = _port_cfg(), _jax_cfg()
    data = agqa.AGQAData.synthetic(cfg, "valid", n=23, seed=5)
    jdata = jax_agqa.AGQAData.synthetic(jcfg, "valid", n=23, seed=5)
    vocab = tmp_path / "vocab.txt"
    tokenization.build_vocab_from_corpus(
        [x["question"] for x in data.datums], vocab)
    cfg = cfg.replace(num_answers=data.num_answers)
    jcfg = jcfg.replace(num_answers=jdata.num_answers)
    src = agqa.AGQAItemSource(
        data, tokenization.BertTokenizer(vocab), cfg,
        agqa.SyntheticFrameLoader(cfg.data.clip_len, cfg.data.image_size),
        test_mode)
    jsrc = jax_agqa.AGQAItemSource(
        jdata, jax_tokenization.BertTokenizer(vocab), jcfg,
        jax_agqa.SyntheticFrameLoader(jcfg.data.clip_len,
                                      jcfg.data.image_size), test_mode)
    return src, jsrc


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
def test_batches_bit_equal_to_jax_over_two_epochs(tmp_path, test_mode):
    src, jsrc = _sources(tmp_path, test_mode)
    kw = dict(num_items=len(src), batch_size=5, shuffle=not test_mode,
              seed=9595)
    ours, theirs = pipeline.Batcher(src, **kw), jax_pipeline.Batcher(jsrc, **kw)
    assert len(ours) == len(theirs) == 5
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want)
        for b, jb in zip(got, want):
            assert sorted(b) == sorted(jb)
            assert b["ques_id"] == jb["ques_id"]
            assert b["n_valid"] == jb["n_valid"]
            for k, v in jb.items():
                if isinstance(v, np.ndarray):
                    assert b[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(b[k], v, err_msg=k)
    assert [b["n_valid"] for b in ours.epoch(0)] == [5, 5, 5, 5, 3]
    dropped = pipeline.Batcher(src, len(src), 5, drop_last=True)
    assert len(dropped) == 4 and len(list(dropped.epoch(0))) == 4


def test_evaluator_matches_jax(tmp_path):
    datums, vocab, *_ = synthetic.make_agqa_data(n=60, seed=2)
    id2datum = {d["question_id"]: d for d in datums}
    ev = evalsuite.AGQAEvaluator(id2datum, vocab)
    jev = jax_evalsuite.AGQAEvaluator(id2datum, vocab)
    rng = np.random.RandomState(4)
    preds = {q: int(rng.randint(len(vocab))) for q in id2datum}
    for q in list(preds)[::3]:                # a third answered right
        preds[q] = vocab[id2datum[q]["answer"]]
    for method in ("evaluate_overall", "evaluate_all_qtypes",
                   "evaluate_novel_comp", "evaluate_comp_steps",
                   "evaluate_indirect_ref"):
        assert getattr(ev, method)(preds) == getattr(jev, method)(preds), method
    _, prec = ev.evaluate_indirect_ref(preds)
    assert ev.evaluate_precision(prec) == jev.evaluate_precision(prec)
    assert ev.oracle_score(list(id2datum)) == 1.0
    for indirect in (False, True):
        ev.dump_result(preds, tmp_path / "a.json", indirect_ref=indirect)
        jev.dump_result(preds, tmp_path / "b.json", indirect_ref=indirect)
        assert ((tmp_path / "a.json").read_text()
                == (tmp_path / "b.json").read_text())
    assert evalsuite.AGQA_ALL_QTYPES_NAMES == jax_evalsuite.AGQA_ALL_QTYPES_NAMES


def test_json_or_pickle_loading_matches_jax(tmp_path):
    obj = {"a": [1, 2], "b": {"c": "d"}}
    (tmp_path / "x.json").write_text(json.dumps(obj))
    (tmp_path / "y.json").write_bytes(pickle.dumps(obj))
    for name in ("x.json", "y.json"):
        assert (io.load_json_or_pickle(tmp_path / name)
                == jax_io.load_json_or_pickle(tmp_path / name) == obj)


def test_metric_records_and_log_lines_match_jax(tmp_path):
    for mod, sub in ((metrics, "ours"), (jax_metrics, "theirs")):
        w = mod.MetricWriter(str(tmp_path / sub))
        w.write(3, {"total_loss": 1.5, "hg_train_acc": 0.25}, epoch=1)
        w.log("Epoch 1 step 3: total_loss=1.5000")
        w.close()
    ours = [json.loads(x) for x in
            (tmp_path / "ours" / "metrics.jsonl").read_text().splitlines()]
    theirs = [json.loads(x) for x in
              (tmp_path / "theirs" / "metrics.jsonl").read_text().splitlines()]
    for rec in ours + theirs:
        rec.pop("time")
    assert ours == theirs
    assert ((tmp_path / "ours" / "log.log").read_text()
            == (tmp_path / "theirs" / "log.log").read_text())
    assert not metrics.Profiler(str(tmp_path)).enabled


def test_prefetch_stages_batches_and_propagates_errors():
    batches = [{"x": np.arange(6, dtype=np.int32).reshape(2, 3) + i,
                "ques_id": [f"q{i}", "p"], "n_valid": 2} for i in range(5)]
    got = list(pipeline.prefetch(iter(batches), depth=2, device="cpu"))
    assert len(got) == 5
    for b, want in zip(got, batches):
        assert isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.int32
        np.testing.assert_array_equal(b["x"].numpy(), want["x"])
        assert b["ques_id"] == want["ques_id"] and b["n_valid"] == 2
    host = list(pipeline.prefetch(iter(batches)))
    assert isinstance(host[0]["x"], np.ndarray)

    def broken():
        yield batches[0]
        raise RuntimeError("upstream failed")

    with pytest.raises(RuntimeError, match="upstream failed"):
        list(pipeline.prefetch(broken(), device="cpu"))
    with pytest.raises(NotImplementedError, match="item 14"):
        pipeline.Batcher(batches, host_shard=(0, 2))


def test_checkpoints_round_trip_and_refuse_jax_ones(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = {"params": {"w": torch.randn(3, 4)}, "opt_state": None,
             "step": 7}
    ckpt.save("LAST", state)
    assert ckpt.exists("LAST") and not ckpt.exists("BEST")
    assert not any(p.name.startswith("LAST.tmp") for p in tmp_path.iterdir())
    for name in ("LAST", str(tmp_path / "LAST")):
        back = ckpt.restore(name)
        assert back["step"] == 7
        assert torch.equal(back["params"]["w"], state["params"]["w"])
    # an orbax checkpoint is a directory; reference .pth files go through
    # Trainer.load (tests/test_torch_weights_import.py)
    os.makedirs(tmp_path / "orbax" / "BEST")
    with pytest.raises(NotImplementedError, match="item 1"):
        ckpt.restore(str(tmp_path / "orbax" / "BEST"))

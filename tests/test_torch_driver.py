"""The port's ``agqa_hgqa`` driver on the CPU: ``cli.agqa_hgqa.main(argv,
device="cpu")`` with the flagship flags and ``--pallasFFNTrain`` trains two
epochs on synthetic data with per-epoch validation and writes its logs and
CURRENT/BEST/LAST; ``--load`` restores LAST bit-equal; ``--test`` runs the
test protocol from it.  The flags keep the flagship topology; the test
shrinks the widths (hidden 32, 4 heads) and the slow_r50 trunk (toy widths)
so that a run takes seconds on one CPU core.  Also the ``Trainer``'s early
stopping, ``predict``'s pad rows, and the options the driver refuses."""

import contextlib
import dataclasses
import io
import json
import re

import numpy as np
import pytest
import torch

from shgvqa_tpu_torch.cli import agqa_hgqa, agqa_q, agqa_vqa, common, star
from shgvqa_tpu_torch.configs.config import check_ported, tiny_test_config
from shgvqa_tpu_torch.entry import build_model, example_batch
from shgvqa_tpu_torch.models import layers, shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.step import trainable_mask
from test_torch_common import TOY

FLAGS = ["--taskHGQA", "--noCaps", "--crossAttnType", "cross",
         "--llayers", "5", "--xlayers", "2", "--rlayers", "5",
         "--dlayers", "5", "--backbone", "slow_r50", "--pallasFFNTrain",
         "--LossHGPerFrame", "--freezeBackbone", "--numSituations", "4",
         "--numRel", "4", "--numAct", "2", "--imageSize", "32",
         "--computeDtype", "float32", "--lr", "1e-3", "--logFreq", "4"]
# the JAX package's metric record of an hgqa train step (train/step.py)
RECORD_KEYS = {"step", "time", "epoch", "hgqa_loss", "hg_train_acc",
               "rel_loss", "act_loss", "rel_class_error", "act_class_error",
               "total_loss"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default pool (one thread per core) in each oversubscribes
    the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shrink(monkeypatch):
    """Narrow widths and a toy-width trunk under the real flags."""
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
        result = agqa_hgqa.main(argv, device="cpu")
    return result, out.getvalue()


def _argv(out, *extra):
    return FLAGS + ["--tiny", "--syntheticData", "24", "--batchSize", "2",
                    "--epochs", "2", "--output", str(out), "--dataDir",
                    str(out), *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        result, stdout = _main(_argv(out))
        yield out, result, stdout


def test_train_writes_logs_metrics_and_checkpoints(run):
    out, result, stdout = run
    assert result["steps"] == 24 and len(result["history"]) == 2
    assert "agqa driver: task=hgqa device=cpu" in stdout
    assert "no BERT weights at" in stdout          # not --fromScratch
    assert "no pretrained backbone at" in stdout
    logged = (out / "log.log").read_text()
    for line in ("Epoch 0 step 0:", "Epoch 0: 12 steps in",
                 "valid rel class acc", "Epoch 1: valid"):
        assert line in logged
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 4, 8, 12, 16, 20]
    assert all(set(r) == RECORD_KEYS for r in records)
    assert all(np.isfinite(r["total_loss"]) for r in records)
    names = {p.name for p in out.iterdir()}
    assert {"CURRENT", "LAST", "log.log", "metrics.jsonl"} <= names
    hg = [float(s) for s in re.findall(r" hg (\d+\.\d+)", logged)]
    assert ("BEST" in names) == any(s > 0 for s in hg)
    assert result["best"] == max(h["hg"] for h in result["history"])


def test_load_restores_last_bit_equal(run, tmp_path, monkeypatch):
    out, result, _ = run
    _shrink(monkeypatch)
    _main(_argv(tmp_path, "--epochs", "0", "--load", str(out / "LAST")))
    saved = torch.load(out / "LAST", weights_only=True)
    again = torch.load(tmp_path / "LAST", weights_only=True)
    assert again["step"] == saved["step"] == result["steps"]
    assert saved["params"].keys() == again["params"].keys()
    for k, v in saved["params"].items():
        assert torch.equal(v, again["params"][k]), k
    for k in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in
                   zip(saved["opt_state"][k], again["opt_state"][k]))
    assert saved["opt_state"]["step_count"] == result["steps"]
    assert again["opt_state"]["step_count"] == result["steps"]


def test_test_protocol_from_load(run, tmp_path, monkeypatch):
    out, _, _ = run
    _shrink(monkeypatch)
    result, stdout = _main(_argv(tmp_path, "--test", "test", "--load",
                                 str(out / "LAST")))
    assert "Oracle score: 1.0000" in stdout
    assert len(result["all_qtypes"]) == len(result["hg_all_qtypes"]) == 31
    for name in ("predict.json", "predict_hg.json"):
        preds = json.loads((tmp_path / name).read_text())
        assert len(preds) == 24
        assert {"id", "question", "prediction", "answer"} <= set(preds[0])


def test_test_protocol_with_pallas_attention(run, tmp_path, monkeypatch):
    """``--test --pallasAttention``: every eval forward runs its 38
    attention sites (the flagship topology) through ``fused_attention`` at
    rate 0, and the protocol's oracle and files are as without it."""
    out, _, _ = run
    _shrink(monkeypatch)
    calls = []
    fused = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention",
                        lambda *a: calls.append(a[4:]) or fused(*a))
    result, stdout = _main(_argv(tmp_path, "--test", "test", "--load",
                                 str(out / "LAST"), "--pallasAttention"))
    assert "Oracle score: 1.0000" in stdout
    assert len(calls) >= 38 and len(calls) % 38 == 0
    assert all(rest == (0.0,) for rest in calls)
    assert len(result["all_qtypes"]) == len(result["hg_all_qtypes"]) == 31
    for name in ("predict.json", "predict_hg.json"):
        assert len(json.loads((tmp_path / name).read_text())) == 24


def test_published_recipe_trains_the_trunk_and_repeats_bit_equal(
        tmp_path, monkeypatch):
    """The published recipe (no ``--freezeBackbone``, ``--augmentType
    rand_aug``) for an epoch, twice from one seed: the same bits in LAST;
    against the initial weights (``--epochs 0``) every trunk conv and
    BatchNorm weight moved and the BatchNorm statistics did not."""
    _shrink(monkeypatch)
    argv = [a for a in FLAGS if a != "--freezeBackbone"] + [
        "--augmentType", "rand_aug", "--tiny", "--syntheticData", "8",
        "--batchSize", "2", "--dataDir", str(tmp_path)]
    last = {}
    for name, epochs in (("init", "0"), ("a", "1"), ("b", "1")):
        _main(argv + ["--epochs", epochs, "--output", str(tmp_path / name)])
        last[name] = torch.load(tmp_path / name / "LAST",
                                weights_only=True)["params"]
    for k, v in last["a"].items():
        assert torch.equal(v, last["b"][k]), k
    trunk = [k for k in last["a"] if k.startswith("backbone.")]
    stats = [k for k in trunk if k.endswith(("running_mean", "running_var"))]
    assert stats and len(stats) < len(trunk)
    for k in trunk:
        same = torch.equal(last["a"][k], last["init"][k])
        assert same == (k in stats), k


def test_driver_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agqa_hgqa.main(_argv(tmp_path))


@pytest.mark.parametrize("extra,match", [
    (["--multiGPU"], "item 14"),
    (["--loadLXMERT", "snap/x"], "item 18"),
    (["--scanLayers"], "item 19"),
    (["--sharedWeights"], "item 17"),
    (["--remat"], "item 19"),
    (["--loadLXMERTQA", "snap/x"], "item 18"),
    (["--vitInit"], "item 17"),
], ids=["multiGPU", "loadLXMERT", "scanLayers", "sharedWeights", "remat",
        "loadLXMERTQA", "vitInit"])
def test_driver_refuses_unported_options(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        agqa_hgqa.main(_argv(tmp_path, *extra), device="cpu")


@pytest.mark.parametrize("aug", ["no_aug", "no_aug_slowfast", "rand_aug",
                                 "rand_aug_slowfast", "aug_mix"])
def test_published_recipe_flags_parse_and_pass_the_train_checks(aug):
    """The published AGQA recipe (``README.md``): every ``--augmentType``
    and no ``--freezeBackbone`` parse to a trained trunk and pass
    ``check_ported(..., train=True)``."""
    argv = [a for a in FLAGS if a != "--freezeBackbone"]
    cfg, _ = common.parse_reference_flags_with_extras(
        argv + ["--augmentType", aug], dataset="agqa")
    assert cfg.data.augment_type == aug and not cfg.freeze_backbone
    check_ported(cfg, video=True, train=True)
    frozen, _ = common.parse_reference_flags_with_extras(FLAGS,
                                                         dataset="agqa")
    assert frozen.freeze_backbone


def test_driver_trains_two_steps_a_launch_as_single_steps(tmp_path,
                                                           monkeypatch):
    """``--stepsPerLoop 2`` parses, passes the train checks and trains 3
    steps an epoch (one chunk of 2, then a single step) for 2 epochs
    through ``run_driver``: the same losses and LAST as ``--stepsPerLoop
    1``."""
    cfg, _ = common.parse_reference_flags_with_extras(
        FLAGS + ["--stepsPerLoop", "2"], dataset="agqa")
    assert cfg.steps_per_loop == 2
    check_ported(cfg, video=True, train=True)
    _shrink(monkeypatch)
    runs = {}
    for k in ("1", "2"):
        out = tmp_path / k
        result, _ = _main(_argv(out, "--syntheticData", "6", "--logFreq",
                                "1", "--stepsPerLoop", k))
        assert result["steps"] == 6
        runs[k] = ([json.loads(x)["total_loss"] for x in
                    (out / "metrics.jsonl").read_text().splitlines()],
                   torch.load(out / "LAST", weights_only=True))
    assert len(runs["2"][0]) == 6 and runs["2"][0] == runs["1"][0]
    for key, value in runs["1"][1]["params"].items():
        assert torch.equal(value, runs["2"][1]["params"][key]), key


def test_driver_refuses_star_and_the_global_matcher(tmp_path):
    """STAR and the global matcher run now (``tests/test_torch_star.py``):
    both pass the CLI's flag checks; what STAR still refuses is its capsule
    encoder (no ``--noCaps``, item 17).  Per-choice QA and ``--outputAttn``
    pass STAR's checks; the AGQA drivers refuse per-choice QA (AGQA items
    have no choices)."""
    argv = [a for a in _argv(tmp_path) if a != "--LossHGPerFrame"]
    for dataset in ("agqa", "star"):
        cfg, extras = common.parse_reference_flags_with_extras(argv, dataset)
        assert not cfg.loss_hg_per_frame
        common._check_driver_flags(cfg, extras, dataset)
    no_caps = [a for a in argv if a != "--noCaps"]
    with pytest.raises(NotImplementedError, match="item 17"):
        common.run_driver("star", no_caps, device="cpu")
    for extra in (["--qaArrangeType", "add_sep"], ["--outputAttn"]):
        cfg, extras = common.parse_reference_flags_with_extras(
            argv + extra, "star")
        common._check_driver_flags(cfg, extras, "star")
    cfg, extras = common.parse_reference_flags_with_extras(
        argv + ["--qaArrangeType", "add_sep"], "agqa")
    with pytest.raises(ValueError, match="STAR's per-choice QA"):
        common._check_driver_flags(cfg, extras, "agqa")


def test_driver_refuses_a_present_pretrained_weight_file(tmp_path,
                                                         monkeypatch):
    """A present trunk file is loaded (``tests/test_torch_weights_import.py``
    loads real ones); one that is not flax msgpack stops the run."""
    _shrink(monkeypatch)
    (tmp_path / "slow_r50_flax.msgpack").write_bytes(b"weights")
    with pytest.raises(ValueError, match="msgpack"):
        _main(_argv(tmp_path))


def _tiny_trainer(tmp_path, monkeypatch, **optim):
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))
    cfg = tiny_test_config(task="hgqa", use_pallas_ffn_train=True,
                           output=str(tmp_path), log_freq=1)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=32),
        optim=dataclasses.replace(cfg.optim, **optim))
    model = build_model(cfg, "cpu", seed=0)
    batch = example_batch(cfg, 2, 0, with_labels=True)
    batch.pop("visual_mask")
    batch["frames"] = np.random.RandomState(1).randint(
        0, 255, (2, cfg.encoder.visual_t + 8, 32, 32, 3)).astype(np.uint8)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch.update(ques_id=["q0", "q1"], n_valid=2)
    return Trainer(cfg, 2, model, trainable_mask(model, cfg)), batch


def test_early_stopping_and_checkpoints(tmp_path, monkeypatch):
    trainer, batch = _tiny_trainer(tmp_path, monkeypatch, epochs=6,
                                   early_stop_patience=2)
    calls = []

    def evaluate(tr):
        calls.append(tr.step)
        return 0.0, 0.0

    summary = trainer.train(lambda ep: [batch, batch], evaluate)
    assert summary == {"best": 0.0, "steps": 4, "history": [
        {"epoch": 0, "valid": 0.0, "hg": 0.0},
        {"epoch": 1, "valid": 0.0, "hg": 0.0}]}
    assert calls == [2, 4]
    assert "Early stopping at epoch 2" in (tmp_path / "log.log").read_text()
    assert trainer.ckpt.exists("LAST") and trainer.ckpt.exists("CURRENT")
    assert not trainer.ckpt.exists("BEST")
    assert trainer.optimizer.step_count == 4


def test_predict_skips_pad_rows(tmp_path, monkeypatch):
    trainer, batch = _tiny_trainer(tmp_path, monkeypatch)
    padded = dict(batch, ques_id=["a", "a"], n_valid=1)
    q2a, hg_q2a, acc = trainer.predict([batch, padded],
                                       return_hg_metrics=True)
    assert list(q2a) == list(hg_q2a) == ["q0", "q1", "a"]
    assert set(acc) == {"rel_class_acc", "act_class_acc"}
    q2a_only = trainer.predict([padded])
    assert len(q2a_only) == 2 and list(q2a_only[0]) == ["a"]


# the ablation drivers: (module, task flag, train steps' attention forward /
# backward and FFN-train forward / backward sites, eval FFN sites) at the
# flagship topology (5 / 2 / 5 layers)
ABLATIONS = {"q": (agqa_q, "--taskQ", 5, 5, 5, 5, 5),
             "vqa": (agqa_vqa, "--taskVQA", 14, 14, 14, 14, 14)}


def _site_spies(monkeypatch):
    """Counts of the kernel wrappers' calls (what the card launches; on the
    CPU they run their plain versions), a backward through a site counted
    by a hook on its output."""
    calls = {k: 0 for k in ("attn", "attn_bwd", "ffn", "ffn_train",
                            "ffn_train_bwd")}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            out = fn(*a, **kw)
            if out.requires_grad and name + "_bwd" in calls:
                out.register_hook(lambda g: calls.__setitem__(
                    name + "_bwd", calls[name + "_bwd"] + 1))
            return out
        return wrapped

    for name, attr in (("attn", "fused_attention"), ("ffn", "fused_ffn"),
                       ("ffn_train", "fused_ffn_train")):
        monkeypatch.setattr(layers, attr, spy(name, getattr(layers, attr)))
    return calls


@pytest.mark.parametrize("task", sorted(ABLATIONS))
def test_ablation_driver_trains_reloads_and_tests(tmp_path, monkeypatch,
                                                  task):
    """``cli.agqa_q`` / ``cli.agqa_vqa`` on synthetic data: one epoch (the
    kernel wrappers called at the flagship topology's sites per train step
    and per eval forward; 'q' builds no trunk and loads none), LAST
    reloaded bit-equal, then ``--test`` from it (oracle 1.0, both predict
    files)."""
    module, flag, attn, attn_bwd, ffn_t, ffn_t_bwd, ffn = ABLATIONS[task]
    _shrink(monkeypatch)
    calls = _site_spies(monkeypatch)
    argv = [a for a in FLAGS if a != "--taskHGQA"] + [
        flag, "--tiny", "--syntheticData", "8", "--syntheticValid", "4",
        "--batchSize", "2", "--logFreq", "1", "--dataDir", str(tmp_path)]
    out = tmp_path / "train"

    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = module.main(argv + list(extra), device="cpu")
        return result, buf.getvalue()

    result, stdout = run("--epochs", "1", "--output", str(out))
    assert f"agqa driver: task={task} device=cpu" in stdout
    assert ("no pretrained backbone" in stdout) == (task != "q")
    # 8 items at B=2; 4 valid items at the AGQA eval batch, B // 4 = 1
    steps, evals = result["steps"], 4
    assert steps == 4
    assert calls == {"attn": attn * steps, "attn_bwd": attn_bwd * steps,
                     "ffn_train": ffn_t * steps,
                     "ffn_train_bwd": ffn_t_bwd * steps, "ffn": ffn * evals}
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == steps and all(
        {"vqa_loss", "total_loss"} <= set(r)
        and np.isfinite(r["total_loss"]) for r in records)
    saved = torch.load(out / "LAST", weights_only=True)["params"]
    assert any(k.startswith("backbone.") for k in saved) == (task != "q")
    run("--epochs", "0", "--load", str(out / "LAST"), "--output",
        str(tmp_path / "again"))
    again = torch.load(tmp_path / "again" / "LAST", weights_only=True)
    for k, v in saved.items():
        assert torch.equal(v, again["params"][k]), k
    test_out = tmp_path / "test"
    result, stdout = run("--test", "test", "--load", str(out / "LAST"),
                         "--output", str(test_out))
    assert "Oracle score: 1.0000" in stdout
    assert len(result["all_qtypes"]) == 31
    for name in ("predict.json", "predict_hg.json"):
        assert len(json.loads((test_out / name).read_text())) == 4


@pytest.mark.parametrize("extra", [["--outputAttn"],
                                   ["--qaArrangeType", "no_sep"]],
                         ids=["outputAttn", "perChoice"])
@pytest.mark.parametrize("task", sorted(ABLATIONS))
def test_ablation_drivers_refuse_what_stays_item_15(tmp_path, monkeypatch,
                                                    task, extra):
    """What item 15 ported runs for the ablation tasks: ``--outputAttn``
    with the AGQA driver of the task (``--test``: the dump files, the hg
    file from ``logit``, which is all a 'q' / 'vqa' model has, so the two
    files agree); per-choice QA with the STAR driver (one epoch, finite
    losses), while the AGQA driver refuses it (AGQA items have no
    choices)."""
    module, flag = ABLATIONS[task][:2]
    _shrink(monkeypatch)
    argv = [flag, "--noCaps", "--tiny", "--syntheticData", "4",
            "--syntheticValid", "4", "--batchSize", "2", "--imageSize",
            "32", "--numSituations", "4", "--computeDtype", "float32",
            "--dataDir", str(tmp_path), "--output", str(tmp_path / "out"),
            *extra]
    buf = io.StringIO()
    if "--outputAttn" in extra:
        with contextlib.redirect_stdout(buf):
            result = module.main(argv + ["--test", "test"], device="cpu")
        assert result["attention_dumps"]["questions"] == 4
        got = json.loads((tmp_path / "out" /
                          "val_attentions_cross_2.json").read_text())
        hg = json.loads((tmp_path / "out" /
                         "hg_val_attentions_cross_2.json").read_text())
        assert len(got) == 4 and got == hg
        assert all(r["attention"] == [] for r in got)
        return
    with pytest.raises(ValueError, match="STAR's per-choice QA"):
        module.main(argv, device="cpu")
    with contextlib.redirect_stdout(buf):
        result = star.main(argv + ["--epochs", "1", "--qType", "Interaction",
                                   "--syntheticData", "16"], device="cpu")
    assert result["steps"] >= 1
    records = [json.loads(x) for x in (tmp_path / "out" /
                                       "metrics.jsonl").read_text()
               .splitlines()]
    assert records and all(np.isfinite(r["total_loss"]) for r in records)


def test_star_driver_per_choice_with_attention_dumps(tmp_path, monkeypatch):
    """The STAR driver with README.md's STAR flags, ``--noCaps
    --qaArrangeType add_sep --outputAttn --stepsPerLoop 2``: one epoch
    (one chunk of two steps) with the valid split's dumps, LAST reloaded
    bit-equal, then ``--test`` from LAST (oracle 1.0, ``by_qtype``, both
    predict files, both dump files with an entry a question, each
    attention row as long as the HG token count, the global grids (S,
    slots), the npz maps with the per-choice rows)."""
    _shrink(monkeypatch)
    argv = ["--taskHGQA", "--useHGMask", "--qType", "Interaction",
            "--noCaps", "--qaArrangeType", "add_sep", "--outputAttn",
            "--numSituations", "4", "--numRel", "4", "--numAct", "2",
            "--imageSize", "32", "--computeDtype", "float32", "--lr",
            "1e-3", "--logFreq", "1", "--batchSize", "2", "--dataDir",
            str(tmp_path), "--syntheticData", "16", "--syntheticValid", "16"]
    out = tmp_path / "train"

    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = star.main(argv + list(extra), device="cpu")
        return result, buf.getvalue()

    result, stdout = run("--epochs", "1", "--stepsPerLoop", "2", "--output",
                         str(out))
    assert result["steps"] == 2
    assert result["attention_dumps"]["questions"] == 4
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 2 and all(np.isfinite(r["total_loss"])
                                     for r in records)
    saved = torch.load(out / "LAST", weights_only=True)["params"]
    assert "head.choice_score_fc.fc1.weight" in saved
    assert not any(k.startswith("head.logit_fc") for k in saved)
    run("--epochs", "0", "--load", str(out / "LAST"), "--output",
        str(tmp_path / "again"))
    again = torch.load(tmp_path / "again" / "LAST", weights_only=True)
    for k, v in saved.items():
        assert torch.equal(v, again["params"][k]), k
    test_out = tmp_path / "test"
    result, stdout = run("--test", "test", "--load", str(out / "LAST"),
                         "--output", str(test_out))
    assert "Oracle score: 1.0000" in stdout
    assert set(result["by_qtype"]) == {"Interaction", "Sequence",
                                       "Prediction", "Feasibility"}
    for name in ("predict.json", "predict_hg.json"):
        assert len(json.loads((test_out / name).read_text())) == 4
    hg_tokens = 1 + 4 * (2 + 4)
    for name in ("val_attentions_cross_2.json",
                 "hg_val_attentions_cross_2.json"):
        entries = json.loads((test_out / name).read_text())
        assert len(entries) == 4
        for e in entries:
            assert np.asarray(e["attention"]).shape == (4, hg_tokens)
            assert 0 <= e["prediction"] < 4
    valid = json.loads((out / "val_attentions_cross_2.json").read_text())
    assert np.asarray(valid[0]["rel_pred"]).shape[0] == 4
    maps = np.load(test_out / "attentions" / "batch000.npz")
    assert maps["attn.hgq.1.xl"].shape[:2] == (2 * 4, 4)
    assert maps["attn.encoder.lang.0"].shape[0] == 2 * 4

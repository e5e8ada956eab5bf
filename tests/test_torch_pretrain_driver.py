"""The port's pretraining driver (``python -m shgvqa_tpu_torch.cli.pretrain``)
end to end on the CPU, and its snapshots in the fine-tune drivers
(``--loadLXMERT``, ``--loadLXMERTQA``, ``Trainer.load_encoder`` /
``load_lxmert_qa``).

- Two epochs of all five tasks on synthetic items print and return JAX's
  metric keys, and write ``Epoch{NN}_LXRT`` (the LXRT's state_dict) and
  ``Epoch{NN}_qa_head.npz`` (JAX's format); no task flag runs LM + matched
  + QA.
- Pretraining on ``pretrain_items.json`` (answers from the AGQA synthetic
  vocabulary and some it lacks), then the port's ``agqa_hgqa`` driver with
  ``--loadLXMERTQA`` (``--epochs 0``, so LAST holds the loaded weights):
  every encoder tensor bit-equal to the snapshot, and ``logit_fc.fc2``'s
  rows exactly JAX's ``answer_head_surgery`` of the npz; ``--loadLXMERT``
  loads the encoder and leaves the head at its init.
- A capsule encoder's snapshot loaded into a ``--noCaps`` model reports
  what JAX's ``Trainer.load_encoder`` reports (JAX's method run on the
  same trees); a model without ``logit_fc`` raises ``KeyError`` in both
  packages; a directory (a JAX orbax snapshot) is refused.

The widths are shrunk as in ``test_torch_driver.py`` (hidden 32, the toy
trunk); the pretraining parse is given the fine-tune model's encoder."""

import contextlib
import dataclasses
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import shgvqa_tpu_torch.configs.cli as cli_mod
from shgvqa_tpu.models import pretrain as jax_pretrain
from shgvqa_tpu.train.loop import Trainer as JaxTrainer
from shgvqa_tpu_torch.cli import agqa_hgqa, common, pretrain as driver
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import to_jax_variables
from shgvqa_tpu_torch.data import synthetic
from shgvqa_tpu_torch.models import shgvqa
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from shgvqa_tpu_torch.train.loop import Trainer, save_encoder_snapshot
from test_torch_driver import _argv, _shrink

# the JAX driver's metric keys (shgvqa_tpu/cli/pretrain.py, loss_fn)
ALL_KEYS = {"lm_loss", "matched_loss", "qa_loss", "contrastive_loss",
            "visn_loss", "total_loss"}
DEFAULT_KEYS = {"lm_loss", "matched_loss", "qa_loss", "total_loss"}
ALL_TASKS = ["--taskMaskLM", "--taskMatched", "--taskQA",
             "--taskContrastive", "--taskObjPredict"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fine_tune_cfg(tmp_path, monkeypatch):
    """The fine-tune driver's config under the shrunk flags, with the
    encoder its video model builds (the tokenizer's width and grid follow
    from the toy trunk)."""
    _shrink(monkeypatch)
    cfg, _ = common.parse_reference_flags_with_extras(
        _argv(tmp_path), dataset="agqa")
    with torch.device("meta"):
        enc = VideoShgVqaModel(cfg).head.cfg.encoder
    return cfg, enc


def _pretrain(out, data_dir, enc, max_len, *extra):
    """The port's pretraining driver at ``enc``'s widths, 2 epochs."""
    parse = cli_mod.parse_reference_flags_with_extras

    def narrow(argv=None, dataset=None):
        cfg, extras = parse(argv, dataset)
        return cfg.replace(encoder=enc, data=dataclasses.replace(
            cfg.data, max_seq_length=max_len)), extras

    argv = ["--train", "train", "--batchSize", "4", "--epochs", "2",
            "--lr", "1e-3", "--output", str(out), "--dataDir",
            str(data_dir), *extra]
    stdout = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(stdout):
        mp.setattr(cli_mod, "parse_reference_flags_with_extras", narrow)
        last = driver.main(argv, device="cpu")
    return last, stdout.getvalue()


@pytest.mark.parametrize("tasks,keys", [(ALL_TASKS, ALL_KEYS),
                                        ([], DEFAULT_KEYS)],
                         ids=["all_tasks", "default_tasks"])
def test_pretraining_runs_with_jax_metric_keys(tmp_path, tasks, keys):
    enc = tiny_test_config().encoder
    out = tmp_path / "pre"
    last, stdout = _pretrain(out, tmp_path, enc, 12, "--syntheticData",
                             "12", *tasks)
    assert set(last) == keys
    assert all(np.isfinite(v) for v in last.values())
    for epoch in (0, 1):
        line = next(x for x in stdout.splitlines()
                    if x.startswith(f"Epoch {epoch}: "))
        assert {kv.split("=")[0] for kv in line.split()[2:]} == keys
    snap = torch.load(out / "Epoch01_LXRT", weights_only=True)
    assert set(snap) == {"lxrt"}
    with torch.device("meta"):
        names = set(ShgVqaModel(tiny_test_config(task="vqa"))
                    .lxrt.state_dict())
    assert set(snap["lxrt"]) == names
    with np.load(out / "Epoch01_qa_head.npz") as qa:
        assert qa["weight"].shape == (len(qa["answers"]),
                                      2 * enc.hidden_size)
        assert qa["bias"].shape == (len(qa["answers"]),)
        assert qa["answers"].dtype.kind == "U"


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """Pretraining on ``pretrain_items.json`` at the fine-tune model's
    encoder: answers from the AGQA synthetic vocabulary and two it lacks."""
    tmp = tmp_path_factory.mktemp("pre")
    with pytest.MonkeyPatch.context() as mp:
        cfg, enc = _fine_tune_cfg(tmp, mp)
    rng = np.random.RandomState(0)
    vocab = sorted(synthetic.answer_vocab())
    answers = vocab[:6] + ["neverseen", "Also Unknown"]
    items = []
    for i in range(16):
        path = tmp / f"feat{i}.npz"
        np.savez(path, feats=rng.randn(
            enc.visual_t + 8, enc.visual_hw, enc.visual_hw,
            enc.visual_feat_dim).astype(np.float32))
        items.append({"sent": f"what does the person hold {i % 5}",
                      "feat_file": str(path),
                      "answer": answers[i % len(answers)]})
    (tmp / "pretrain_items.json").write_text(json.dumps(items))
    last, _ = _pretrain(tmp / "out", tmp, enc, cfg.data.max_seq_length,
                        "--buildVocab", *ALL_TASKS)
    assert set(last) == ALL_KEYS
    return tmp / "out" / "Epoch01_LXRT"


def _fine_tune(tmp_path, monkeypatch, *extra):
    _shrink(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = agqa_hgqa.main(_argv(tmp_path, "--epochs", "0", *extra),
                                device="cpu")
    last = torch.load(tmp_path / "LAST", weights_only=True)["params"]
    return result, last, (tmp_path / "log.log").read_text()


def test_load_lxmert_qa_into_the_agqa_driver(pretrained, tmp_path,
                                             monkeypatch):
    result, last, log = _fine_tune(tmp_path, monkeypatch, "--loadLXMERTQA",
                                   str(pretrained))
    snap = torch.load(pretrained, weights_only=True)["lxrt"]
    for name, value in snap.items():
        assert torch.equal(last[f"head.lxrt.{name}"], value), name
    base = str(pretrained)[:-len("_LXRT")]
    with np.load(base + "_qa_head.npz") as qa:
        weight, bias, answers = qa["weight"], qa["bias"], qa["answers"]
    label2ans = {i: a for a, i in synthetic.answer_vocab().items()}
    fc2_w = last["head.logit_fc.fc2.weight"].numpy()
    want_w, want_b, loaded, unloaded = jax_pretrain.answer_head_surgery(
        weight, bias, np.ones_like(fc2_w), np.ones(len(fc2_w), np.float32),
        label2ans, jax_pretrain.AnswerTable([str(a) for a in answers]))
    np.testing.assert_array_equal(fc2_w, want_w)
    np.testing.assert_array_equal(last["head.logit_fc.fc2.bias"].numpy(),
                                  want_b)
    assert 0 < loaded < len(label2ans) and unloaded > 0
    assert result["load_lxmert_qa"] == (loaded, unloaded)
    assert (f"load_lxmert_qa: {loaded} answers initialized from "
            f"pretraining, {unloaded} zeroed") in log


def test_load_lxmert_loads_the_encoder_only(pretrained, tmp_path,
                                            monkeypatch):
    _, last, log = _fine_tune(tmp_path / "a", monkeypatch, "--loadLXMERT",
                              str(pretrained))
    _, plain, _ = _fine_tune(tmp_path / "b", monkeypatch)
    snap = torch.load(pretrained, weights_only=True)["lxrt"]
    for name, value in snap.items():
        assert torch.equal(last[f"head.lxrt.{name}"], value), name
    for name, value in plain.items():
        if not name.startswith("head.lxrt."):
            assert torch.equal(last[name], value), name
    assert f"{len(snap)} tensors" in log


def _jax_trainer(params, restored, logs):
    """Enough of a JAX ``Trainer`` for its ``load_encoder`` and
    ``load_lxmert_qa`` to run on given trees (``restored`` stands in for
    the orbax restore)."""
    fake = SimpleNamespace(
        params={"params": params},
        ckpt=SimpleNamespace(path=lambda p: p, _ckptr=SimpleNamespace(
            restore=lambda p: restored)),
        _encoder_root=JaxTrainer._encoder_root,
        metrics=SimpleNamespace(log=logs.append),
        _reset_opt=lambda: None)
    fake.load_encoder = lambda p: JaxTrainer.load_encoder(fake, p)
    return fake


def test_capsule_snapshot_into_no_caps_gives_jax_report(tmp_path):
    caps_cfg = tiny_test_config(task="vqa").replace(
        encoder=dataclasses.replace(tiny_test_config().encoder,
                                    no_caps=False, caps_cross_attn=True))
    caps = init_weights(ShgVqaModel(caps_cfg), 1)
    path = str(tmp_path / "caps_LXRT")
    save_encoder_snapshot(path, "lxrt", caps.lxrt)
    cfg = tiny_test_config(task="vqa").replace(output=str(tmp_path / "run"))
    model = init_weights(ShgVqaModel(cfg), 2)
    before = to_jax_variables(model.state_dict())["params"]
    trainer = Trainer(cfg, 1, model)
    stats = trainer.load_encoder(path)
    jax_logs = []
    fake = _jax_trainer(
        before, {"lxrt": to_jax_variables(caps.lxrt.state_dict())["params"]},
        jax_logs)
    JaxTrainer.load_encoder(fake, path)
    port_log = (tmp_path / "run" / "log.log").read_text().splitlines()[-1]
    assert port_log.endswith(jax_logs[-1])
    assert stats["loaded"] > 0 and stats["unexpected"]
    assert any("caps_tokenizer" in n for n in stats["unexpected"])
    # the loaded tensors are JAX's
    after = to_jax_variables(model.state_dict())["params"]
    want = fake.params["params"]
    for key in want["lxrt"]["embeddings"]["word_embeddings"]:
        np.testing.assert_array_equal(
            after["lxrt"]["embeddings"]["word_embeddings"][key],
            np.asarray(want["lxrt"]["embeddings"]["word_embeddings"][key]))
    # a model without logit_fc (per-choice heads): KeyError in both
    pc_cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, qa_arrange_type="add_sep"))
    pc = Trainer(pc_cfg, 1, init_weights(ShgVqaModel(pc_cfg), 0))
    np.savez(tmp_path / "caps_qa_head.npz", weight=np.zeros((2, 64)),
             bias=np.zeros(2), answers=np.array(["a", "b"]))
    with pytest.raises(KeyError):
        pc.load_lxmert_qa(path, {0: "a"})
    fake = _jax_trainer(to_jax_variables(pc.model.state_dict())["params"],
                        {"lxrt": to_jax_variables(
                            caps.lxrt.state_dict())["params"]}, [])
    with pytest.raises(KeyError):
        JaxTrainer.load_lxmert_qa(fake, path, {0: "a"})
    # a directory is a JAX (orbax) snapshot
    (tmp_path / "orbax_LXRT").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.load_encoder(str(tmp_path / "orbax"))
    # save_encoder writes what load_encoder reads, under the output
    trainer.save_encoder("mine")
    assert trainer.load_encoder("mine")["loaded"] == len(
        model.lxrt.state_dict())

"""Driver machinery of the entry points: the port of
``shgvqa_tpu/cli/common.py`` for the AGQA dataset.

``run_driver`` parses the reference's flags into a ``Config`` and runs
either the train path (data, tokenizer, batchers, the model with random
weights from ``--seed``, the ``Trainer`` over the trainable parameters,
per-epoch validation and CURRENT/BEST/LAST checkpoints) or, with
``--test``, the test protocol (oracle score, predictions from ``--load``,
the metric fan-out and the ``predict.json`` / ``predict_hg.json`` dumps).

The train path loads weights in the JAX driver's order: the pretrained
trunk (``--backboneWeights``, else ``{dataDir}/slow_r50_flax.msgpack``),
then, without ``--fromScratch``, bert-base (``--bertWeights``, else
``{dataDir}/pytorch_model.bin``), then ``--load``; a missing pretrained
file is reported and the run goes on at random init, as the JAX driver
does.  ``--test`` loads only ``--load``.  ``--load`` reads the port's own
checkpoints and reference ``.pth`` snapshots (``path/BEST`` with
``BEST.pth`` beside it).

It runs on the card unless the caller passes ``device="cpu"``.  What the
port does not run yet raises ``NotImplementedError`` naming its ROADMAP
item: the STAR dataset, ``--outputAttn``, mesh and multi-host flags and
``--loadLXMERT(QA)``.
"""

from __future__ import annotations

import os
import zlib
from typing import Tuple

import torch

from shgvqa_tpu_torch.configs.cli import parse_reference_flags_with_extras
from shgvqa_tpu_torch.configs.config import Config, check_ported
from shgvqa_tpu_torch.data.agqa import (
    AGQAData,
    AGQAItemSource,
    FrameLoader,
    SyntheticFrameLoader,
)
from shgvqa_tpu_torch.data.pipeline import Batcher, prefetch
from shgvqa_tpu_torch.data.tokenization import (
    BertTokenizer,
    build_vocab_from_corpus,
)
from shgvqa_tpu_torch.entry import build_model, resolve_device
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.step import trainable_mask


def build_tokenizer(cfg: Config, extras: dict, corpus) -> BertTokenizer:
    path = extras.get("vocab_path") or os.path.join(
        cfg.data.data_dir, "vocab.txt")
    if not os.path.isfile(path):
        # only synthetic smoke runs (or an explicit opt-in) may substitute a
        # corpus-built whole-word vocab: on real data it breaks WordPiece
        # parity with the reference's bert-base-uncased vocab
        if not (extras.get("synthetic_data") or extras.get("build_vocab")):
            raise SystemExit(
                f"vocab {path} not found. Real-data runs require the "
                "bert-base-uncased WordPiece vocab (point --vocab at it). "
                "Pass --buildVocab to opt into a corpus-built whole-word "
                "vocab (non-parity), or --syntheticData N for smoke runs.")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        print(f"vocab {path} not found; building whole-word vocab from "
              f"the split corpus ({len(corpus)} texts)", flush=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        build_vocab_from_corpus(corpus, tmp)
        os.replace(tmp, path)   # atomic: readers never see a partial file
    return BertTokenizer(path)


def build_data(cfg: Config, extras: dict, split: str) -> AGQAData:
    """The raw data of a split (synthetic or from files)."""
    n_syn = extras.get("synthetic_data") or 0
    if extras.get("synthetic_valid") and not n_syn:
        raise SystemExit(
            "--syntheticValid requires --syntheticData (it resizes the "
            "synthetic eval splits of a synthetic smoke run; on real data "
            "it would silently swap the valid/test split for synthetic)")
    if split != cfg.data.train_split and extras.get("synthetic_valid"):
        n_syn = extras["synthetic_valid"]
    if n_syn:
        # a stable hash: builtin hash() is randomized per process
        return AGQAData.synthetic(cfg, split, n=n_syn,
                                  seed=zlib.crc32(split.encode()) % 1000)
    return AGQAData.from_files(cfg, split)


def build_item_source(cfg: Config, extras: dict, data: AGQAData, tokenizer,
                      test_mode: bool = False) -> AGQAItemSource:
    if extras.get("synthetic_data"):
        loader = SyntheticFrameLoader(cfg.data.clip_len, cfg.data.image_size)
    elif extras.get("frame_loader") == "native":
        raise NotImplementedError(
            "--frameLoader native (the C++ PNG decoder) is not ported yet "
            "(ROADMAP queue A item 13); the port decodes with PIL")
    else:
        loader = FrameLoader(cfg.data.frame_dir, data.frame_ids,
                             cfg.data.clip_len, cfg.data.image_size)
    return AGQAItemSource(data, tokenizer, cfg, loader, test_mode)


def resolve_num_answers(cfg: Config, data) -> Config:
    return cfg.replace(num_answers=data.num_answers)


def _check_driver_flags(cfg: Config, extras: dict, dataset: str) -> None:
    if dataset != "agqa" or cfg.data.dataset != "agqa":
        raise NotImplementedError(
            "the STAR driver is not ported yet (ROADMAP queue A item 15)")
    if (extras.get("multi_gpu") or cfg.mesh.model_parallel > 1
            or cfg.mesh.data_parallel not in (-1, 1)):
        raise NotImplementedError(
            "--multiGPU / --dataParallel / --modelParallel are not ported "
            "yet (ROADMAP queue A item 14)")
    for flag, key in (("--loadLXMERT", "load_lxmert"),
                      ("--loadLXMERTQA", "load_lxmert_qa")):
        if extras.get(key):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue A item 18)")
    check_ported(cfg, video=True, train=not cfg.data.test_split)


def load_pretrained_weights(trainer: Trainer, cfg: Config,
                            extras: dict) -> None:
    """The pretrained files the JAX driver loads before ``--load``: the
    trunk, then bert-base unless ``--fromScratch``; a missing file is
    reported as the JAX driver reports it."""
    bbw = extras.get("backbone_weights") or os.path.join(
        cfg.data.data_dir, f"{cfg.backbone}_flax.msgpack")
    if os.path.isfile(bbw):
        trainer.load_backbone(bbw)
    else:
        print(f"no pretrained backbone at {bbw}; backbone stays at random "
              "init (convert via tools/convert_slow_r50.py)", flush=True)
    if not cfg.from_scratch:
        bw = extras.get("bert_weights") or os.path.join(
            cfg.data.data_dir, "pytorch_model.bin")
        if os.path.isfile(bw):
            trainer.load_bert_pretrained(bw)
        else:
            print(f"no BERT weights at {bw}; encoder stays at scratch init "
                  "(pass --fromScratch to silence, or fetch per "
                  "tools/fetch_bert_vocab.py notes)", flush=True)


def run_driver(dataset: str, argv=None, device="cuda") -> dict:
    """Full train/valid/test orchestration on ``device``; returns a result
    summary."""
    cfg, extras = parse_reference_flags_with_extras(argv, dataset=dataset)
    _check_driver_flags(cfg, extras, dataset)
    dev = resolve_device(device)
    name = (f"cuda ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else str(dev))
    print(f"shgvqa_tpu_torch {dataset} driver: task={cfg.task} device={name}",
          flush=True)
    results: dict = {"task": cfg.task}
    test_split = cfg.data.test_split

    if test_split:
        data = build_data(cfg, extras, test_split)
        cfg = resolve_num_answers(cfg, data)
        tokenizer = build_tokenizer(
            cfg, extras, [x["question"] for x in data.datums])
        src = build_item_source(cfg, extras, data, tokenizer, test_mode=True)
        batcher = Batcher(src, num_items=len(src),
                          batch_size=cfg.optim.eval_batch_size,
                          shuffle=False, seed=cfg.seed,
                          drop_last=cfg.data.parity_eval)
        model = build_model(cfg, dev, seed=cfg.seed)
        trainer = Trainer(cfg, steps_per_epoch=max(1, len(batcher)),
                          model=model)
        if cfg.load:
            trainer.load(cfg.load, params_only=True)
        # oracle sanity check: the metric plumbing must score 1.0 on the
        # ground truth when labels exist
        try:
            ev = data.evaluator()
            oracle = ev.oracle_score(list(data.id2datum.keys()))
            print(f"Oracle score: {oracle:0.4f}", flush=True)
        except (KeyError, TypeError):
            pass  # label-free test split
        q2a, hg_q2a = trainer.predict(prefetch(batcher.epoch(0), device=dev))
        results.update(report_test(cfg, data, q2a, hg_q2a))
        return results

    train_data = build_data(cfg, extras, cfg.data.train_split)
    cfg = resolve_num_answers(cfg, train_data)
    tokenizer = build_tokenizer(
        cfg, extras, [x["question"] for x in train_data.datums])
    train_src = build_item_source(cfg, extras, train_data, tokenizer)
    train_batcher = Batcher(
        train_src, num_items=len(train_src),
        batch_size=cfg.optim.batch_size, shuffle=True, drop_last=True,
        seed=cfg.seed)
    if len(train_batcher) == 0:
        raise SystemExit(
            f"train split has {len(train_src)} item(s) after filters "
            f"(tiny/fast/subset) -- fewer than one batch of "
            f"{cfg.optim.batch_size} with drop_last; lower --batchSize or "
            "widen the filters")

    valid_batcher = None
    valid_data = None
    if cfg.data.valid_split:
        valid_data = build_data(cfg, extras, cfg.data.valid_split)
        valid_src = build_item_source(cfg, extras, valid_data, tokenizer)
        valid_batcher = Batcher(
            valid_src, num_items=len(valid_src),
            batch_size=cfg.optim.eval_batch_size, shuffle=False,
            seed=cfg.seed, drop_last=cfg.data.parity_eval)

    model = build_model(cfg, dev, seed=cfg.seed)
    # the optimizer skips what the loss does not reach (the LXRT x-layers
    # and pooler under hgqa) and the frozen trunk
    trainer = Trainer(cfg, steps_per_epoch=max(1, len(train_batcher)),
                      model=model, trainable_mask=trainable_mask(model, cfg))
    load_pretrained_weights(trainer, cfg, extras)
    if cfg.load:
        trainer.load(cfg.load)

    evaluator = valid_data.evaluator() if valid_data is not None else None

    def evaluate(tr: Trainer) -> Tuple[float, float]:
        # one forward per valid batch: the predictions and the matched
        # rel/act class accuracy
        q2a, hg_q2a, hg_acc = tr.predict(
            prefetch(valid_batcher.epoch(0), device=dev),
            return_hg_metrics=True)
        if hg_acc is not None:
            tr.metrics.log(
                f"valid rel class acc {hg_acc['rel_class_acc']:0.2f} "
                f"act class acc {hg_acc['act_class_acc']:0.2f}")
        return (evaluator.evaluate_overall(q2a),
                evaluator.evaluate_overall(hg_q2a))

    summary = trainer.train(
        lambda ep: prefetch(train_batcher.epoch(ep), device=dev),
        evaluate if valid_batcher is not None else None,
    )
    results.update(summary)
    return results


def report_test(cfg: Config, data: AGQAData, q2a, hg_q2a) -> dict:
    """The AGQA test-protocol fan-out and the prediction dumps."""
    out = {}
    ev = data.evaluator()
    os.makedirs(cfg.output, exist_ok=True)
    for name, preds in (("", q2a), ("hg_", hg_q2a)):
        if cfg.data.indirect_ref:
            out[name + "all_qtypes"] = ev.evaluate_all_qtypes(preds)
            recall, prec_qs = ev.evaluate_indirect_ref(preds)
            out[name + "indirect_recall"] = recall
            out[name + "indirect_precision"] = ev.evaluate_precision(prec_qs)
        elif cfg.data.novel_comp:
            out[name + "novel_comp"] = ev.evaluate_novel_comp(preds)
        elif cfg.data.comp_steps:
            out[name + "comp_steps"] = ev.evaluate_comp_steps(preds)
        else:
            out[name + "all_qtypes"] = ev.evaluate_all_qtypes(preds)
    ev.dump_result(q2a, os.path.join(cfg.output, "predict.json"),
                   indirect_ref=cfg.data.indirect_ref)
    ev.dump_result(hg_q2a, os.path.join(cfg.output, "predict_hg.json"),
                   indirect_ref=cfg.data.indirect_ref)
    for k, v in out.items():
        print(f"{k}: {v}", flush=True)
    return out

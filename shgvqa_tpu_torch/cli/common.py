"""Driver machinery of the entry points: the port of
``shgvqa_tpu/cli/common.py`` for the AGQA and STAR datasets.

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

STAR passes each question's keyframes to the frame loader, scores the
4-way answer index (BEST on the hg score, ``log.log`` under ``--output``),
and its test protocol reports ``acc``, ``hg_acc`` and the per-question-type
``by_qtype`` with both predict files.

Task 'q' (``cli/agqa_q.py``) builds the question-only model: no frame
loader, no trunk, no ``--backboneWeights``.

With ``--outputAttn`` the driver writes the reference's attention dumps
(``_dump_attentions``) after ``--test``'s predictions and after training,
from the valid split.

It runs on the card unless the caller passes ``device="cpu"``.  What the
port does not run yet raises ``NotImplementedError`` naming its ROADMAP
item: mesh and multi-host flags and ``--loadLXMERT(QA)``.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
import zlib
from typing import Tuple

import numpy as np
import torch

from shgvqa_tpu_torch.configs.cli import parse_reference_flags_with_extras
from shgvqa_tpu_torch.configs.config import (
    HG_TASKS,
    PER_CHOICE,
    Config,
    check_ported,
)
from shgvqa_tpu_torch.data.agqa import (
    AGQAData,
    AGQAItemSource,
    FrameLoader,
    SyntheticFrameLoader,
)
from shgvqa_tpu_torch.data.pipeline import Batcher, prefetch
from shgvqa_tpu_torch.data.star import STARData, STARItemSource
from shgvqa_tpu_torch.data.tokenization import (
    BertTokenizer,
    build_vocab_from_corpus,
)
from shgvqa_tpu_torch.entry import build_model, resolve_device
from shgvqa_tpu_torch.losses.set_prediction import matched_target_grid
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


def build_data(cfg: Config, extras: dict, split: str):
    """The raw data of a split (synthetic or from files)."""
    n_syn = extras.get("synthetic_data") or 0
    if extras.get("synthetic_valid") and not n_syn:
        raise SystemExit(
            "--syntheticValid requires --syntheticData (it resizes the "
            "synthetic eval splits of a synthetic smoke run; on real data "
            "it would silently swap the valid/test split for synthetic)")
    if split != cfg.data.train_split and extras.get("synthetic_valid"):
        n_syn = extras["synthetic_valid"]
    data_cls = STARData if cfg.data.dataset == "star" else AGQAData
    if n_syn:
        # a stable hash: builtin hash() is randomized per process
        return data_cls.synthetic(cfg, split, n=n_syn,
                                  seed=zlib.crc32(split.encode()) % 1000)
    return data_cls.from_files(cfg, split)


def build_item_source(cfg: Config, extras: dict, data, tokenizer,
                      test_mode: bool = False):
    star = cfg.data.dataset == "star"
    if cfg.task == "q":
        loader = None                   # the question-only model: no frames
    elif extras.get("synthetic_data"):
        loader = SyntheticFrameLoader(cfg.data.clip_len, cfg.data.image_size)
        if star:
            base = loader
            loader = lambda vid, fids=None: base(vid)  # noqa: E731
    elif extras.get("frame_loader") == "native":
        raise NotImplementedError(
            "--frameLoader native (the C++ PNG decoder) is not ported yet "
            "(ROADMAP queue A item 13); the port decodes with PIL")
    else:
        # STAR passes each question's keyframes (star_data:199-205)
        loader = FrameLoader(cfg.data.frame_dir, {} if star else
                             data.frame_ids, cfg.data.clip_len,
                             cfg.data.image_size)
    if star:
        return STARItemSource(data, tokenizer, cfg, loader, test_mode)
    return AGQAItemSource(data, tokenizer, cfg, loader, test_mode)


def resolve_num_answers(cfg: Config, data) -> Config:
    return cfg.replace(num_answers=data.num_answers)


def _check_driver_flags(cfg: Config, extras: dict, dataset: str) -> None:
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
    if dataset != "star" and cfg.data.qa_arrange_type in PER_CHOICE:
        # AGQA items carry no choices; the JAX driver would train the
        # plain head under a mask that freezes it (ROADMAP C)
        raise ValueError(
            f"--qaArrangeType {cfg.data.qa_arrange_type} is STAR's "
            "per-choice QA: the AGQA drivers take add_sep_all or no_sep_all")
    check_ported(cfg, video=True, train=not cfg.data.test_split)


def load_pretrained_weights(trainer: Trainer, cfg: Config,
                            extras: dict) -> None:
    """The pretrained files the JAX driver loads before ``--load``: the
    trunk (not for task 'q', which has none), then bert-base unless
    ``--fromScratch``; a missing file is reported as the JAX driver
    reports it."""
    if cfg.task != "q":
        bbw = extras.get("backbone_weights") or os.path.join(
            cfg.data.data_dir, f"{cfg.backbone}_flax.msgpack")
        if os.path.isfile(bbw):
            trainer.load_backbone(bbw)
        else:
            print(f"no pretrained backbone at {bbw}; backbone stays at "
                  "random init (convert via tools/convert_slow_r50.py)",
                  flush=True)
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
        if cfg.output_attention:
            results["attention_dumps"] = _dump_attentions(cfg, trainer,
                                                          batcher, dev)
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
    # the optimizer skips what the loss does not reach (e.g. the LXRT
    # x-layers and pooler under hgqa) and what the freeze options freeze
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
        if cfg.data.dataset == "star":
            return evaluator.evaluate(q2a), evaluator.evaluate(hg_q2a)
        return (evaluator.evaluate_overall(q2a),
                evaluator.evaluate_overall(hg_q2a))

    summary = trainer.train(
        lambda ep: prefetch(train_batcher.epoch(ep), device=dev),
        evaluate if valid_batcher is not None else None,
    )
    results.update(summary)
    if cfg.output_attention and valid_batcher is not None:
        # the reference dumps its attention files from predict() on the
        # valid split (star.py:540-547)
        results["attention_dumps"] = _dump_attentions(cfg, trainer,
                                                      valid_batcher, dev)
    return results


def report_test(cfg: Config, data, q2a, hg_q2a) -> dict:
    """The AGQA test-protocol fan-out (STAR: the answer and hg accuracy and
    the hg per-question-type breakdown) and the prediction dumps."""
    out = {}
    ev = data.evaluator()
    os.makedirs(cfg.output, exist_ok=True)
    if cfg.data.dataset == "star":
        out["acc"] = ev.evaluate(q2a)
        out["hg_acc"] = ev.evaluate(hg_q2a)
        out["by_qtype"] = ev.evaluate_by_qtype(hg_q2a)
        ev.dump_result(q2a, os.path.join(cfg.output, "predict.json"))
        ev.dump_result(hg_q2a, os.path.join(cfg.output, "predict_hg.json"))
        for k, v in out.items():
            print(f"{k}: {v}", flush=True)
        return out
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


# which cross-stream attention the reference dumps per variant
# (agqaHGQA.py:35-40 attn_idx: 2 = lang->visn cross, 4 = joint self)
_ATTN_STREAM = {"cross": "xl", "old": "xl", "self": "vl", "cross_self": "vl"}


def _host(x) -> np.ndarray:
    """A tensor as a numpy array on the host, bf16 widened to f32."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def _savez(path: str, **arrays) -> None:
    """``np.savez_compressed``'s file (a deflated zip of ``<key>.npy``
    members, ``np.load`` reads it) at deflate level 1: a dumps batch holds
    ~0.3-1.2 GB of f32 maps, which zlib's default level 6 takes minutes
    to write and hardly shrinks more."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as z:
        for key, value in arrays.items():
            with z.open(f"{key}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value),
                                          allow_pickle=False)


def _flatten_attentions(attn) -> dict:
    """The attentions tree as the npz's flat ``attn.<key>.<index>`` map."""
    flat = {}

    def add(prefix, obj):
        if obj is None:
            return
        if isinstance(obj, dict):
            for k, v in obj.items():
                add(f"{prefix}.{k}", v)
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                add(f"{prefix}.{i}", v)
        else:
            flat[prefix] = _host(obj)

    add("attn", attn)
    return flat


def _dump_attentions(cfg: Config, trainer: Trainer, batcher: Batcher,
                     device, max_batches: int = 4) -> dict:
    """``--outputAttn``: the reference's per-question attention dumps from
    predict, the port of the JAX ``_dump_attentions``:
    ``{output}/val_attentions_cross_2.json`` (the answer head's entries,
    with the Hungarian-matched rel/act grids where the batch has labels)
    and ``{output}/hg_val_attentions_cross_2.json`` (the hg head's), plus
    every map of the forward in ``{output}/attentions/batchNNN.npz``, for
    the first ``max_batches`` batches.

    Per question the "attention" is the CLS-query row of the LAST HG
    cross step's stream of ``_ATTN_STREAM``, over heads.  The forward runs
    every attention on the plain path (the kernels return no
    probabilities); the FFN kernel and, for the global grids, the matcher
    kernel run as they are set.  Maps in bf16 are written as f32, the npz
    at deflate level 1 (``_savez``).

    Two departures from the JAX driver (ROADMAP C): under per-choice QA
    the HG cross encoder has B x C rows, and question i dumps row
    ``i * C + c`` of the choice c its file's head answered, where JAX
    takes row i (another clip's row); a model without ``hg_logit``
    ('q', 'vqa') dumps its ``logit`` answers in the hg file, where JAX
    raises ``KeyError``.  Returns {"questions", "batches", "seconds"}."""
    start = time.perf_counter()
    model = trainer.model
    has_hg_labels = cfg.task in HG_TASKS and not cfg.gt_hg
    per_choice = cfg.task != "q" and cfg.data.qa_arrange_type in PER_CHOICE
    out_dir = os.path.join(cfg.output, "attentions")
    os.makedirs(out_dir, exist_ok=True)
    stream = _ATTN_STREAM[cfg.encoder.cross_attn_type]
    results, hg_results = [], []
    model.eval()
    n_batches = 0
    for bi, batch in enumerate(prefetch(batcher.epoch(0), device=device)):
        if bi >= max_batches:
            break
        n_batches += 1
        batch = dict(batch)
        qids = batch.pop("ques_id")
        n_valid = batch.pop("n_valid", len(qids))
        with torch.inference_mode():
            out = model(batch, output_attentions=True)
            if has_hg_labels and "rel_preds" in out and "rel_labels" in batch:
                # get_target_classes grids (agqaHGQA.py:548-559)
                for kind in ("rel", "act"):
                    out[f"{kind}_grid"] = matched_target_grid(
                        out[f"{kind}_preds"], batch[f"{kind}_labels"],
                        batch[f"{kind}_lengths"],
                        per_frame=cfg.loss_hg_per_frame,
                        num_situations=cfg.data.num_situations)
        attn = out.get("attentions", {})
        hgq_layers = attn.get("hgq") or []
        cls_rows = None
        if hgq_layers and hgq_layers[-1].get(stream) is not None:
            # (rows, H, Lq, Lk) -> the CLS query's row over heads
            cls_rows = _host(hgq_layers[-1][stream][:, :, 0, :])
        host = {k: _host(out[k]) for k in ("logit", "hg_logit", "rel_grid",
                                            "act_grid") if k in out}
        label = host["logit"].argmax(-1)
        hg_label = host.get("hg_logit", host["logit"]).argmax(-1)
        # per choice the HG encoder's rows are (clip, choice)
        stride = 1 if cls_rows is None else cls_rows.shape[0] // len(qids)

        def row(i, choice):
            if cls_rows is None:
                return []
            return cls_rows[i * stride + (choice if per_choice else 0)
                            ].tolist()

        for i, qid in enumerate(qids[:n_valid]):
            entry = {"questionId": qid, "prediction": int(label[i]),
                     "attention": row(i, int(label[i]))}
            if "rel_grid" in host:
                entry["act_gt"] = _host(batch["act_labels"][i]).tolist()
                entry["act_pred"] = host["act_grid"][i].tolist()
                entry["rel_gt"] = _host(batch["rel_labels"][i]).tolist()
                entry["rel_pred"] = host["rel_grid"][i].tolist()
            results.append(entry)
            hg_results.append({"questionId": qid,
                               "prediction": int(hg_label[i]),
                               "attention": row(i, int(hg_label[i]))})
        flat = _flatten_attentions(attn)
        if flat:
            _savez(os.path.join(out_dir, f"batch{bi:03d}.npz"),
                   ques_ids=np.asarray(qids), **flat)
    for name, payload in (("val_attentions_cross_2.json", results),
                          ("hg_val_attentions_cross_2.json", hg_results)):
        with open(os.path.join(cfg.output, name), "w") as f:
            json.dump(payload, f)
    print(f"attention dumps written to {cfg.output} "
          f"({len(results)} questions; npz maps in {out_dir})", flush=True)
    return {"questions": len(results), "batches": n_batches,
            "seconds": time.perf_counter() - start}

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
``{dataDir}/pytorch_model.bin``), then ``--loadLXMERT`` (an encoder
snapshot, ``Trainer.load_encoder``), then ``--loadLXMERTQA`` (a
pretraining snapshot and its QA head into ``logit_fc`` by answer string,
the labels from the train split's answer vocabulary,
``Trainer.load_lxmert_qa``), then ``--load``; a missing pretrained
file is reported and the run goes on at random init, as the JAX driver
does.  ``--test`` loads only ``--load``.  ``--load`` reads the port's own
checkpoints and reference ``.pth`` snapshots (``path/BEST`` with
``BEST.pth`` beside it).

``--quantBackbone int8``: once the trunk's weights are final, a trunk
whose scales no load carried is calibrated (``calibrate_quant``) on the
first batch of the train split's epoch 0, the example batch the JAX driver
inits on, or under ``--test`` on the first test batch.  The JAX driver
calibrates at init, before ``--backboneWeights`` loads, so its scales are
the random trunk's (ROADMAP C); the port's are the loaded trunk's.

STAR passes each question's keyframes to the frame loader, scores the
4-way answer index (BEST on the hg score, ``log.log`` under ``--output``),
and its test protocol reports ``acc``, ``hg_acc`` and the per-question-type
``by_qtype`` with both predict files.

Task 'q' (``cli/agqa_q.py``) builds the question-only model: no frame
loader, no trunk, no ``--backboneWeights``.

With ``--outputAttn`` the driver writes the reference's attention dumps
(``_dump_attentions``) after ``--test``'s predictions and after training,
from the valid split.

Data parallelism (``parallel/``), the JAX driver's policy decision for
decision (``build_driver_mesh``): no flag runs one process; ``--multiGPU``
every visible GPU, ``--dataParallel N`` N of them; a train batch the
ranks cannot share is a ``SystemExit``; the eval batch is rounded up to a
multiple of the ranks; a layout larger than the visible devices prints a
message and runs on one.  One process started with ``--multiGPU`` (or
``--dataParallel N``) on N > 1 visible GPUs spawns N ranks on a local
rendezvous and returns rank 0's result; on one visible GPU it runs a
process group of one (the JAX driver runs no mesh there).  Under the
``SHGVQA_COORDINATOR`` / ``SHGVQA_NUM_PROCESSES`` / ``SHGVQA_PROCESS_ID``
variables every process is one rank (across hosts too): the data-parallel
extent must be a multiple of the processes, each rank builds only its rows
of every batch (``Batcher(host_shard=...)``), rank 0 writes the
checkpoints and ranks but 0 log into ``{output}/proc<i>``.  The int8
trunk's scales are calibrated by rank 0 on the global first batch and
broadcast.  ``--test`` scores each rank's rows and merges the maps before
the metrics and the predict files; ``--outputAttn`` dumps are written by
every rank, of its own rows, into its own output directory.

Tensor parallelism (``--modelParallel mp``, with ``--dataParallel dp`` or
``--multiGPU``): dp x mp ranks, rank r at data index r // mp and model
index r % mp (``distributed.set_model_parallel``); each rank builds the
rows of its data index (``host_shard`` = (data index, dp)), the model is
built from the seed as in one process and split by JAX's rules
(``entry.build_model``, ``parallel/mesh.shard_model_``), and the loads run
on the one-process tensors.  The files come from model index 0 of each
data index: rank 0's checkpoints, and each data index's ``--outputAttn``
dumps (the probabilities gathered over the heads).

It runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import socket
import sys
import tempfile
import time
import zipfile
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from shgvqa_tpu_torch.configs.cli import parse_reference_flags_with_extras
from shgvqa_tpu_torch.configs.config import (
    HG_TASKS,
    PER_CHOICE,
    Config,
    MeshConfig,
    check_ported,
)
from shgvqa_tpu_torch.data import native_loader
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
from shgvqa_tpu_torch.parallel import distributed
from shgvqa_tpu_torch.parallel.mesh import Mesh, make_mesh
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
        if distributed.rank() != 0:
            # one writer: rank 0 builds the (identical) vocab; wait for its
            # atomic rename instead of racing it
            for _ in range(600):
                if os.path.isfile(path):
                    break
                time.sleep(0.1)
            else:
                raise SystemExit(
                    f"timed out waiting for process 0 to build {path}")
        else:
            print(f"vocab {path} not found; building whole-word vocab "
                  f"from the split corpus ({len(corpus)} texts)", flush=True)
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


def make_frame_loader(cfg: Config, frame_ids: dict, extras: dict):
    """Real-frame loader, as the JAX driver picks it: ``--frameLoader
    auto`` (the default) takes the native C++ decoder when it builds and
    PIL otherwise, with a notice; ``native`` raises when it does not build;
    ``pil`` forces PIL.  ``--numWorkers`` sizes the decoder's threads."""
    kind = extras.get("frame_loader") or "auto"
    if kind in ("auto", "native"):
        if native_loader.get_lib() is not None:
            return native_loader.NativeFrameLoader(
                cfg.data.frame_dir, frame_ids, cfg.data.clip_len,
                cfg.data.image_size, threads=cfg.data.num_workers)
        if kind == "native":
            raise RuntimeError(
                "--frameLoader native requested but the C++ decoder did "
                "not build (g++/libpng missing?)")
        print("native frame decoder unavailable; using PIL", flush=True)
    return FrameLoader(cfg.data.frame_dir, frame_ids, cfg.data.clip_len,
                       cfg.data.image_size)


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
    else:
        # STAR passes each question's keyframes (star_data:199-205)
        loader = make_frame_loader(cfg, {} if star else data.frame_ids,
                                   extras)
    if star:
        return STARItemSource(data, tokenizer, cfg, loader, test_mode)
    return AGQAItemSource(data, tokenizer, cfg, loader, test_mode)


def resolve_num_answers(cfg: Config, data) -> Config:
    return cfg.replace(num_answers=data.num_answers)


def _check_driver_flags(cfg: Config, extras: dict, dataset: str) -> None:
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
    trunk (not for task 'q', nor under ``--patches``: no trunk), the ViT
    r-layers under ``--vitInit`` (``--vitWeights``, else
    ``{dataDir}/vit_base_patch32_224.bin``, from ``--startIndex``), then
    bert-base unless ``--fromScratch``; a missing file is reported as the
    JAX driver reports it."""
    if cfg.task != "q" and not cfg.encoder.patches:
        bbw = extras.get("backbone_weights") or os.path.join(
            cfg.data.data_dir, f"{cfg.backbone}_flax.msgpack")
        if os.path.isfile(bbw):
            trainer.load_backbone(bbw)
        else:
            print(f"no pretrained backbone at {bbw}; backbone stays at "
                  "random init (convert via tools/convert_slow_r50.py)",
                  flush=True)
    if cfg.task != "q" and cfg.encoder.vit_init:
        vw = extras.get("vit_weights") or os.path.join(
            cfg.data.data_dir, "vit_base_patch32_224.bin")
        if os.path.isfile(vw):
            trainer.load_vit_layers(vw, extras.get("start_index", 7))
        else:
            print(f"no ViT weights at {vw}; --vitInit r_layers stay at "
                  "random init (provide --vitWeights)", flush=True)
    if not cfg.from_scratch:
        bw = extras.get("bert_weights") or os.path.join(
            cfg.data.data_dir, "pytorch_model.bin")
        if os.path.isfile(bw):
            trainer.load_bert_pretrained(bw)
        else:
            print(f"no BERT weights at {bw}; encoder stays at scratch init "
                  "(pass --fromScratch to silence, or fetch per "
                  "tools/fetch_bert_vocab.py notes)", flush=True)


def calibrate_trunk(model, batcher: Batcher, device) -> None:
    """An int8 trunk without scales: calibrate them on the first batch of
    ``batcher``'s epoch 0 (the JAX ``_example_from``).  In a data-parallel
    run data index 0 (each of its model indices: the trunk is replicated)
    calibrates on the global batch and broadcasts the scales over the data
    group, so every rank holds the scales one process computes."""
    trunk = getattr(model, "backbone", None)
    if trunk is None or not trunk.quant or trunk.calibrated:
        return
    if distributed.data_rank() == 0:
        frames = next(batcher.epoch(0, sharded=False))["frames"]
        model.calibrate_quant(torch.from_numpy(frames).to(device))
    distributed.broadcast_module_(trunk)
    trunk.calibrated = True


def build_driver_mesh(cfg: Config, extras: dict, n_devices: int
                      ) -> Tuple[Optional[Mesh], Config]:
    """``--multiGPU`` / ``--dataParallel`` / ``--modelParallel`` over
    ``n_devices`` devices -> (the layout or None, cfg): the JAX
    ``build_driver_mesh``'s decisions.  cfg may change: the eval batch is
    rounded up to a multiple of dp (trailing batches are padded and masked
    by ``n_valid``), and a layout that does not fit the devices resets the
    mesh config."""
    mcfg = cfg.mesh
    requested = (extras.get("multi_gpu") or mcfg.model_parallel > 1
                 or mcfg.data_parallel not in (-1, 1))
    if not requested:
        return None, cfg
    n = n_devices
    mp = max(1, mcfg.model_parallel)
    dp = mcfg.data_parallel if mcfg.data_parallel != -1 else max(1, n // mp)
    if dp * mp > n or dp < 1:
        print(f"requested mesh dp{dp} x mp{mp} needs {dp * mp} device(s) "
              f"but only {n} visible; running single-device", flush=True)
        return None, cfg.replace(mesh=MeshConfig())
    if dp * mp == 1:
        return None, cfg.replace(mesh=MeshConfig())
    if cfg.optim.batch_size % dp:
        raise SystemExit(
            f"--batchSize {cfg.optim.batch_size} is not divisible by the "
            f"data-parallel extent {dp}; pick a multiple (the reference's "
            "DataParallel scatter has the same constraint)")
    mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                     dp * mp)
    ebs = cfg.optim.eval_batch_size
    if ebs % dp:
        new_ebs = distributed.pad_to_multiple(ebs, dp)
        print(f"eval batch {ebs} -> {new_ebs} (rounded up to the dp={dp} "
              "mesh; trailing batches are padded and masked by n_valid)",
              flush=True)
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, eval_batch_size=new_ebs))
    cfg = cfg.replace(mesh=dataclasses.replace(
        cfg.mesh, data_parallel=dp, model_parallel=mp))
    print(f"mesh: dp{dp} x mp{mp} over {dp * mp} devices", flush=True)
    return mesh, cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(index: int, dataset: str, argv, device, address: str,
                  n: int, result_path: str) -> None:
    """One rank of ``spawn_ranks``: the driver under the ``SHGVQA_*``
    variables on GPU ``index``; rank 0 pickles its result to
    ``result_path``."""
    os.environ.update({
        distributed.ENV_COORDINATOR: address,
        distributed.ENV_NUM_PROCESSES: str(n),
        distributed.ENV_PROCESS_ID: str(index),
        distributed.ENV_LOCAL_RANK: str(index)})
    result = run_driver(dataset, argv, device)
    if index == 0:
        with open(result_path, "wb") as f:
            pickle.dump(result, f)


def spawn_ranks(dataset: str, argv, device, n: int) -> dict:
    """``n`` processes, one a GPU, each a rank of one run on a local
    rendezvous; a rank that fails fails the run (its error is raised here,
    the other ranks are stopped).  Returns rank 0's result."""
    import torch.multiprocessing as mp

    print(f"--multiGPU: spawning {n} ranks, one a GPU", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_spawned_rank, args=(
            dataset, argv, device, f"127.0.0.1:{_free_port()}", n,
            result_path), nprocs=n, join=True, start_method="spawn")
        with open(result_path, "rb") as f:
            return pickle.load(f)


def run_driver(dataset: str, argv=None, device="cuda") -> dict:
    """Full train/valid/test orchestration on ``device``; returns a result
    summary.  Starts the ranks of a data-parallel run first (see the
    module's docstring)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg, extras = parse_reference_flags_with_extras(argv, dataset=dataset)
    _check_driver_flags(cfg, extras, dataset)
    dev = resolve_device(device)
    if distributed.maybe_initialize_distributed(device=dev):
        started = True
        if dev.type == "cuda":
            dev = distributed.local_device()
    else:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh, _ = build_driver_mesh(cfg, extras, n)
        if mesh is not None:
            return spawn_ranks(dataset, argv, device, mesh.data * mesh.model)
        # --multiGPU on one device: a process group of one
        started = bool(extras.get("multi_gpu")) and n == 1
        if started:
            distributed.maybe_initialize_distributed(
                f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
    try:
        return _run_rank(dataset, cfg, extras, dev)
    finally:
        if started:
            distributed.shutdown()


def _run_rank(dataset: str, cfg: Config, extras: dict, dev) -> dict:
    """The driver's work in one process: one rank of a data-parallel run
    when a process group runs."""
    name = (f"cuda ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else str(dev))
    world, rank = distributed.world_size(), distributed.rank()
    mesh, cfg = build_driver_mesh(cfg, extras, world)
    if mesh is not None and mesh.model > 1:
        if world != mesh.data * mesh.model:
            raise SystemExit(
                f"mesh dp{mesh.data} x mp{mesh.model} needs "
                f"{mesh.data * mesh.model} processes (one a device), got "
                f"{world}")
        distributed.set_model_parallel(mesh.model)
    print(f"shgvqa_tpu_torch {dataset} driver: task={cfg.task} device={name}"
          + (f" processes={world} ({distributed.backend()})"
             if distributed.is_active() else ""), flush=True)
    results: dict = {"task": cfg.task}
    if distributed.is_active():
        results["process_group"] = {"backend": distributed.backend(),
                                     "world": world, "rank": rank}
    host_shard, checkpoint_dir = None, cfg.output
    if world > 1:
        if mesh is None:
            raise SystemExit(
                "multi-process runs need a data-parallel layout: pass "
                "--multiGPU (or --dataParallel) so the batch shards over "
                "the ranks")
        if cfg.mesh.data_parallel % distributed.data_size():
            raise SystemExit(
                f"data-parallel extent {cfg.mesh.data_parallel} not "
                f"divisible by {world} processes -- the batch rows cannot "
                "be fed in equal per-process shards")
        host_shard = (distributed.data_rank(), distributed.data_size())
        if rank != 0:
            # one writer per artifact: rank 0 writes the checkpoints; the
            # other ranks' logs, metrics and dumps go to their own subdir
            cfg = cfg.replace(output=os.path.join(cfg.output, f"proc{rank}"))
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
                          drop_last=cfg.data.parity_eval,
                          host_shard=host_shard)
        model = build_model(cfg, dev, seed=cfg.seed)
        trainer = Trainer(cfg, steps_per_epoch=max(1, len(batcher)),
                          model=model, checkpoint_dir=checkpoint_dir)
        if cfg.load:
            trainer.load(cfg.load, params_only=True)
        calibrate_trunk(model, batcher, dev)
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
        seed=cfg.seed, host_shard=host_shard)
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
            seed=cfg.seed, drop_last=cfg.data.parity_eval,
            host_shard=host_shard)

    model = build_model(cfg, dev, seed=cfg.seed)
    # the optimizer skips what the loss does not reach (e.g. the LXRT
    # x-layers and pooler under hgqa) and what the freeze options freeze
    trainer = Trainer(cfg, steps_per_epoch=max(1, len(train_batcher)),
                      model=model, trainable_mask=trainable_mask(model, cfg),
                      checkpoint_dir=checkpoint_dir)
    load_pretrained_weights(trainer, cfg, extras)
    if extras.get("load_lxmert"):
        trainer.load_encoder(extras["load_lxmert"])
    if extras.get("load_lxmert_qa"):
        # the reference drivers ship this call commented out; live here,
        # as in the JAX driver
        a2l = getattr(train_data, "answer_vocab", None)
        if a2l is None:
            a2l = train_data.ans2label
        label2ans = {int(v): k for k, v in a2l.items()}
        results["load_lxmert_qa"] = trainer.load_lxmert_qa(
            extras["load_lxmert_qa"], label2ans)
    if cfg.load:
        trainer.load(cfg.load)
    calibrate_trunk(model, train_batcher, dev)

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
    the hg per-question-type breakdown) and the prediction dumps (written
    by model index 0)."""
    out = {}
    ev = data.evaluator()
    os.makedirs(cfg.output, exist_ok=True)
    if cfg.data.dataset == "star":
        out["acc"] = ev.evaluate(q2a)
        out["hg_acc"] = ev.evaluate(hg_q2a)
        out["by_qtype"] = ev.evaluate_by_qtype(hg_q2a)
        if distributed.model_rank() == 0:
            ev.dump_result(q2a, os.path.join(cfg.output, "predict.json"))
            ev.dump_result(hg_q2a, os.path.join(cfg.output,
                                                "predict_hg.json"))
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
    if distributed.model_rank() == 0:
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
    raises ``KeyError``.  Under tensor parallelism every model index runs
    the forward (the probabilities gathered over the heads) and model
    index 0 writes the files.  Returns {"questions", "batches",
    "seconds"}."""
    start = time.perf_counter()
    model = trainer.model
    has_hg_labels = cfg.task in HG_TASKS and not cfg.gt_hg
    per_choice = cfg.task != "q" and cfg.data.qa_arrange_type in PER_CHOICE
    out_dir = os.path.join(cfg.output, "attentions")
    write = distributed.model_rank() == 0
    if write:
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
        if flat and write:
            _savez(os.path.join(out_dir, f"batch{bi:03d}.npz"),
                   ques_ids=np.asarray(qids), **flat)
    for name, payload in (("val_attentions_cross_2.json", results),
                          ("hg_val_attentions_cross_2.json", hg_results)):
        if write:
            with open(os.path.join(cfg.output, name), "w") as f:
                json.dump(payload, f)
    print(f"attention dumps written to {cfg.output} "
          f"({len(results)} questions; npz maps in {out_dir})", flush=True)
    return {"questions": len(results), "batches": n_batches,
            "seconds": time.perf_counter() - start}

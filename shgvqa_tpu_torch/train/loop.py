"""Training and evaluation loops: the port of ``shgvqa_tpu/train/loop.py``
(its single-device, per-tensor path).

- the epoch loop, with early stopping after ``early_stop_patience`` stale
  validations;
- CURRENT saved every epoch, BEST on the hg score for the hg tasks (the
  answer score otherwise), LAST at exit, even on an error;
- loss lines every ``log_freq`` steps to stdout, ``log.log`` and
  ``metrics.jsonl``;
- the optimizer (global-norm clip + BertAdam, or the ``--optim`` stock
  rule) over the trainable parameters, with ``t_total = epochs *
  steps_per_epoch``;
- the weight imports of the JAX ``Trainer``: ``load_backbone`` (a
  converted slow_r50 trunk), ``load_bert_pretrained`` (bert-base into the
  language tower), ``load_vit_layers`` (``--vitInit``: timm ViT-B/32
  blocks into the ViT r-layers), ``load_reference`` (a reference
  ``.pth``, which ``load`` dispatches to), ``load_encoder``
  (``--loadLXMERT``: an encoder snapshot, ``save_encoder``'s or the
  pretraining driver's) and ``load_lxmert_qa`` (``--loadLXMERTQA``: the
  snapshot and the answer-head surgery); each ends by resetting the
  optimizer's state.  An encoder snapshot ``{path}_LXRT`` is the port's
  own ``torch.save`` file of ``{"lxrt" or "bert_encoder": the encoder's
  state_dict}``; a directory there is a JAX (orbax) snapshot and raises.
  None of these files carries the int8 trunk's scales, so each leaves an
  int8 trunk uncalibrated (``models/backbone.SlowR50``); the port's own
  checkpoints carry them, and load into a trunk with or without ``quant``;
- the augmentation's draws and the dropout masks from one
  ``torch.Generator`` on the device, seeded from ``--seed`` at the start
  of ``train`` (the JAX ``PRNGKey(cfg.seed)``): one seed draws the same
  augmentation and masks on two runs.

``--stepsPerLoop k`` (k > 1, BertAdam) trains k steps per launch, as the
JAX flat mode scans them: the batches are gathered k at a time and each
full chunk runs through ``train/graph.StepChunks`` (on a card, one replay
of a k-step CUDA graph after an eager first chunk and one capture); a
trailing partial chunk of an epoch runs as single steps.  A chunk's steps
run the model's augmentation on its fixed-capacity path (the same bits, no
host sync, static shapes); single steps keep the sub-batch path.  Under
``--optim rms|adam|adamax|sgd`` the flag has no effect, as in JAX, where it
needs the flat state that only BertAdam has.  The TPU's flat optimizer state is
not carried over.  A frozen trunk runs without an autograd graph
(``VideoShgVqaModel.encode_frames``), which is what the JAX two-launch
trunk does; a trained one is in the step's autograd graph.

Data parallelism (``parallel/``): every rank runs this same loop on its
rows of the same global batches.  The parameters and buffers are
broadcast from rank 0 when the trainer is made and after every load, so
all ranks start from one state; the step sums the gradients over the ranks
(``train/step.GradientSum``), so the state stays replicated.  Rank 0 writes
the checkpoints into ``checkpoint_dir`` (the shared output; ranks but 0 log
into their own ``cfg.output``), ``predict`` merges the ranks' question-id
maps (``distributed.allgather_object``), and the merged scores make every
rank stop early together.

Tensor parallelism (``parallel/mesh.py``): the model's split modules hold
this rank's shards.  Every weight import but the trunk's (a trunk is never
split) and ``load`` run on the one-process tensors (``mesh.gathered``: the
shards gathered over the model group, the import as in one process, each
rank keeping its shard after),
and ``state_dict`` gathers the parameters and the moments, so a checkpoint
or an encoder snapshot is the one-process file whatever the layout, and
loads into any layout.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import HG_TASKS, Config, check_ported
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.models.pretrain import AnswerTable, answer_head_surgery
from shgvqa_tpu_torch.parallel import distributed
from shgvqa_tpu_torch.parallel.mesh import (
    gather_state_dict,
    gathered,
    shard_of,
    whole_of,
)
from shgvqa_tpu_torch.train.checkpoint import (
    CHECKPOINT_NAMES,
    CheckpointManager,
)
from shgvqa_tpu_torch.train.graph import StepChunks
from shgvqa_tpu_torch.train.metrics import MetricWriter, Profiler
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from shgvqa_tpu_torch.train.step import make_eval_step, make_train_step
from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_restore
from shgvqa_tpu_torch.utils.ref_import import (
    is_reference_checkpoint,
    load_reference_checkpoint,
    reference_to_variables,
)
from shgvqa_tpu_torch.utils.torch_import import (
    bert_to_lxrt_params,
    load_torch_state_dict,
    vit_to_r_layers,
)

ENCODER_KEYS = ("lxrt", "bert_encoder")


def _on_whole_model(method):
    """``method`` of a Trainer run on the one-process tensors of its model
    (``mesh.gathered``)."""

    def run(self, *args, **kwargs):
        with gathered(self.model):
            return method(self, *args, **kwargs)

    run.__name__, run.__doc__ = method.__name__, method.__doc__
    return run


def save_encoder_snapshot(path: str, key: str, encoder: nn.Module) -> None:
    """``{key: encoder.state_dict()}`` to ``path`` by ``torch.save``,
    through a temporary name (a reader never sees a partial file)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({key: encoder.state_dict()}, tmp)
    os.replace(tmp, path)


def _walk(dst: dict, src: dict, prefix: str, stats: dict) -> None:
    """The JAX ``load_encoder``'s name-matched partial load of the JAX tree
    ``src`` into ``dst``, with its report."""
    for key, sval in src.items():
        name = f"{prefix}/{key}"
        if not isinstance(dst, dict) or key not in dst:
            stats["unexpected"].append(name)
        elif isinstance(sval, dict):
            _walk(dst[key], sval, name, stats)
        elif getattr(dst[key], "shape", None) != getattr(sval, "shape",
                                                           None):
            stats["shape_mismatch"].append(
                f"{name} {getattr(sval, 'shape', None)}->"
                f"{getattr(dst[key], 'shape', None)}")
        else:
            dst[key] = sval
            stats["loaded"] += 1

class Trainer:
    """Trains and evaluates ``model`` (already on its device) under
    ``cfg``; ``trainable_mask`` (parameter name -> bool, all when None)
    picks the parameters the optimizer updates; the checkpoints live in
    ``checkpoint_dir`` (``cfg.output`` when None)."""

    def __init__(self, cfg: Config, steps_per_epoch: int, model: nn.Module,
                 trainable_mask: Optional[Dict[str, bool]] = None,
                 checkpoint_dir: Optional[str] = None):
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        o = cfg.optim
        self.optimizer = make_optimizer(
            model, o.lr, int(steps_per_epoch * o.epochs), o.warmup,
            o.schedule, o.b1, o.b2, o.eps, o.weight_decay, o.grad_clip,
            trainable_mask, o.optim)
        self.step = 0
        self.chunks: Optional[StepChunks] = None
        self.ckpt = CheckpointManager(checkpoint_dir or cfg.output)
        distributed.broadcast_module_(model)
        self.metrics = MetricWriter(cfg.output)
        self.profiler = Profiler(cfg.output, enabled=cfg.profile)
        self._train_step = make_train_step(cfg, model, self.optimizer)
        self._eval_step = make_eval_step(cfg, model)
        self._eval_step_hg = make_eval_step(cfg, model, with_hg_metrics=True)

    # -- training ---------------------------------------------------------
    def train(
        self,
        train_batches: Callable[[int], Iterable[Dict[str, Any]]],
        evaluate: Optional[Callable[["Trainer"], Tuple[float, float]]] = None,
        log: Optional[Callable[[str], None]] = None,
    ) -> Dict[str, Any]:
        """train_batches(epoch) yields batch dicts (tensors on the device
        plus 'ques_id' and 'n_valid', dropped here).  evaluate(self) ->
        (valid_score, hg_score)."""
        cfg = self.cfg
        check_ported(cfg, train=True)
        if log is None:
            log = self.metrics.log
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        k = self._steps_per_launch(log)
        self.chunks = (StepChunks(self.model, self._train_step,
                                  self.optimizer, generator, k)
                       if k > 1 else None)
        best = 0.0
        stale = 0
        history = []
        try:
            for epoch in range(cfg.optim.epochs):
                if (evaluate is not None
                        and stale >= cfg.optim.early_stop_patience):
                    log(f"Early stopping at epoch {epoch} "
                        f"(no improvement for {stale} validations)")
                    break
                t0 = time.time()
                first = self.step

                def log_step(metrics, row=None):
                    if self.step % cfg.log_freq == 0:
                        m = {name: float(v.detach() if row is None else v[row])
                             for name, v in metrics.items()
                             if name != "grad_norm"}
                        parts = " ".join(f"{name}={v:0.4f}"
                                         for name, v in m.items())
                        log(f"Epoch {epoch} step {self.step}: {parts}")
                        self.metrics.write(self.step, m, epoch=epoch)
                    self.profiler.step(self.step)
                    self.step += 1

                chunk = []
                for batch in train_batches(epoch):
                    batch = dict(batch)
                    batch.pop("ques_id", None)
                    batch.pop("n_valid", None)
                    if self.chunks is None:
                        log_step(self._train_step(batch, generator))
                        continue
                    chunk.append(batch)
                    if len(chunk) == k:
                        metrics = self.chunks.run(chunk)
                        for row in range(k):
                            log_step(metrics, row)
                        chunk = []
                # a trailing partial chunk: single steps
                for batch in chunk:
                    log_step(self._train_step(batch, generator))
                n_steps = self.step - first
                dt = time.time() - t0
                log(f"Epoch {epoch}: {n_steps} steps in {dt:0.1f}s")
                self.ckpt.save("CURRENT", self.state_dict())

                if evaluate is not None:
                    valid_score, hg_score = evaluate(self)
                    key_score = (hg_score if cfg.task in HG_TASKS
                                 else valid_score)
                    log(f"Epoch {epoch}: valid {valid_score*100:0.2f} "
                        f"hg {hg_score*100:0.2f} best {best*100:0.2f}")
                    if key_score > best:
                        best = key_score
                        self.ckpt.save("BEST", self.state_dict())
                        stale = 0
                    else:
                        stale += 1
                    history.append(
                        {"epoch": epoch, "valid": valid_score, "hg": hg_score})
        finally:
            self.profiler.close()
            self.ckpt.save("LAST", self.state_dict())
        return {"best": best, "history": history, "steps": self.step}

    def _steps_per_launch(self, log: Callable[[str], None]) -> int:
        """k of ``--stepsPerLoop``: 1 unless the optimizer is BertAdam."""
        k = self.cfg.steps_per_loop
        if k < 1:
            raise ValueError(f"--stepsPerLoop must be >= 1, got {k}")
        if k > 1 and self.optimizer.name != "bert":
            log(f"--stepsPerLoop {k} has no effect with --optim "
                f"{self.optimizer.name} (it chunks BertAdam steps only, as "
                "the JAX flat mode); training single steps")
            return 1
        return k

    # -- evaluation -------------------------------------------------------
    def predict(self, batches: Iterable[Dict[str, Any]],
                return_hg_metrics: bool = False):
        """Returns (quesid2ans from logit, quesid2ans from hg_logit); with
        ``return_hg_metrics`` also the Hungarian-matched rel/act class
        accuracy from the same forward (mean over batches, pad rows
        included, as in JAX), or None when the batches carry no HG labels.
        Pad rows (past ``n_valid``) get no answer.  The answers come back
        to the host once, after every batch was enqueued.  In a
        data-parallel run each rank scores its rows and the maps are merged
        over the ranks; the class accuracy is already the global batch's
        (``losses/set_prediction.py``)."""
        eval_fn = self._eval_step_hg if return_hg_metrics else self._eval_step
        pending = []
        for batch in batches:
            batch = dict(batch)
            ques_ids = batch.pop("ques_id")
            n_valid = batch.pop("n_valid", len(ques_ids))
            pending.append((ques_ids, n_valid, eval_fn(batch)))

        quesid2ans: Dict[str, int] = {}
        hg_quesid2ans: Dict[str, int] = {}
        hg_acc = None
        if pending and return_hg_metrics and "rel_class_acc" in pending[0][2]:
            acc = torch.stack([torch.stack((p["rel_class_acc"],
                                            p["act_class_acc"]))
                               for _, _, p in pending]).float().cpu()
            hg_acc = {"rel_class_acc": float(acc[:, 0].mean()),
                      "act_class_acc": float(acc[:, 1].mean())}
        if pending:
            answers = torch.cat([p["answer"] for _, _, p in pending]).cpu()
            hg_answers = torch.cat([p.get("hg_answer", p["answer"])
                                    for _, _, p in pending]).cpu()
            offset = 0
            for ques_ids, n_valid, preds in pending:
                for i, qid in enumerate(ques_ids[:n_valid]):
                    quesid2ans[qid] = int(answers[offset + i])
                    hg_quesid2ans[qid] = int(hg_answers[offset + i])
                offset += int(preds["answer"].shape[0])
        if distributed.world_size() > 1:
            # each rank scored its rows: merge the maps over the ranks
            for part, hg_part in distributed.allgather_object(
                    (quesid2ans, hg_quesid2ans)):
                quesid2ans.update(part)
                hg_quesid2ans.update(hg_part)
        if return_hg_metrics:
            return quesid2ans, hg_quesid2ans, hg_acc
        return quesid2ans, hg_quesid2ans

    # -- weight imports ---------------------------------------------------
    def _head(self) -> nn.Module:
        """The task model: a video model's ``head``, or the model itself
        (task 'q' has no trunk)."""
        return getattr(self.model, "head", self.model)

    def _reset_opt(self) -> None:
        """Zero the optimizer's state and its step count: after a weight
        import, as the JAX ``_reset_opt`` rebuilds it (the reference never
        checkpoints its moments).  In a data-parallel run rank 0's
        parameters and buffers are broadcast first: every rank holds the
        imported weights."""
        distributed.broadcast_module_(self.model)
        with torch.no_grad():
            for t in self.optimizer.m + self.optimizer.v:
                t.zero_()
        self.optimizer.step_count = 0

    def load_backbone(self, path: str) -> None:
        """Converted pretrained trunk weights (parameters and BatchNorm
        statistics) from a trunk file (``utils/convert_slow_r50``,
        ``convert_slowfast``, ``convert_resnext101``, ``convert_mvit``,
        ``convert_video_swin``, or the JAX tools).  Loaded with
        ``load_state_dict(strict=True)`` on the trunk: a file of another
        topology or width raises here, where the JAX package swaps the
        subtree in and fails only when the model runs."""
        trunk = getattr(self.model, "backbone", None)
        if trunk is None:
            raise ValueError("model has no backbone (task 'q')")
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        state = from_jax_variables(tree, trunk)
        trunk.load_state_dict(state, strict=True)
        self.metrics.log(f"Loaded pretrained backbone from {path} "
                         f"({len(state)} tensors incl. BN stats)")
        self._reset_opt()

    @_on_whole_model
    def load_bert_pretrained(self, path: str) -> None:
        """No ``--fromScratch``: bert-base weights into the language tower
        (embeddings, l-layers; the pooler where it has a ``dense``) of the
        encoder (``lxrt``, or task 'q''s ``bert_encoder``), by the
        reference's name-matched partial load."""
        sd = load_torch_state_dict(path)
        head = self._head()
        key = "lxrt" if hasattr(head, "lxrt") else "bert_encoder"
        enc = getattr(head, key)
        params, report = bert_to_lxrt_params(
            sd, to_jax_variables(enc.state_dict())["params"])
        enc.load_state_dict(from_jax_variables({"params": params}, enc),
                            strict=True)
        self.metrics.log(
            f"Loaded BERT pretrained weights from {path} into '{key}': "
            f"{len(report['loaded'])} tensors"
            + (f"; skipped {len(report['skipped'])}"
               if report["skipped"] else ""))
        self._reset_opt()

    @_on_whole_model
    def load_vit_layers(self, path: str, start_index: int = 7) -> None:
        """``--vitInit``: the visual stream's ViT r-layers from a timm
        ViT-B/32 state_dict's ``blocks[start_index:start_index + r]``
        (``utils/torch_import.vit_to_r_layers``).  Raises unless the model
        was built with ``encoder.vit_init`` (its r-layers ViT blocks)."""
        head = self._head()
        if not hasattr(head, "lxrt"):
            raise ValueError("model has no visual stream (task 'q')")
        enc = head.lxrt.encoder
        n = len(enc.r_names)
        if n == 0:
            raise ValueError("model has no r_layers to initialize")
        if not hasattr(getattr(enc, enc.r_names[0]), "qkv"):
            raise ValueError(
                "r_layers are BertLayers, not ViT blocks: build the model "
                "with encoder.vit_init=True (--vitInit) before loading")
        sub = vit_to_r_layers(load_torch_state_dict(path), n, start_index)
        for name, tree in sub.items():
            block = getattr(enc, name)
            block.load_state_dict(
                from_jax_variables({"params": tree}, block), strict=True)
        self.metrics.log(
            f"Loaded {n} ViT blocks [{start_index}:{start_index + n}] "
            f"from {path} into 'lxrt/encoder/r_*'")
        self._reset_opt()

    def _encoder(self) -> Tuple[str, nn.Module]:
        """(key, module) of the encoder: ``lxrt``, or task 'q''s
        ``bert_encoder``."""
        head = self._head()
        for key in ENCODER_KEYS:
            if hasattr(head, key):
                return key, getattr(head, key)
        raise ValueError("no encoder (lxrt/bert_encoder) in the model")

    def _snapshot_path(self, path: str) -> str:
        """The JAX rules: ``_LXRT`` appended unless there, a relative path
        under the checkpoint directory."""
        full = path if path.endswith("_LXRT") else path + "_LXRT"
        return full if os.path.isabs(full) else self.ckpt.path(full)

    @_on_whole_model
    def save_encoder(self, path: str) -> None:
        """Save only the encoder (``lxrt`` / ``bert_encoder``) as
        ``{path}_LXRT`` (the reference's '%s_LXRT.pth' snapshots)."""
        key, enc = self._encoder()
        if distributed.rank() == 0:
            save_encoder_snapshot(self._snapshot_path(path), key, enc)
        distributed.barrier()

    @_on_whole_model
    def load_encoder(self, path: str) -> dict:
        """``--loadLXMERT``: the encoder weights of a snapshot into the
        model by name, the heads and decoders left as they are, as JAX's
        ``load_encoder``: the walk runs on the JAX layout of both trees, so
        its report (tensors loaded, names not in the model, shape
        mismatches) is JAX's.  Returns the report."""
        full = self._snapshot_path(path)
        if os.path.isdir(full):
            raise NotImplementedError(
                f"{full} is a directory: a JAX (orbax) encoder snapshot, "
                "which the port does not read; the port's snapshots are "
                "torch.save files (Trainer.save_encoder, "
                "shgvqa_tpu_torch.cli.pretrain)")
        restored = torch.load(full, map_location="cpu", weights_only=True)
        own_key, enc = self._encoder()
        own = to_jax_variables(enc.state_dict())["params"]
        stats = {"loaded": 0, "unexpected": [], "shape_mismatch": []}
        for key, state in restored.items():
            if key == own_key and isinstance(state, dict):
                _walk(own, to_jax_variables(state)["params"], key, stats)
            else:
                stats["unexpected"].append(key)
        enc.load_state_dict(from_jax_variables({"params": own}, enc),
                            strict=True)
        msg = (f"Loaded encoder snapshot from {full}: "
               f"{stats['loaded']} tensors")
        if stats["unexpected"]:
            msg += (f"; not in model ({len(stats['unexpected'])}): "
                    f"{stats['unexpected'][:8]}")
        if stats["shape_mismatch"]:
            msg += (f"; shape mismatch ({len(stats['shape_mismatch'])}): "
                    f"{stats['shape_mismatch'][:8]}")
        self.metrics.log(msg)
        # the moments restart (the reference never checkpoints them)
        self._reset_opt()
        return stats

    @_on_whole_model
    def load_lxmert_qa(self, path: str, label2ans) -> Tuple[int, int]:
        """``--loadLXMERTQA``: ``load_encoder``, then the answer head's last
        layer (``logit_fc.fc2``) from ``{base}_qa_head.npz`` (``weight``
        (n, d), ``bias``, ``answers``, as the JAX driver writes it) by answer
        string (``answer_head_surgery``): labels whose answer was not
        pretrained get zeroed rows.  A model without ``logit_fc.fc2`` (the
        per-choice heads) raises ``KeyError``, as JAX's tree lookup does.
        Returns (loaded, zeroed)."""
        head = getattr(getattr(self._head(), "logit_fc", None), "fc2", None)
        if head is None:
            raise KeyError("logit_fc/fc2: the model has no answer head to "
                           "initialize from a pretraining QA head")
        self.load_encoder(path)
        base = path[:-len("_LXRT")] if path.endswith("_LXRT") else path
        with np.load(base + "_qa_head.npz") as qa:
            weight, bias = qa["weight"], qa["bias"]
            table = AnswerTable([str(a) for a in qa["answers"]])
        new_w, new_b, loaded, unloaded = answer_head_surgery(
            weight, bias, head.weight.detach().cpu().numpy(),
            head.bias.detach().cpu().numpy(), label2ans, table)
        with torch.no_grad():
            head.weight.copy_(torch.from_numpy(new_w))
            head.bias.copy_(torch.from_numpy(new_b))
        self.metrics.log(
            f"load_lxmert_qa: {loaded} answers initialized from "
            f"pretraining, {unloaded} zeroed")
        self._reset_opt()
        return loaded, unloaded

    @_on_whole_model
    def load_reference(self, path: str) -> None:
        """``--load`` of a reference ``.pth`` (or ``path/BEST`` with
        ``BEST.pth`` beside it): a trained AGQAModel state_dict mapped onto
        every parameter and statistic; the optimizer restarts."""
        t0 = time.perf_counter()
        sd = load_reference_checkpoint(path)
        # the head's config: its token count follows from the trunk
        # the reference carries no int8 scales: the trunk's are not kept
        template = to_jax_variables(self.model.state_dict())
        template.pop("quant_stats", None)
        variables, report = reference_to_variables(sd, template,
                                                   self._head().cfg)
        state = from_jax_variables(variables, self.model)
        t1 = time.perf_counter()
        self.model.load_state_dict(state, strict=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.metrics.log(
            f"Imported reference checkpoint {path}: "
            f"{len(report['mapped'])} tensors in {t1 - t0:.2f} s on the "
            f"host, {t2 - t1:.2f} s to {self.device.type}"
            + (f"; skipped {report['skipped']}" if report["skipped"] else ""))
        self._reset_opt()

    # -- state ------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The one-process state: split parameters and their moments
        gathered (a collective under tensor parallelism: every rank
        calls it)."""
        opt = self.optimizer

        def whole(moments):
            return [m if getattr(p, "tp_split", None) is None
                    else whole_of(m, p.tp_split)
                    for p, m in zip(opt.params, moments)]

        return {
            "params": gather_state_dict(self.model),
            "opt_state": {"name": opt.name, "m": whole(opt.m),
                          "v": whole(opt.v), "step_count": opt.step_count},
            "step": self.step,
        }

    def load(self, name_or_path: str, params_only: bool = False) -> None:
        """Restore one of this trainer's checkpoints (CURRENT/BEST/LAST or a
        path to one): the parameters, the step count and, unless
        ``params_only``, the optimizer's state and step.  A reference
        ``.pth`` (``path.pth``, or ``path`` with only ``path.pth`` beside
        it) goes to ``load_reference``."""
        if (name_or_path not in CHECKPOINT_NAMES
                and is_reference_checkpoint(name_or_path)):
            self.load_reference(name_or_path)
            return
        state = self.ckpt.restore(name_or_path, map_location=self.device)
        with gathered(self.model):
            self.model.load_state_dict(state["params"], strict=True)
        distributed.broadcast_module_(self.model)
        self.step = int(state["step"])
        if params_only:
            return
        opt, saved = self.optimizer, state["opt_state"]
        name = saved.get("name", "bert")
        if (name, len(saved["m"]), len(saved["v"])) != (
                opt.name, len(opt.m), len(opt.v)):
            raise ValueError(
                f"{name_or_path}: the checkpoint's optimizer is {name} over "
                f"{len(saved['m'])} + {len(saved['v'])} tensors, this "
                f"trainer's {opt.name} over {len(opt.m)} + {len(opt.v)}")
        index, count = distributed.model_rank(), distributed.model_size()
        with torch.no_grad():
            for p, dst, src in zip(opt.params * 2, opt.m + opt.v,
                                   saved["m"] + saved["v"]):
                split = getattr(p, "tp_split", None)
                dst.copy_(src if split is None
                          else shard_of(src, split, index, count))
        opt.step_count = int(saved["step_count"])

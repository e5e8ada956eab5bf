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
  language tower) and ``load_reference`` (a reference ``.pth``, which
  ``load`` dispatches to); each ends by resetting the optimizer's state.
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
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import HG_TASKS, Config, check_ported
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
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
)

class Trainer:
    """Trains and evaluates ``model`` (already on its device) under
    ``cfg``; ``trainable_mask`` (parameter name -> bool, all when None)
    picks the parameters the optimizer updates."""

    def __init__(self, cfg: Config, steps_per_epoch: int, model: nn.Module,
                 trainable_mask: Optional[Dict[str, bool]] = None):
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
        self.ckpt = CheckpointManager(cfg.output)
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
        to the host once, after every batch was enqueued."""
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
        checkpoints its moments)."""
        with torch.no_grad():
            for t in self.optimizer.m + self.optimizer.v:
                t.zero_()
        self.optimizer.step_count = 0

    def load_backbone(self, path: str) -> None:
        """Converted pretrained trunk weights (parameters and BatchNorm
        statistics) from a ``convert_slow_r50`` msgpack.  Loaded with
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
        opt = self.optimizer
        return {
            "params": self.model.state_dict(),
            "opt_state": {"name": opt.name, "m": list(opt.m),
                          "v": list(opt.v), "step_count": opt.step_count},
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
        self.model.load_state_dict(state["params"], strict=True)
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
        with torch.no_grad():
            for dst, src in zip(opt.m + opt.v, saved["m"] + saved["v"]):
                dst.copy_(src)
        opt.step_count = int(saved["step_count"])

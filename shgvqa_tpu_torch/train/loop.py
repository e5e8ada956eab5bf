"""Training and evaluation loops: the port of ``shgvqa_tpu/train/loop.py``
(its single-device, per-tensor path).

- the epoch loop, with early stopping after ``early_stop_patience`` stale
  validations;
- CURRENT saved every epoch, BEST on the hg score for the hg tasks (the
  answer score otherwise), LAST at exit, even on an error;
- loss lines every ``log_freq`` steps to stdout, ``log.log`` and
  ``metrics.jsonl``;
- the optimizer (global-norm clip + BertAdam) over the trainable
  parameters, with ``t_total = epochs * steps_per_epoch``;
- the augmentation's draws and the dropout masks from one
  ``torch.Generator`` on the device, seeded from ``--seed`` at the start
  of ``train`` (the JAX ``PRNGKey(cfg.seed)``): one seed draws the same
  augmentation and masks on two runs.

The TPU's flat optimizer state and ``--stepsPerLoop`` are not carried over
(``check_ported`` raises for them).  A frozen trunk runs without a graph
(``VideoShgVqaModel.encode_frames``), which is what the JAX two-launch
trunk does; a trained one is in the step's graph.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import Config, check_ported
from shgvqa_tpu_torch.train.checkpoint import CheckpointManager
from shgvqa_tpu_torch.train.metrics import MetricWriter, Profiler
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from shgvqa_tpu_torch.train.step import make_eval_step, make_train_step

HG_TASKS = ("hgqa", "vhga", "hgvqa")


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
                n_steps = 0
                for batch in train_batches(epoch):
                    batch = dict(batch)
                    batch.pop("ques_id", None)
                    batch.pop("n_valid", None)
                    metrics = self._train_step(batch, generator)
                    if self.step % cfg.log_freq == 0:
                        m = {k: float(v.detach()) for k, v in metrics.items()
                             if k != "grad_norm"}
                        parts = " ".join(f"{k}={v:0.4f}" for k, v in m.items())
                        log(f"Epoch {epoch} step {self.step}: {parts}")
                        self.metrics.write(self.step, m, epoch=epoch)
                    self.profiler.step(self.step)
                    self.step += 1
                    n_steps += 1
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

    # -- state ------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        opt = self.optimizer
        return {
            "params": self.model.state_dict(),
            "opt_state": {"m": list(opt.m), "v": list(opt.v),
                          "step_count": opt.step_count},
            "step": self.step,
        }

    def load(self, name_or_path: str, params_only: bool = False) -> None:
        """Restore one of this trainer's checkpoints (CURRENT/BEST/LAST or a
        path to one): the parameters, the step count and, unless
        ``params_only``, the optimizer moments and step."""
        state = self.ckpt.restore(name_or_path, map_location=self.device)
        self.model.load_state_dict(state["params"], strict=True)
        self.step = int(state["step"])
        if params_only:
            return
        opt, saved = self.optimizer, state["opt_state"]
        if len(saved["m"]) != len(opt.m):
            raise ValueError(
                f"{name_or_path}: the checkpoint's optimizer covers "
                f"{len(saved['m'])} tensors, this trainer's {len(opt.m)}")
        with torch.no_grad():
            for dst, src in zip(opt.m + opt.v, saved["m"] + saved["v"]):
                dst.copy_(src)
        opt.step_count = int(saved["step_count"])

"""Train and eval steps: the port of ``shgvqa_tpu/train/step.py``.

Loss composition of task 'hgqa' (the reference's ``agqaHGQA.py``):
bce(hg_logit, target) * num_answers + the relation and action set losses
through the per-frame Hungarian matching.  The plain ``logit`` head gets no
loss; it still trains through the shared ``logit_fc`` of the hg path.
Task 'vqa': bce(logit, target) * num_answers.

A train step is one dropout-bearing forward from uint8 frames (augmented
on the device with an augmenting ``augment_type``; the trunk in the graph,
or without one under ``freeze_backbone``), the matching on the device, the
losses, one backward, the global-norm clip and BertAdam -- all on the
device: the metrics come back as device tensors (the sub-batch
augmentation reads its drawn ops on the host, ``data/transforms.py``;
its fixed-capacity path, which ``train/graph.py`` runs, reads nothing
under a capture; the global matcher's kernel reads nothing either).  The
caller's ``torch.Generator`` takes the place of the JAX step's ``dropout``
and ``augment`` keys.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import Config
from shgvqa_tpu_torch.losses import (
    bce_vqa_loss,
    empty_weight,
    hungarian_set_loss,
)


def _set_losses(cfg: Config, outputs, batch):
    """The relation and action set losses of an hg task."""
    out = {}
    for kind, classes in (("rel", cfg.num_rel_classes),
                          ("act", cfg.num_act_classes)):
        w = empty_weight(classes + 1, cfg.eos_coef,
                         device=outputs[f"{kind}_preds"].device)
        out[kind] = hungarian_set_loss(
            outputs[f"{kind}_preds"], batch[f"{kind}_labels"],
            batch[f"{kind}_lengths"], w, per_frame=cfg.loss_hg_per_frame,
            num_situations=cfg.data.num_situations)
    return out["rel"], out["act"]


def compute_losses(cfg: Config, outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of one forward's outputs."""
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.task == "vqa":
        loss = bce_vqa_loss(outputs["logit"], batch["target"])
        metrics["vqa_loss"] = metrics["total_loss"] = loss
        return loss, metrics
    hgqa_loss = bce_vqa_loss(outputs["hg_logit"], batch["target"])
    metrics["hgqa_loss"] = hgqa_loss
    metrics["hg_train_acc"] = (
        torch.argmax(outputs["hg_logit"], dim=-1)
        == torch.argmax(batch["target"], dim=-1)).float().mean()
    rel, act = _set_losses(cfg, outputs, batch)
    total = hgqa_loss + rel["loss_ce"] + act["loss_ce"]
    metrics["rel_loss"] = rel["loss_ce"]
    metrics["act_loss"] = act["loss_ce"]
    metrics["rel_class_error"] = rel["class_error"]
    metrics["act_class_error"] = act["class_error"]
    metrics["total_loss"] = total
    return total, metrics


def connected_param_mask(model: nn.Module, cfg: Config) -> Dict[str, bool]:
    """Parameter name -> True where the parameter receives gradient from
    the task's loss.  Under 'hgqa' the LXRT cross layers (``x_*``) and
    pooler feed only the unsupervised ``logit``: the reference's
    ``BertAdam.step`` skips them (their grad is None), so they get neither
    update nor weight decay."""

    def connected(name: str) -> bool:
        keys = name.split(".")
        if cfg.task == "hgqa" and "lxrt" in keys:
            rest = keys[keys.index("lxrt") + 1:]
            if rest and rest[0] == "pooler":
                return False
            if len(rest) > 1 and rest[0] == "encoder" \
                    and rest[1].startswith("x_"):
                return False
        return True

    return {n: connected(n) for n, _ in model.named_parameters()}


def trainable_mask(model: nn.Module, cfg: Config) -> Dict[str, bool]:
    """``connected_param_mask`` and, with ``freeze_backbone``, not the
    trunk (as the JAX drivers compose them, ``cli/common.py``).  Without
    it every trunk parameter trains, the BatchNorm ``weight`` and ``bias``
    included; the BatchNorm statistics are buffers, not parameters."""
    mask = connected_param_mask(model, cfg)
    if cfg.freeze_backbone:
        mask = {n: m and "backbone" not in n.split(".")
                for n, m in mask.items()}
    return mask


def make_train_step(cfg: Config, model: nn.Module, optimizer):
    """train_step(batch, generator, lr=None) -> metrics: one forward in
    training mode, the losses, the backward and one optimizer update, in
    place.  ``lr`` (BertAdam only) is the step's learning rate as a device
    scalar (``BertAdam.step``)."""

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator = None,
                   lr: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        outputs = model(batch, generator)
        loss, metrics = compute_losses(cfg, outputs, batch)
        optimizer.zero_grad()
        loss.backward()
        metrics["grad_norm"] = (optimizer.step() if lr is None
                                else optimizer.step(lr))
        return metrics

    return train_step


def make_eval_step(cfg: Config, model: nn.Module,
                   with_hg_metrics: bool = False):
    """eval_step(batch) -> the answer argmaxes; with ``with_hg_metrics`` and
    an hg batch carrying labels, also the matched rel/act class accuracy
    from the same forward."""
    want_hg_acc = with_hg_metrics and cfg.task == "hgqa"

    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            outputs = model(batch)
            preds = {"answer": torch.argmax(outputs["logit"], dim=-1)}
            if "hg_logit" in outputs:
                preds["hg_answer"] = torch.argmax(outputs["hg_logit"], dim=-1)
            if "rel_preds" in outputs:
                preds["rel_top1"] = torch.argmax(outputs["rel_preds"], dim=-1)
                preds["act_top1"] = torch.argmax(outputs["act_preds"], dim=-1)
            if want_hg_acc and "rel_preds" in outputs and "rel_labels" in batch:
                rel, act = _set_losses(cfg, outputs, batch)
                preds["rel_class_acc"] = 100.0 - rel["class_error"]
                preds["act_class_acc"] = 100.0 - act["class_error"]
        return preds

    return eval_step

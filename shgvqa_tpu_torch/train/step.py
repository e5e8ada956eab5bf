"""Train and eval steps: the port of ``shgvqa_tpu/train/step.py``.

Loss composition of the hg tasks 'hgqa', 'vhga' and 'hgvqa' (the
reference's ``agqaHGQA.py``): bce(hg_logit, target) * num_answers + the
relation and action set losses through the Hungarian matching; GT-HG mode
drops the set losses.  The plain ``logit`` head gets no loss; under 'hgqa'
and 'vhga' it still trains through the shared ``logit_fc`` of the hg path.
Tasks 'q' and 'vqa': bce(logit, target) * num_answers, or with
``--mceLoss`` the cross-entropy on ``answer_idx``.

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

In a data-parallel run (``parallel/``) each rank's loss is its share of the
global batch's (the losses' normalizers are sums over the data group), and
between the backward and the optimizer ``GradientSum`` sums the gradients
of the trainable parameters over the data group in one all-reduce of one
flat buffer (the backward accumulates into it in place), with the metrics'
shares at its end: every rank then clips and updates the same summed
gradients, and logs the global metrics.  Under tensor parallelism the
ranks of a model group hold the same rows and replicated losses: each
holds its shards' gradients and the replicated parameters' whole ones,
and the clip's norm is the whole model's (``train/optimizer.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import HG_TASKS, PER_CHOICE, Config
from shgvqa_tpu_torch.losses import (
    bce_vqa_loss,
    empty_weight,
    hungarian_set_loss,
    mce_vqa_loss,
)
from shgvqa_tpu_torch.parallel import distributed


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
    if cfg.task in ("q", "vqa"):
        loss = (mce_vqa_loss(outputs["logit"], batch["answer_idx"])
                if cfg.mce_loss
                else bce_vqa_loss(outputs["logit"], batch["target"]))
        metrics["vqa_loss"] = metrics["total_loss"] = loss
        return loss, metrics
    total = hgqa_loss = bce_vqa_loss(outputs["hg_logit"], batch["target"])
    metrics["hgqa_loss"] = hgqa_loss
    # the rank's share of the global batch's accuracy
    metrics["hg_train_acc"] = (
        torch.argmax(outputs["hg_logit"], dim=-1)
        == torch.argmax(batch["target"], dim=-1)).float().mean()
    if distributed.data_size() > 1:
        metrics["hg_train_acc"] = (metrics["hg_train_acc"]
                                   / distributed.data_size())
    if not cfg.gt_hg:
        rel, act = _set_losses(cfg, outputs, batch)
        total = hgqa_loss + rel["loss_ce"] + act["loss_ce"]
        metrics["rel_loss"] = rel["loss_ce"]
        metrics["act_loss"] = act["loss_ce"]
        metrics["rel_class_error"] = rel["class_error"]
        metrics["act_class_error"] = act["class_error"]
    metrics["total_loss"] = total
    return total, metrics


# GT-HG mode embeds the labels: the decoders and class heads are built but
# bypassed
_GT_HG_DEAD = ("rel_decoder", "action_decoder", "class_embed", "action_embed")
# the encoder's modules that read the visual features and feed only the
# visual stream (besides its r-layers)
VISUAL_STREAM = ("visual_tokenizer", "caps_tokenizer", "caps_mask",
                 "caps_proj")


def connected_param_mask(model: nn.Module, cfg: Config) -> Dict[str, bool]:
    """Parameter name -> True where the parameter receives gradient from
    the task's loss; the reference's ``BertAdam.step`` skips the others
    (their grad is None), so they get neither update nor weight decay.

    - 'hgqa' / 'vhga': the LXRT pooler feeds only the unsupervised
      ``logit``, and so do the LXRT cross layers (``x_*``) unless
      ``after_cross_attn_feats`` feeds their output to the hg path;
    - 'hgvqa': ``logit_fc`` (the fusion head ``logit_fc2`` is supervised);
    - per-choice QA (``qa_arrange_type`` add_sep / no_sep, every task but
      'q'; the model builds no ``logit_fc`` / ``logit_fc2`` then): under
      'hgvqa' ``choice_score_fc`` (the unsupervised ``logit``; the fusion
      head ``choice_score_fc2`` is supervised);
    - GT-HG mode: the decoders and class heads, and under 'hgqa' / 'vhga'
      without ``after_cross_attn_feats`` the whole visual stream (the trunk,
      the tokenizer or the capsule tokenizer, mask and projection, the
      ``r_{i}``), whose only reader was the decoders (under
      ``--sharedWeights`` the language stream still trains the shared
      ``l_{i}``);
    - under 'old' with untied x-layers, the last one's ``lang_ffn``: the
      single-CLS pooler reads the visual stream only, and without
      ``after_cross_attn_feats`` nothing else reads the language one.

    The JAX mask (``shgvqa_tpu/train/step.py:76-136``) keeps the LXRT
    pooler under ``after_cross_attn_feats``, the visual stream under GT-HG
    and that FFN, and weight-decays them; the port follows the reference
    (ROADMAP C)."""
    task, enc = cfg.task, cfg.encoder
    after = cfg.after_cross_attn_feats
    # the post-cross streams and the pooler feed only the unsupervised logit
    logit_only = task in ("hgqa", "vhga")
    blind = logit_only and cfg.gt_hg and not after
    last_lang_ffn = (enc.cross_attn_type == "old" and not enc.tie_x_layers
                     and not after)
    per_choice = task != "q" and cfg.data.qa_arrange_type in PER_CHOICE

    def lxrt_connected(rest) -> bool:
        if rest[0] == "pooler":
            return not logit_only
        if rest[0] != "encoder":
            return True
        if rest[1].startswith("x_"):
            if logit_only and not after:
                return False
            return not (last_lang_ffn and rest[1] == f"x_{enc.x_layers - 1}"
                        and rest[2] == "lang_ffn")
        return not (blind and (rest[1] in VISUAL_STREAM
                               or rest[1].startswith("r_")))

    def connected(name: str) -> bool:
        keys = name.split(".")
        if "lxrt" in keys and not lxrt_connected(
                keys[keys.index("lxrt") + 1:] + ["", ""]):
            return False
        if task not in HG_TASKS:
            return True
        if cfg.gt_hg and any(dead in keys for dead in _GT_HG_DEAD):
            return False
        if blind and "backbone" in keys:
            return False
        plain_head = "choice_score_fc" if per_choice else "logit_fc"
        return not (task == "hgvqa" and plain_head in keys)

    return {n: connected(n) for n, _ in model.named_parameters()}


def _frozen_by_freeze_weights(keys) -> bool:
    """``--freezeWeights``: the encoder's embeddings and every encoder
    sublayer but the cross-modal x-layers, and the question-only model's
    ``l_{i}``; the poolers, decoders and heads train."""
    for enc in ("lxrt", "bert_encoder"):
        if enc in keys:
            rest = keys[keys.index(enc) + 1:]
            if rest[0] == "encoder":
                return not (len(rest) > 1 and rest[1].startswith("x_"))
            return rest[0] == "embeddings" or rest[0].startswith("l_")
    return False


def trainable_mask(model: nn.Module, cfg: Config) -> Dict[str, bool]:
    """``connected_param_mask``, and not what the freeze options freeze, as
    the JAX drivers compose them (``cli/common.py``): with
    ``freeze_backbone`` the trunk (without it every trunk parameter
    trains, the BatchNorm ``weight`` and ``bias`` included; the BatchNorm
    statistics are buffers, not parameters), with ``freeze_weights`` the
    encoder but its x-layers."""
    mask = connected_param_mask(model, cfg)
    for name in mask:
        keys = name.split(".")
        if cfg.freeze_backbone and "backbone" in keys:
            mask[name] = False
        if cfg.freeze_weights and _frozen_by_freeze_weights(keys):
            mask[name] = False
    return mask


# metrics that the losses already take over the global batch; every other
# metric of ``compute_losses`` is the rank's share
GLOBAL_METRICS = ("rel_class_error", "act_class_error")


class GradientSum:
    """Sums ``params``' gradients and the metrics' shares over the ranks in
    one flat f32 buffer, made once (a CUDA graph replays it at one
    address).  ``zero_grad`` zeroes the buffer and points each parameter's
    ``grad`` at its view of it, so the backward accumulates into the buffer
    in place (a parameter it does not reach keeps zeros, as None reads);
    the call then writes the metrics' shares at its end and all-reduces
    it."""

    def __init__(self, params):
        self.params = list(params)
        self.n = sum(p.numel() for p in self.params)
        self.flat: Optional[torch.Tensor] = None
        self.views = []

    @staticmethod
    def _names(metrics: Dict[str, torch.Tensor]):
        return [k for k in metrics if k not in GLOBAL_METRICS]

    def zero_grad(self, metrics: Dict[str, torch.Tensor]) -> None:
        size = self.n + len(self._names(metrics))
        if self.flat is None or self.flat.numel() != size:
            self.flat = torch.empty(size, dtype=torch.float32,
                                    device=self.params[0].device)
            offsets = [0]
            for p in self.params:
                offsets.append(offsets[-1] + p.numel())
            self.views = [self.flat[a:b].view_as(p) for a, b, p in
                          zip(offsets, offsets[1:], self.params)]
        self.flat.zero_()
        for p, view in zip(self.params, self.views):
            p.grad = view

    def __call__(self, metrics: Dict[str, torch.Tensor]) -> None:
        names = self._names(metrics)
        with torch.no_grad():
            self.flat[self.n:].copy_(torch.stack(
                [metrics[k].detach().float() for k in names]))
            distributed.all_reduce_sum_(self.flat)
            summed = self.flat[self.n:].clone()
        for i, k in enumerate(names):
            metrics[k] = summed[i]


def make_train_step(cfg: Config, model: nn.Module, optimizer):
    """train_step(batch, generator, lr=None) -> metrics: one forward in
    training mode, the losses, the backward and one optimizer update, in
    place.  ``lr`` (BertAdam only) is the step's learning rate as a device
    scalar (``BertAdam.step``).  Under a process group the gradients and
    metrics are summed over the ranks before the update (``GradientSum``)."""
    reduce = (GradientSum(optimizer.params) if distributed.is_active()
              else None)

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator = None,
                   lr: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        outputs = model(batch, generator)
        loss, metrics = compute_losses(cfg, outputs, batch)
        if reduce is None:
            optimizer.zero_grad()
        else:
            reduce.zero_grad(metrics)
        loss.backward()
        if reduce is not None:
            reduce(metrics)
        metrics["grad_norm"] = (optimizer.step() if lr is None
                                else optimizer.step(lr))
        return metrics

    return train_step


def make_eval_step(cfg: Config, model: nn.Module,
                   with_hg_metrics: bool = False):
    """eval_step(batch) -> the answer argmaxes; with ``with_hg_metrics`` and
    an hg batch carrying labels, also the matched rel/act class accuracy
    from the same forward."""
    want_hg_acc = (with_hg_metrics and cfg.task in HG_TASKS
                   and not cfg.gt_hg)

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

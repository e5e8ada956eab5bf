"""Set-prediction (Hungarian-matched) classification loss: the port of
``shgvqa_tpu/losses/set_prediction.py``.

- matched queries get their target class, all others the background 0;
- weighted cross entropy with ``empty_weight`` (ones, ``eos_coef`` on the
  background), normalized as torch's ``F.cross_entropy(weight=...)``: by
  the SUM of the selected targets' weights, not the element count;
- ``class_error`` = 100 - top-1 accuracy over the MATCHED slots only;
- per frame (``loss_hg_per_frame``) each situation's queries match its own
  targets; globally all Q queries of a clip match all its targets, the
  driver layout's (B, S, K) labels compacted on the device first
  (``ops.matcher.compact_labels``), with no host read.

In a data-parallel run (``parallel/``) the normalizer and the accuracy's
counts are sums over the global batch (``distributed.global_sum``, one
all-reduce each), as JAX's SPMD step takes them: each rank's loss is its
share of the global loss, and the shares add up to it.
"""

from __future__ import annotations

from typing import Dict

import torch

from shgvqa_tpu_torch.ops.matcher import (
    compact_labels,
    match_targets_global,
    match_targets_per_frame,
)
from shgvqa_tpu_torch.parallel.distributed import global_sum


def empty_weight(num_classes_with_bg: int, eos_coef: float,
                 background_idx: int = 0, device=None) -> torch.Tensor:
    """Ones with ``eos_coef`` at the background class, filled on the device
    (no copy from the host)."""
    w = torch.ones(num_classes_with_bg, device=device)
    w[background_idx:background_idx + 1].fill_(eos_coef)
    return w


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """sum_i w[y_i] * nll_i / sum_i w[y_i]; logits (..., C), targets (...);
    the denominator summed over the global batch."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    w = class_weights[targets.long()]
    return (w * nll).sum() / torch.clamp(global_sum(w.sum()), min=1e-12)


def matched_top1_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                          matched: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy (in %) over matched slots of the global batch, 0 if
    none matched."""
    correct = (torch.argmax(logits, dim=-1) == targets) & matched
    hits, n = global_sum(torch.stack((correct.sum(), matched.sum())))
    return torch.where(n > 0, 100.0 * hits / torch.clamp(n, min=1), 0.0)


def matched_target_grid(logits: torch.Tensor, labels: torch.Tensor,
                        lengths: torch.Tensor, per_frame: bool,
                        num_situations: int, background_idx: int = 0
                        ) -> torch.Tensor:
    """The reference's ``get_target_classes`` grid (``agqaHGQA.py:178-201``):
    matched queries carry their Hungarian-assigned target class, all
    others the background index, as (B, num_situations, Q / S), the layout
    the attention dumps write.  logits (B, Q, C); labels and lengths as
    ``hungarian_set_loss`` takes them.  Per frame through the subset DP,
    globally through ``match_targets_global`` (on the card the matcher
    kernel)."""
    b, q, c = logits.shape
    s = num_situations
    if per_frame:
        grid, _ = match_targets_per_frame(logits.reshape(b, s, q // s, c),
                                          labels, lengths, background_idx)
    else:
        if labels.dim() == 3:
            labels, lengths = compact_labels(labels, lengths)
        grid, _ = match_targets_global(logits, labels, lengths,
                                       background_idx)
    return grid.reshape(b, s, -1)


def hungarian_set_loss(logits: torch.Tensor, labels: torch.Tensor,
                       lengths: torch.Tensor, class_weights: torch.Tensor,
                       per_frame: bool, num_situations: int,
                       background_idx: int = 0) -> Dict[str, torch.Tensor]:
    """logits (B, Q, C) decoder class logits; labels (B, S, K) and lengths
    (B, S) per situation (globally also (B, N) and (B,)).  Returns
    {'loss_ce', 'class_error'} like the reference loss dict."""
    b, q, c = logits.shape
    if per_frame:
        s = num_situations
        logits = logits.reshape(b, s, q // s, c)
        target, matched = match_targets_per_frame(logits, labels, lengths,
                                                  background_idx)
    else:
        if labels.dim() == 3:
            labels, lengths = compact_labels(labels, lengths)
        target, matched = match_targets_global(logits, labels, lengths,
                                               background_idx)
    loss = weighted_cross_entropy(logits, target, class_weights)
    acc = matched_top1_accuracy(logits, target, matched)
    return {"loss_ce": loss, "class_error": 100.0 - acc}

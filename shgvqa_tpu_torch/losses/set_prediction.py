"""Set-prediction (Hungarian-matched) classification loss: the port of
``shgvqa_tpu/losses/set_prediction.py`` (per-frame mode).

- matched queries get their target class, all others the background 0;
- weighted cross entropy with ``empty_weight`` (ones, ``eos_coef`` on the
  background), normalized as torch's ``F.cross_entropy(weight=...)``: by
  the SUM of the selected targets' weights, not the element count;
- ``class_error`` = 100 - top-1 accuracy over the MATCHED slots only.
"""

from __future__ import annotations

from typing import Dict

import torch

from shgvqa_tpu_torch.ops.matcher import match_targets_per_frame


def empty_weight(num_classes_with_bg: int, eos_coef: float,
                 background_idx: int = 0, device=None) -> torch.Tensor:
    """Ones with ``eos_coef`` at the background class, filled on the device
    (no copy from the host)."""
    w = torch.ones(num_classes_with_bg, device=device)
    w[background_idx:background_idx + 1].fill_(eos_coef)
    return w


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """sum_i w[y_i] * nll_i / sum_i w[y_i]; logits (..., C), targets (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    w = class_weights[targets.long()]
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)


def matched_top1_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                          matched: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy (in %) over matched slots, 0 if none matched."""
    correct = (torch.argmax(logits, dim=-1) == targets) & matched
    n = matched.sum()
    return torch.where(n > 0, 100.0 * correct.sum() / torch.clamp(n, min=1),
                       0.0)


def hungarian_set_loss(logits: torch.Tensor, labels: torch.Tensor,
                       lengths: torch.Tensor, class_weights: torch.Tensor,
                       per_frame: bool, num_situations: int,
                       background_idx: int = 0) -> Dict[str, torch.Tensor]:
    """logits (B, Q, C) decoder class logits; labels (B, S, K) and lengths
    (B, S) per frame.  Returns {'loss_ce', 'class_error'} like the
    reference loss dict."""
    if not per_frame:
        raise NotImplementedError(
            "the global (whole-clip) matcher mode is not ported yet (ROADMAP "
            "queue A item 8); the port supports loss_hg_per_frame=True")
    b, q, c = logits.shape
    s = num_situations
    logits_f = logits.reshape(b, s, q // s, c)
    target, matched = match_targets_per_frame(logits_f, labels, lengths,
                                              background_idx)
    loss = weighted_cross_entropy(logits_f, target, class_weights)
    acc = matched_top1_accuracy(logits_f, target, matched)
    return {"loss_ce": loss, "class_error": 100.0 - acc}

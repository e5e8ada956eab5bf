"""Answer-head loss: the port of ``bce_vqa_loss`` in
``shgvqa_tpu/losses/vqa.py``, ``nn.BCEWithLogitsLoss()(logit, one_hot) *
num_answers`` -- the elementwise mean scaled by the answer-space size.  The
--mceLoss variant is not ported yet (``configs.config.check_ported``)."""

from __future__ import annotations

import torch


def bce_vqa_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (B, A), targets (B, A) in {0, 1}.  Mean BCE * A, in f32."""
    logits = logits.float()
    targets = targets.float()
    per_elem = (torch.clamp(logits, min=0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    return per_elem.mean() * logits.shape[-1]

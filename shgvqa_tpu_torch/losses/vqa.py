"""Answer-head losses: the port of ``shgvqa_tpu/losses/vqa.py``.

- BCE: ``nn.BCEWithLogitsLoss()(logit, one_hot) * num_answers`` -- the
  elementwise mean scaled by the answer-space size;
- MCE (``--mceLoss``): ``nn.CrossEntropyLoss(ignore_index=-1)`` on answer
  indices.

In a data-parallel run each rank's loss is its share of the global batch's:
the BCE mean over the rank's rows divided by the data-parallel extent (the
ranks hold equal rows), the MCE sum divided by the global count of kept
rows (the data group's).
"""

from __future__ import annotations

import torch

from shgvqa_tpu_torch.parallel.distributed import data_size, global_sum


def bce_vqa_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (B, A), targets (B, A) in {0, 1}.  Mean BCE * A, in f32."""
    logits = logits.float()
    targets = targets.float()
    per_elem = (torch.clamp(logits, min=0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    loss = per_elem.mean() * logits.shape[-1]
    return loss if data_size() == 1 else loss / data_size()


def mce_vqa_loss(logits: torch.Tensor, answer_idx: torch.Tensor
                 ) -> torch.Tensor:
    """logits (B, A), answer_idx (B,) with -1 = ignore.  The mean negative
    log-likelihood over the kept rows (0 when none is kept), in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = answer_idx >= 0
    idx = answer_idx.clamp(min=0).long()
    nll = -torch.gather(logp, -1, idx[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / global_sum(valid.sum()).clamp(min=1)

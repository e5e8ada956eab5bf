"""BertAdam behind a global-norm clip: the port of ``bert_adam`` and
``make_optimizer`` in ``shgvqa_tpu/train/optimizer.py``.

BertAdam (the reference's ``lxrt/optimization.py``) differs from stock Adam:
- NO bias correction of the moments;
- decoupled weight decay ADDED TO THE UPDATE: p -= lr_t * (m / (sqrt(v) +
  eps) + wd * p);
- the schedule is read at ``step / t_total`` with the step counted BEFORE
  the increment, so under ``warmup_linear`` the first update has lr 0.
The gradients are first clipped to global norm ``grad_clip`` (5.0).

``make_optimizer`` takes the trainable mask (``train/step.trainable_mask``):
frozen and grad-disconnected parameters never enter the optimizer, so they
are left out of the clip norm and get exactly zero update and no weight
decay (the JAX ``multi_transform`` with ``set_to_zero``, :309-319).

One update over all parameters per step (``torch._foreach_*``), in place;
the JAX package's flat (N/256, 256) TPU layout is not carried over.  The
learning rate is computed on the host from the host's step count, so a
step needs no sync.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn


def warmup_linear(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


def warmup_constant(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_cosine(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


SCHEDULES: Dict[str, Callable[[float, float], float]] = {
    "warmup_linear": warmup_linear,
    "warmup_constant": warmup_constant,
    "warmup_cosine": warmup_cosine,
}


class BertAdam:
    """clip_by_global_norm(grad_clip) -> BertAdam over ``params``, updating
    them in place from their ``.grad`` (None reads as zeros)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 t_total: int = -1, warmup: float = 0.1,
                 schedule: str = "warmup_linear", b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, grad_clip: float = 5.0):
        self.params = list(params)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.step_count = 0
        self.lr, self.t_total, self.warmup = lr, t_total, warmup
        self.schedule = SCHEDULES[schedule]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def lr_at(self, step: int) -> float:
        if self.t_total > 0:
            return self.lr * self.schedule(step / self.t_total, self.warmup)
        return self.lr

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update; returns the gradients' global norm before the clip
        (a device tensor)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # optax clip_by_global_norm: unchanged below the limit, else g / norm
        # * limit
        scale = torch.where(norm < self.grad_clip, 1.0,
                            self.grad_clip / norm)
        grads = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.m, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update,
                            alpha=-self.lr_at(self.step_count))
        self.step_count += 1
        return norm


def make_optimizer(model: nn.Module, lr: float, t_total: int,
                   warmup: float = 0.1, schedule: str = "warmup_linear",
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                   weight_decay: float = 0.01, grad_clip: float = 5.0,
                   trainable_mask: Optional[Dict[str, bool]] = None,
                   name: str = "bert") -> BertAdam:
    """BertAdam behind the global-norm clip over the parameters of
    ``model`` that ``trainable_mask`` (parameter name -> bool; all when
    None) marks trainable."""
    if "bert" not in name:
        raise NotImplementedError(
            f"--optim {name} is not ported yet (ROADMAP queue A item 10); "
            "the port runs BertAdam")
    params = [p for n, p in model.named_parameters()
              if trainable_mask is None or trainable_mask[n]]
    return BertAdam(params, lr, t_total, warmup, schedule, b1, b2, eps,
                    weight_decay, grad_clip)

"""BertAdam, or a stock torch optimizer, behind a global-norm clip: the port
of ``bert_adam``, ``plain_optimizer`` and ``make_optimizer`` in
``shgvqa_tpu/train/optimizer.py``.

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

``--optim rms|adam|adamax|sgd`` (any name without "bert") binds the stock
torch optimizer the reference constructs with only (params, lr): no
schedule, no weight decay, torch's default hyperparameters, behind the same
clip and mask (``PlainOptimizer``):
- adam: b1 .9, b2 .999, eps 1e-8, bias-corrected moments;
- adamax: exp_inf = max(b2 u, |g| + eps), the lr bias-corrected by
  (1 - b1^t);
- rms: alpha .99, eps 1e-8 added outside the square root;
- sgd: p -= lr g (no momentum).

One update over all parameters per step (``torch._foreach_*``), in place;
the JAX package's flat (N/256, 256) TPU layout is not carried over.  The
learning rate is computed on the host from the host's step count, so a
step needs no sync.  BertAdam multiplies its update by the learning rate
as an f32 scalar tensor on the device: filled from the host's value, or
given by the caller (``train/graph.py`` replays k steps whose rates it
copies into a static tensor); both take the one formula.  Every optimizer keeps its state in ``m`` and ``v``
(lists of tensors, empty where its rule has none) and ``step_count``,
which ``Trainer.state_dict`` saves and ``Trainer.load`` restores.
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


def clipped_grads(params, grad_clip: float):
    """The parameters' gradients (None reads as zeros) clipped to global
    norm ``grad_clip``, and their global norm before the clip."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # optax clip_by_global_norm: unchanged below the limit, else g / norm
    # * limit
    scale = torch.where(norm < grad_clip, 1.0, grad_clip / norm)
    return torch._foreach_mul(grads, scale), norm


class BertAdam:
    """clip_by_global_norm(grad_clip) -> BertAdam over ``params``, updating
    them in place from their ``.grad`` (None reads as zeros)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 t_total: int = -1, warmup: float = 0.1,
                 schedule: str = "warmup_linear", b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, grad_clip: float = 5.0):
        self.params = list(params)
        self.name = "bert"
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
    def step(self, lr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update; returns the gradients' global norm before the clip
        (a device tensor).  ``lr`` is this step's learning rate, an f32
        scalar on the parameters' device; when None, ``lr_at(step_count)``
        (computed in double on the host, then f32)."""
        if lr is None:
            lr = torch.full((), self.lr_at(self.step_count),
                            dtype=torch.float32, device=self.params[0].device)
        grads, norm = clipped_grads(self.params, self.grad_clip)
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.m, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        # p - lr * update, the product rounded before the difference (one
        # rounding point whether lr is filled here or replayed by a graph)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(self.params, update)
        self.step_count += 1
        return norm


PLAIN_OPTIMIZERS = ("adam", "adamax", "rms", "sgd")


class PlainOptimizer:
    """clip_by_global_norm(grad_clip) -> the stock torch rule ``name``
    (adam, adamax, rms or sgd) at a constant ``lr``, updating ``params``
    in place from their ``.grad`` (None reads as zeros)."""

    B1, B2, EPS, ALPHA = 0.9, 0.999, 1e-8, 0.99

    def __init__(self, params: Iterable[torch.Tensor], name: str, lr: float,
                 grad_clip: float = 5.0):
        if name not in PLAIN_OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {name!r}; the reference accepts "
                "rms/adam/adamax/sgd or any name containing 'bert'")
        self.params = list(params)
        self.name, self.lr, self.grad_clip = name, lr, grad_clip
        self.m = ([torch.zeros_like(p) for p in self.params]
                  if name in ("adam", "adamax") else [])
        self.v = ([torch.zeros_like(p) for p in self.params]
                  if name != "sgd" else [])
        self.step_count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update; returns the gradients' global norm before the clip
        (a device tensor)."""
        grads, norm = clipped_grads(self.params, self.grad_clip)
        t = self.step_count + 1
        b1, b2, eps = self.B1, self.B2, self.EPS
        if self.name in ("adam", "adamax"):
            torch._foreach_mul_(self.m, b1)
            torch._foreach_add_(self.m, grads, alpha=1.0 - b1)
            step = -self.lr / (1.0 - b1 ** t)
        if self.name == "adam":
            torch._foreach_mul_(self.v, b2)
            torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(self.v)
            torch._foreach_div_(denom, math.sqrt(1.0 - b2 ** t))
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(self.params, self.m, denom, value=step)
        elif self.name == "adamax":
            torch._foreach_mul_(self.v, b2)
            torch._foreach_maximum_(self.v, torch._foreach_add(
                torch._foreach_abs(grads), eps))
            torch._foreach_addcdiv_(self.params, self.m, self.v, value=step)
        elif self.name == "rms":
            a = self.ALPHA
            torch._foreach_mul_(self.v, a)
            torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - a)
            denom = torch._foreach_sqrt(self.v)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(self.params, grads, denom,
                                    value=-self.lr)
        else:
            torch._foreach_add_(self.params, grads, alpha=-self.lr)
        self.step_count += 1
        return norm


def make_optimizer(model: nn.Module, lr: float, t_total: int,
                   warmup: float = 0.1, schedule: str = "warmup_linear",
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                   weight_decay: float = 0.01, grad_clip: float = 5.0,
                   trainable_mask: Optional[Dict[str, bool]] = None,
                   name: str = "bert"):
    """BertAdam (any ``name`` containing "bert") or the stock optimizer
    ``name`` (``PlainOptimizer``: constant ``lr``, torch defaults; the
    schedule and BertAdam's hyperparameters unused) behind the global-norm
    clip, over the parameters of ``model`` that ``trainable_mask``
    (parameter name -> bool; all when None) marks trainable."""
    params = [p for n, p in model.named_parameters()
              if trainable_mask is None or trainable_mask[n]]
    if "bert" not in name:
        return PlainOptimizer(params, name, lr, grad_clip)
    return BertAdam(params, lr, t_total, warmup, schedule, b1, b2, eps,
                    weight_decay, grad_clip)

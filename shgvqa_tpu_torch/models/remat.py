"""Rematerialization (``--remat`` / ``--rematPolicy``): the port of
``remat_class`` and ``REMAT_POLICIES`` in ``shgvqa_tpu/models/layers.py``.

``remat_call(block, policy, *args)`` runs a block under
``torch.utils.checkpoint`` (non-reentrant) when the block is training and
autograd records: its activations are dropped after the forward and the
block runs again in the backward.  The JAX policies map onto selective
checkpointing of the dispatcher's ops:

- ``''``: save nothing, recompute everything;
- ``dots`` (``dots_with_no_batch_dims_saveable``): keep the products without
  batch dimensions (``mm``, ``addmm``: every dense layer);
- ``dots_batch`` (``dots_saveable``): also the batched ones (``bmm``,
  ``baddbmm``: the plain attention's two products);
- ``dots_attn``: ``dots_batch`` and the fused attention forward's ``o`` and
  ``lse``, so its kernel does not run again.  A ctypes launch is invisible to
  a policy, so inside such a block the forward kernel goes through the
  dispatcher op ``shgvqa_torch::attention_fwd`` (``kernels/attention.py``).

The FFN-train kernel's products are opaque to every policy (as a
``pallas_call`` is no ``dot_general`` in JAX), so each policy runs it again.

Random draws: every dropout mask and every kernel seed of a training step
comes from the caller's ``torch.Generator``, which ``checkpoint``'s
``preserve_rng_state`` does not restore, and whose state cannot be read or
rewound while a CUDA graph is being captured (``train/graph.py``).  So a
block under remat keeps a tape of its draws: the first forward records what
each draw returned (a kernel's two seed words, a plain site's bool keep
mask, one byte an element) and the recompute reads them back in order
instead of drawing.  The recompute thus drops exactly what the forward
dropped, and the generator ends the step where a step without remat leaves
it.  Draw sites call ``replayable``.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("", "dots", "dots_batch", "dots_attn")

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)

_LOCAL = threading.local()


class _Tape:
    """The values a block's draws returned in its first forward."""

    def __init__(self, attention_op: bool):
        self.values: List[torch.Tensor] = []
        self.pos: Optional[int] = None      # None: recording
        self.recorded = False
        self.attention_op = attention_op

    def take(self, draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        if self.pos is None:
            value = draw()
            self.values.append(value)
            return value
        if self.pos >= len(self.values):
            raise RuntimeError("remat: the recompute drew more than the "
                               "forward did")
        value = self.values[self.pos]
        self.pos += 1
        return value


def _stack() -> List[_Tape]:
    if not hasattr(_LOCAL, "tapes"):
        _LOCAL.tapes = []
    return _LOCAL.tapes


def replayable(draw: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``draw()``, recorded in the innermost remat block's tape; in its
    recompute, the recorded value."""
    tapes = _stack()
    return tapes[-1].take(draw) if tapes else draw()


def attention_op_visible() -> bool:
    """Whether the fused attention forward must go through its dispatcher
    op: inside a ``dots_attn`` block, whose policy saves its outputs."""
    tapes = _stack()
    return bool(tapes) and tapes[-1].attention_op


def check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of "
                         f"{POLICIES}")


def set_remat(model: torch.nn.Module, policy: Optional[str]) -> None:
    """Rematerialize the blocks of ``model`` that ``--remat`` wraps under
    ``policy`` (None: no remat), on a model already built."""
    if policy is not None:
        check_policy(policy)
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = policy


@functools.lru_cache(maxsize=None)
def _saved_ops(policy: str) -> frozenset:
    if policy == "dots":
        return frozenset(_DOTS)
    ops = _DOTS + _BATCH_DOTS
    if policy == "dots_attn":
        from shgvqa_tpu_torch.kernels.attention import attention_op

        ops += (attention_op(),)
    return frozenset(ops)


def _context_fn(policy: str):
    saved = _saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy_fn)


def remat_call(block: torch.nn.Module, policy: Optional[str], *args):
    """``block(*args)``; under remat (``policy`` not None) and when the
    block trains under autograd, through ``checkpoint`` with the policy's
    saved ops and a tape of the block's draws."""
    if (policy is None or not block.training
            or not torch.is_grad_enabled()):
        return block(*args)
    tape = _Tape(attention_op=policy == "dots_attn")

    def run(*inputs):
        # the first run records the tape, each later one reads it from its
        # start
        tape.pos = 0 if tape.recorded else None
        tapes = _stack()
        tapes.append(tape)
        try:
            return block(*inputs)
        finally:
            tapes.pop()
            tape.recorded = True

    kw = {}
    if policy:
        kw["context_fn"] = functools.partial(_context_fn, policy)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)

"""The ``data`` x ``model`` layout: the port of
``shgvqa_tpu/parallel/mesh.py``.

The JAX package runs one SPMD program over a ``dp x mp`` device mesh.  Here
each rank is a process on one device (``parallel/distributed.py``); rank r
sits at data index r // mp and model index r % mp.  A run on dp x mp ranks
is the one-process step on the global batch:

- data axis: rank (d, m) owns rows [d * G / dp, (d + 1) * G / dp) of a
  global batch of G, as JAX's ``host_shard``.  ``shard_batch`` keeps a
  rank's rows of a global batch (``local_rows`` of one array); the driver's
  ``Batcher(host_shard=(d, dp))`` builds only those rows.
  ``global_rows(n)`` is where the rank's n rows sit in the global tensor,
  ``(d * n, dp * n)``.  Every random draw of a training step (the dropout
  masks, the augmentation, the kernels' Philox counters) is taken for the
  global tensor and sliced there, so the generators of all ranks stay in
  lockstep and each rank drops what one process would drop on its rows.
  The losses divide by sums over the data group and the gradients are
  summed over it (``losses/``, ``train/step.py``);
- model axis (tensor parallelism): the port's own copy of JAX's
  ``_TP_RULES``, ``_spec_for`` and the divisibility fallback
  (``shgvqa_tpu/parallel/mesh.py:57-105``) is applied to the JAX path of
  every port parameter (through ``convert.py``'s name map): ``split_plan``.
  Under those rules (matched against paths that end in
  ``<name>/Dense_0/kernel``) the q, k, v projections of every attention,
  every FFN ``intermediate``, the decoders' packed ``in_proj`` and
  ``linear1`` and every ``fc1`` (the ``MLPHead``s', the ViT blocks') split
  by output columns; every FFN ``output``, the decoders' ``out_proj`` and
  ``linear2`` and every ``fc2`` by input rows.  ``.*output/dense/kernel$``
  does not match ``attention/output/dense/Dense_0/kernel``: the attention
  output (``AttOutput``, the fused ``csrc/out_ln.cu``) stays whole, as do
  the poolers, embeddings, tokenizer, trunk, capsules, the ViT ``qkv``,
  every bias and every LayerNorm;
- ``shard_model_`` slices those weights in place, module by module (each
  module that can split names its tensors in ``TP_SPLITS``), and sets the
  module's ``tp`` = (model index, mp), which its forward reads.  Three
  departures in placement, not in math: a column-split product's bias and
  the ``MLPHead``'s LayerNorm over its split hidden are stored as shards
  (whole, each rank's gradient of them would be a partial sum), and the
  packed ``in_proj`` is split head-aligned, q, k and v each by heads,
  where JAX cuts its 3D columns contiguously.  A module whose split JAX's
  fallback leaves whole (a dim the model axis does not divide, or a head
  count it does not), and a module of a kind the port cannot split (the
  MViT and Swin trunks' MLPs, which JAX's rules split), stays whole:
  replicated, which is always correct; ``shard_model_`` prints one line
  naming it;
- ``gathered(model)`` holds the one-process tensors in the sharded
  parameters while it lasts (saves and loads run inside it);
  ``gather_state_dict(model)`` is the one-process state dict.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shgvqa_tpu_torch.parallel import distributed


class Mesh(NamedTuple):
    """The ``data`` x ``model`` extents of a run."""

    data: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(mesh_cfg=None, n_devices: int = 1) -> Mesh:
    """``dp x mp`` over ``n_devices`` (``data_parallel`` -1: every device
    the model axis leaves); raises when the layout does not cover them."""
    mp = max(1, getattr(mesh_cfg, "model_parallel", 1))
    dp = getattr(mesh_cfg, "data_parallel", -1)
    if dp == -1:
        dp = n_devices // mp
    if dp * mp != n_devices:
        raise ValueError(f"mesh {dp}x{mp} does not cover {n_devices} devices")
    return Mesh(dp, mp)


# JAX's parameter partitioning rules, first match wins, else replicated:
# (path regex, the spec of the (in, out) kernel as (dim 0, dim 1) axes)
_TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*(query|key|value)/.*kernel$", (None, "model")),
    (r".*in_proj/kernel$", (None, "model")),
    (r".*output/dense/kernel$", ("model", None)),
    (r".*out_proj/.*kernel$", ("model", None)),
    (r".*(intermediate|linear1|fc1)/.*kernel$", (None, "model")),
    (r".*(ffn/output|linear2|fc2)/.*kernel$", ("model", None)),
)


def _spec_for(path: str, model_parallel: bool) -> Tuple[Optional[str], ...]:
    if model_parallel:
        for pattern, spec in _TP_RULES:
            if re.match(pattern, path):
                return spec
    return ()


def jax_spec(path: str, shape, mp: int) -> Tuple[Optional[str], ...]:
    """JAX's spec of the leaf at ``path`` of ``shape`` at model extent
    ``mp``: the rule's, or () (replicated) where the rule splits a dim that
    ``mp`` does not divide, as ``partition_params`` falls back."""
    spec = _spec_for(path, mp > 1)
    for dim, axis in enumerate(spec):
        if axis is not None and (dim >= len(shape) or shape[dim] % mp):
            return ()
    return spec


def split_plan(model: nn.Module, mp: int) -> Dict[str, int]:
    """Port parameter name -> the torch dim JAX's rules split at model
    extent ``mp``, for every parameter they split (the kernels of the JAX
    tree, through ``convert.py``'s names and layouts)."""
    from shgvqa_tpu_torch.convert import _jax_leaf

    ranks = {n[:-len(".weight")]: p.dim()
             for n, p in model.named_parameters() if n.endswith(".weight")}
    plan = {}
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        path, _, perm = _jax_leaf(module, leaf, ranks.get(module))
        shape = p.shape if perm is None else [p.shape[i] for i in perm]
        spec = jax_spec("/".join(path), shape, mp)
        for dim, axis in enumerate(spec):
            if axis is not None:
                plan[name] = dim if perm is None else perm[dim]
    return plan


def _module_splits(module: nn.Module, count: int) -> Optional[dict]:
    """``module``'s ``TP_SPLITS`` where it can split ``count`` ways (its
    heads, where it splits by heads (``TP_HEADS``), and each split dim's
    parts divide), else None."""
    if getattr(module, "TP_HEADS", False) and module.num_heads % count:
        return None
    splits = {}
    for name, (dim, parts) in module.TP_SPLITS.items():
        t = module.get_parameter(name)
        if t.shape[dim] % (parts * count):
            return None
        splits[name] = (dim, parts)
    return splits


def shard_model_(model: nn.Module, index: Optional[int] = None,
                 count: Optional[int] = None, log=print) -> List[str]:
    """Slice ``model``'s weights in place to model index ``index`` of
    ``count`` (this rank's, by default), module by module as JAX's rules
    split them, and set each split module's ``tp``.  A module the rules
    split that cannot split (fallback, or a kind without ``TP_SPLITS``) stays
    whole and is named in one line through ``log``.  Returns the names of
    the modules kept whole."""
    index = distributed.model_rank() if index is None else index
    count = distributed.model_size() if count is None else count
    if count == 1:
        return []
    plan = split_plan(model, count)
    covered, whole = set(), []
    for mname, module in model.named_modules():
        if not hasattr(module, "TP_SPLITS"):
            continue
        prefix = f"{mname}." if mname else ""
        kernels = {f"{prefix}{n}": dim for n, (dim, _) in
                   module.TP_SPLITS.items() if n.endswith("weight")
                   and module.get_parameter(n).dim() == 2}
        covered.update(kernels)
        splits = _module_splits(module, count)
        if splits is None or any(plan.get(n) != d for n, d in kernels.items()):
            if any(n in plan for n in kernels):
                whole.append(mname)
            continue
        for name, split in splits.items():
            _narrow_(module.get_parameter(name), split, index, count)
        module.tp = (index, count)
    stray = sorted({n.rpartition(".")[0] for n in plan if n not in covered})
    whole += stray
    if whole:
        log(f"tensor parallelism mp={count}: kept whole (replicated) "
            f"{len(whole)} module(s) JAX's rules split: {', '.join(whole)}")
    return whole


def shard_of(t: torch.Tensor, split, index: int, count: int) -> torch.Tensor:
    """Model index ``index``'s shard of the whole tensor ``t`` under
    ``split`` = (dim, parts): of each of the dim's ``parts`` equal blocks,
    the index's slice (a contiguous copy)."""
    dim, parts = split
    shape = list(t.shape)
    blocks = t.reshape(shape[:dim] + [parts, count, -1] + shape[dim + 1:])
    return blocks.select(dim + 1, index).reshape(
        shape[:dim] + [shape[dim] // count] + shape[dim + 1:]).contiguous()


def _narrow_(p: nn.Parameter, split, index: int, count: int) -> None:
    with torch.no_grad():
        p.data = shard_of(p.data, split, index, count)
    p.tp_split = split


def whole_of(t: torch.Tensor, split) -> torch.Tensor:
    """The whole tensor of this rank's shard ``t`` under ``split``: the
    model group's shards gathered (a collective)."""
    dim, parts = split
    count = distributed.model_size()
    moved = t.detach().movedim(dim, -1)
    full = distributed.gather_from_model(moved.contiguous())
    shape = list(full.shape)
    block = shape[-1] // (parts * count)
    full = full.reshape(shape[:-1] + [count, parts, block]).transpose(-3, -2)
    return full.reshape(shape).movedim(-1, dim).contiguous()


def sharded_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters()
            if getattr(p, "tp_split", None) is not None]


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[None]:
    """Inside: every sharded parameter of ``model`` holds the one-process
    tensor (gathered over the model group); on the way out each keeps its
    rank's shard of whatever the whole tensor holds then (a load inside
    is sharded), in its own storage.  Nested, the outer one acts."""
    params = [p for _, p in sharded_parameters(model)]
    if (not params or distributed.model_size() == 1
            or getattr(model, "_tp_whole", False)):
        yield
        return
    model._tp_whole = True
    own = [p.data for p in params]
    for p in params:
        p.data = whole_of(p.data, p.tp_split)
    try:
        yield
    finally:
        index, count = distributed.model_rank(), distributed.model_size()
        with torch.no_grad():
            for p, data in zip(params, own):
                data.copy_(shard_of(p.data, p.tp_split, index, count))
                p.data = data
        model._tp_whole = False


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The one-process state dict of a sharded ``model`` (copies)."""
    with gathered(model):
        return {k: v.clone() for k, v in model.state_dict().items()}


def global_rows(n_local: int) -> Tuple[int, int]:
    """(first row of this rank, rows of the data group) of a tensor whose
    dim 0 holds this rank's ``n_local`` rows: ``(0, n_local)`` in one
    process."""
    return (distributed.data_rank() * n_local,
            distributed.data_size() * n_local)


def local_rows(x, index: int = None, count: int = None):
    """This rank's rows (its data index's) of a global batch-first array,
    tensor or list."""
    return x[distributed.process_batch_slice(len(x), index, count)]


def shard_batch(batch: Dict[str, Any], index: int = None,
                count: int = None) -> Dict[str, Any]:
    """This rank's rows of every array, tensor and list of a global batch;
    other fields (``n_valid``) as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list)) and len(v):
            out[k] = local_rows(v, index, count)
        else:
            out[k] = v
    return out

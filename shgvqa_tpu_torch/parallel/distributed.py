"""Processes of a data- and tensor-parallel run: the port of
``shgvqa_tpu/parallel/distributed.py`` on ``torch.distributed``.

One process is one rank on one device.  ``maybe_initialize_distributed``
starts the process group from the JAX package's variables::

    SHGVQA_COORDINATOR=host:port  SHGVQA_NUM_PROCESSES=N  SHGVQA_PROCESS_ID=i

(or explicit arguments): NCCL for a CUDA device, gloo for the CPU, unless
the caller names a backend.  A rank's device is ``cuda:<local rank>``, the
local rank ``SHGVQA_LOCAL_RANK`` or the rank modulo the visible GPUs.  A failed start raises; nothing falls back to one process.

Without a process group every collective here is the identity and
``world_size()`` is 1, so the single-process paths run as they did.

The two axes (``set_model_parallel(mp)``, called by every rank after the
group starts): rank r of a world of dp x mp sits at data index r // mp and
model index r % mp, JAX's ``reshape(dp, mp)``
(``shgvqa_tpu/parallel/mesh.py:43``).  The data group holds the ranks of
one model index (they hold the same shards and different rows), the model
group the ranks of one data index (the same rows, different shards).  At
mp = 1 the data group is the world and every model collective is the
identity.  The helpers the rest of the port calls:

- ``process_batch_slice`` and ``pad_to_multiple``: the JAX functions'
  decisions and errors, over the data axis;
- ``global_sum(t)``: ``t`` summed over the data group (a copy; the losses'
  normalizers); ``all_reduce_sum_(t)``: in place (the step's gradients);
  ``all_reduce_sum_.launches`` counts the all-reduces issued, as a kernel
  wrapper counts its launches;
- ``broadcast_(tensors)``: data index 0's values into the tensors of every
  rank of its data group, in place, one collective per dtype over a flat
  copy (a shard goes to the ranks that hold the same shard);
- ``allgather_object``: ``[obj of data index 0, ..., obj of data index
  dp - 1]``, each from model index 0 of its model group (JAX's
  ``local_rows`` dedup across model replicas);
- the model group's collectives, as autograd functions (Megatron's f and
  g), each counting in ``.launches`` the collectives it issued, forward and
  backward: ``copy_to_model`` (identity forward, all-reduce backward: the
  input of a column-split product), ``reduce_from_model`` (all-reduce
  forward, identity backward: after a row-split product, whose readers
  are replicated), ``gather_from_model`` (all-gather of the last dim
  forward, this rank's slice backward: the attention context before the
  whole ``AttOutput``), ``sum_over_model`` (all-reduce both ways: a sum
  whose readers are sharded, the split LayerNorm's statistics) and
  ``model_sum_`` (in place, no autograd: the clip's squared norms).  Sums
  of bf16 or f16 tensors are taken in f32.  gloo has no all-gather of CUDA
  tensors, so on gloo the gather is an all-reduce of a zero-filled
  full-width buffer (adding zeros is exact); on NCCL it is
  ``all_gather_into_tensor``.  Nothing moves to the CPU;
- ``rank``, ``world_size``, ``data_rank``, ``data_size``, ``model_rank``,
  ``model_size``, ``backend``, ``barrier``.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

ENV_COORDINATOR = "SHGVQA_COORDINATOR"
ENV_NUM_PROCESSES = "SHGVQA_NUM_PROCESSES"
ENV_PROCESS_ID = "SHGVQA_PROCESS_ID"
ENV_LOCAL_RANK = "SHGVQA_LOCAL_RANK"

# how long a collective may wait for a rank before the run fails
TIMEOUT = datetime.timedelta(minutes=10)


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device="cuda",
                                 backend: Optional[str] = None) -> bool:
    """Start the process group when the variables (or the arguments) ask
    for one; True if it runs.  ``device`` picks the backend (NCCL on a CUDA
    device, gloo on the CPU) unless ``backend`` names one; on a CUDA device
    the rank's GPU becomes current."""
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if num_processes is None and ENV_NUM_PROCESSES in os.environ:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"a multi-process run needs {ENV_COORDINATOR}, "
            f"{ENV_NUM_PROCESSES} and {ENV_PROCESS_ID} (got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r})")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(process_id))
        if backend == "nccl":
            kw["device_id"] = local_device(process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT, **kw)
    return True


def local_device(process_id: Optional[int] = None) -> torch.device:
    """This rank's GPU: ``cuda:<local rank>``."""
    if ENV_LOCAL_RANK in os.environ:
        return torch.device("cuda", int(os.environ[ENV_LOCAL_RANK]))
    pid = rank() if process_id is None else process_id
    return torch.device("cuda", pid % max(1, torch.cuda.device_count()))


def shutdown() -> None:
    """Leave the process group (a no-op without one); the layout returns
    to one model index."""
    _LAYOUT.update(model=1, data_group=None, model_group=None)
    if dist.is_initialized():
        dist.destroy_process_group()


# the model axis' extent and this rank's two groups (None: the world for
# the data group, no collective for the model group at mp = 1)
_LAYOUT = {"model": 1, "data_group": None, "model_group": None}


def set_model_parallel(model_parallel: int) -> None:
    """Split the world into dp x mp (``model_parallel`` = mp, a divisor of
    the world): every rank calls it, after the group starts, with the same
    value.  Builds the data and model groups."""
    mp = max(1, int(model_parallel))
    world = world_size()
    if world % mp:
        raise ValueError(f"--modelParallel {mp} does not divide the "
                         f"{world} processes")
    _LAYOUT.update(model=1, data_group=None, model_group=None)
    if mp == 1 or not is_active():
        return
    me = rank()
    dp = world // mp
    # every rank creates every group, in one order
    for m in range(mp):
        group = dist.new_group([d * mp + m for d in range(dp)])
        if me % mp == m:
            _LAYOUT["data_group"] = group
    for d in range(dp):
        group = dist.new_group([d * mp + m for m in range(mp)])
        if me // mp == d:
            _LAYOUT["model_group"] = group
    _LAYOUT["model"] = mp


def is_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def model_size() -> int:
    """The model axis' extent (mp): 1 without tensor parallelism."""
    return _LAYOUT["model"]


def model_rank() -> int:
    """This rank's model index, r % mp."""
    return rank() % model_size()


def data_size() -> int:
    """The data axis' extent (dp): the world over mp."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's data index, r // mp."""
    return rank() // model_size()


def backend() -> Optional[str]:
    return dist.get_backend() if is_active() else None


def barrier() -> None:
    if is_active():
        dist.barrier()


def process_batch_slice(global_batch_size: int, index: Optional[int] = None,
                        count: Optional[int] = None) -> slice:
    """Rank ``index`` of ``count`` feeds rows [i * G / N, (i + 1) * G / N)
    of a global batch of G; raises on a batch the ranks cannot share
    equally (pad it first with ``pad_to_multiple``)."""
    count = data_size() if count is None else count
    index = data_rank() if index is None else index
    if global_batch_size % count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{count} processes; pad with pad_to_multiple() first")
    per = global_batch_size // count
    return slice(index * per, (index + 1) * per)


def pad_to_multiple(batch_size: int, n: Optional[int] = None) -> int:
    """Smallest batch size >= batch_size divisible by the data-parallel
    extent (the process count without tensor parallelism)."""
    n = n or data_size()
    return ((batch_size + n - 1) // n) * n


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, in place; returns ``t``."""
    if is_active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_LAYOUT["data_group"])
        all_reduce_sum_.launches += 1
    return t


all_reduce_sum_.launches = 0


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group (a new tensor; ``t`` itself
    without a process group).  Outside autograd: a normalizer, not a
    loss."""
    if not is_active():
        return t
    return all_reduce_sum_(t.detach().clone())


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Data index ``src``'s values into ``tensors`` on every rank of its
    data group, in place (the tensors keep their addresses): one broadcast
    per dtype and device over a flat copy."""
    if not is_active():
        return
    pg = _LAYOUT["data_group"]
    src = src * model_size() + model_rank()
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src, group=pg)
            offset = 0
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Data index ``src``'s parameters and buffers into ``module`` on every
    rank of its data group."""
    broadcast_(list(module.parameters()) + list(module.buffers()), src)


def allgather_object(obj: Any) -> List[Any]:
    """``[obj of data index 0, ..., obj of data index dp - 1]`` on every
    rank (``[obj]`` without a process group), each from model index 0 of
    its model group: the ranks' prediction maps after an eval pass over
    their rows."""
    if not is_active():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out[::model_size()]


# -- the model group's collectives ------------------------------------------

def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor; bf16 and f16 in f32)."""
    wide = t.dtype in (torch.bfloat16, torch.float16)
    out = t.float() if wide else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype) if wide else out


def _model_sum(t: torch.Tensor, counter) -> torch.Tensor:
    counter.launches += 1
    return _sum_over(t, _LAYOUT["model_group"])


def _model_gather(t: torch.Tensor, counter) -> torch.Tensor:
    """The model group's ``t`` concatenated along the last dim, in model
    index order."""
    counter.launches += 1
    mp, n = model_size(), t.shape[-1]
    group = _LAYOUT["model_group"]
    if backend() == "gloo":
        full = torch.zeros(*t.shape[:-1], mp * n, dtype=t.dtype,
                           device=t.device)
        full[..., model_rank() * n:(model_rank() + 1) * n] = t
        return _sum_over(full, group)
    parts = torch.empty(mp, *t.shape, dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(parts, t.contiguous(), group=group)
    return parts.movedim(0, -2).reshape(*t.shape[:-1], mp * n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _model_sum(dy, copy_to_model)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x, reduce_from_model)

    @staticmethod
    def backward(ctx, dy):
        return dy


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x, sum_over_model)

    @staticmethod
    def backward(ctx, dy):
        return _model_sum(dy, sum_over_model)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        return _model_gather(x, gather_from_model)

    @staticmethod
    def backward(ctx, dy):
        n = ctx.n
        return dy[..., model_rank() * n:(model_rank() + 1) * n].contiguous()


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group: the
    replicated input of a column-split product."""
    return x if model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group, the gradient passed as it is: the
    partial output of a row-split product, read by replicated layers."""
    return x if model_size() == 1 else _ReduceFromModel.apply(x)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group, and so is its gradient: a sum
    over a split dim whose readers are split too (the split LayerNorm's
    statistics)."""
    return x if model_size() == 1 else _SumOverModel.apply(x)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model group's ``x`` concatenated along the last dim; the
    gradient's slice of this rank backward."""
    return x if model_size() == 1 else _GatherFromModel.apply(x)


def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, in place, outside autograd;
    returns ``t``."""
    if model_size() > 1:
        t.copy_(_model_sum(t.detach(), model_sum_))
    return t


for _fn in (copy_to_model, reduce_from_model, sum_over_model,
            gather_from_model, model_sum_):
    _fn.launches = 0
MODEL_COLLECTIVES = (copy_to_model, reduce_from_model, sum_over_model,
                     gather_from_model, model_sum_)


def model_collectives() -> dict:
    """The model group's collectives issued so far, by function name."""
    return {fn.__name__: fn.launches for fn in MODEL_COLLECTIVES}

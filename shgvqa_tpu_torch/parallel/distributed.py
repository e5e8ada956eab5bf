"""Processes of a data-parallel run: the port of
``shgvqa_tpu/parallel/distributed.py`` on ``torch.distributed``.

One process is one rank on one device.  ``maybe_initialize_distributed``
starts the process group from the JAX package's variables::

    SHGVQA_COORDINATOR=host:port  SHGVQA_NUM_PROCESSES=N  SHGVQA_PROCESS_ID=i

(or explicit arguments): NCCL for a CUDA device, gloo for the CPU, unless
the caller names a backend.  A rank's device is ``cuda:<local rank>``, the
local rank ``SHGVQA_LOCAL_RANK`` or the rank modulo the visible GPUs.  A failed start raises; nothing falls back to one process.

Without a process group every collective here is the identity and
``world_size()`` is 1, so the single-process paths run as they did.  The
helpers the rest of the port calls:

- ``process_batch_slice`` and ``pad_to_multiple``: the JAX functions'
  decisions and errors;
- ``global_sum(t)``: ``t`` summed over the ranks (a copy; the losses'
  normalizers); ``all_reduce_sum_(t)``: in place (the step's gradients);
  ``all_reduce_sum_.launches`` counts the all-reduces issued, as a kernel
  wrapper counts its launches;
- ``broadcast_(tensors)``: rank 0's values into every rank's tensors, in
  place, one collective per dtype over a flat copy;
- ``allgather_object``: ``[obj of rank 0, ..., obj of rank N-1]``;
- ``rank``, ``world_size``, ``backend``, ``barrier``.
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
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


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
    count = world_size() if count is None else count
    index = rank() if index is None else index
    if global_batch_size % count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{count} processes; pad with pad_to_multiple() first")
    per = global_batch_size // count
    return slice(index * per, (index + 1) * per)


def pad_to_multiple(batch_size: int, n: Optional[int] = None) -> int:
    """Smallest batch size >= batch_size divisible by the process count."""
    n = n or world_size()
    return ((batch_size + n - 1) // n) * n


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; returns ``t``."""
    if is_active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        all_reduce_sum_.launches += 1
    return t


all_reduce_sum_.launches = 0


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor; ``t`` itself without a
    process group).  Outside autograd: a normalizer, not a loss."""
    if not is_active():
        return t
    return all_reduce_sum_(t.detach().clone())


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values into ``tensors`` on every rank, in place (the
    tensors keep their addresses): one broadcast per dtype and device over a
    flat copy."""
    if not is_active():
        return
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src)
            offset = 0
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into ``module`` on every rank."""
    broadcast_(list(module.parameters()) + list(module.buffers()), src)


def allgather_object(obj: Any) -> List[Any]:
    """``[obj of rank 0, ..., obj of rank N-1]`` on every rank (``[obj]``
    without a process group): the ranks' prediction maps after an eval
    pass over their rows."""
    if not is_active():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out

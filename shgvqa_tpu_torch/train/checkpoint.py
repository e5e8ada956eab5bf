"""Checkpointing with the reference's CURRENT/BEST/LAST names: the port of
``shgvqa_tpu/train/checkpoint.py``.

The trainer saves ``{output}/CURRENT`` every epoch, ``BEST`` when the
validation score it selects on improves, and ``LAST`` at exit.  Each is one
``torch.save`` file of ``{"params", "opt_state", "step"}`` (the optimizer
state included, so a run resumes where it stopped; ``params`` is the
model's state_dict, the int8 trunk's scales included), written to a temporary
name and renamed, so a reader never sees a partial file.  ``restore``
accepts a name or a path, as ``--load path/BEST`` does.  A reference
``.pth`` snapshot is not one of these files: ``Trainer.load`` sends it to
``Trainer.load_reference`` (``utils/ref_import.py``).  The JAX package's
orbax checkpoints (directories) are not read: restoring one raises.

In a data-parallel run the state is replicated: rank 0 writes each file,
and every rank waits at a barrier until it is in place, so all ranks then
read the same CURRENT, BEST and LAST.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from shgvqa_tpu_torch.parallel import distributed

CHECKPOINT_NAMES = ("CURRENT", "BEST", "LAST")


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    def save(self, name: str, state: Any) -> None:
        if distributed.rank() == 0:
            path = self.path(name)
            tmp = f"{path}.tmp.{os.getpid()}"
            torch.save(state, tmp)
            os.replace(tmp, path)
        distributed.barrier()

    def restore(self, name_or_path: str, map_location=None) -> Any:
        path = (self.path(name_or_path) if name_or_path in CHECKPOINT_NAMES
                else os.path.abspath(name_or_path))
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{name_or_path} is a directory: a JAX (orbax) checkpoint, "
                "which the port does not read (ROADMAP queue A item 1, "
                "ROADMAP C). It reads its own checkpoints, reference .pth "
                "snapshots (--load path/BEST), and JAX variables carried "
                "across by shgvqa_tpu_torch.convert.from_jax_variables")
        return torch.load(path, map_location=map_location, weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

"""The data-parallel layout: the port of ``shgvqa_tpu/parallel/mesh.py``'s
data axis.

The JAX package runs one SPMD program over a ``dp x mp`` device mesh.  Here
each rank of the ``data`` axis is a process on one device
(``parallel/distributed.py``) that holds replicated parameters and its own
rows of every global batch: rank i of N owns rows [i * G / N, (i + 1) * G /
N) of a batch of G, as JAX's ``host_shard``.  A run on N ranks is the
one-process step on the global batch with its rows split:

- ``shard_batch`` keeps a rank's rows of a global batch (``local_rows``
  of one array); the driver's ``Batcher(host_shard=...)`` builds only
  those rows in the first place;
- ``global_rows(n)``: where the rank's n rows sit in the global tensor,
  ``(rank * n, world * n)``.  Every random draw of a training step (the
  dropout masks, the augmentation, the kernels' Philox counters) is taken
  for the global tensor and sliced there, so the generators of all ranks
  stay in lockstep, each rank drops what one process would drop on its
  rows, and no two ranks share a mask.  Any tensor whose dim 0 is the
  batch, or the batch times a constant (B x L rows, B x choices), slices
  this way;
- the losses divide by sums over the global batch and the gradients are
  summed over the ranks (``losses/``, ``train/step.py``).

``make_mesh`` is the JAX function's ``dp x mp`` arithmetic.  Tensor
parallelism (``model_parallel > 1``, the JAX ``_TP_RULES``) raises
``NotImplementedError``: the port's kernels fuse the row-parallel product
with its LayerNorm (``csrc/out_ln.cu``, the FFN chain's row pass in
``csrc/ffn_train.cu``), and a split needs an all-reduce between them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from shgvqa_tpu_torch.parallel import distributed

TENSOR_PARALLEL = ("tensor parallelism (--modelParallel > 1) is not ported "
                   "yet (ROADMAP queue A position 17, item 14 (rest))")


class Mesh(NamedTuple):
    """The ``data`` x ``model`` extents of a run."""

    data: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(mesh_cfg=None, n_devices: int = 1) -> Mesh:
    """``dp x mp`` over ``n_devices`` (``data_parallel`` -1: every device
    the model axis leaves); raises when the layout does not cover them,
    and on ``model_parallel > 1``."""
    mp = max(1, getattr(mesh_cfg, "model_parallel", 1))
    if mp > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    dp = getattr(mesh_cfg, "data_parallel", -1)
    if dp == -1:
        dp = n_devices // mp
    if dp * mp != n_devices:
        raise ValueError(f"mesh {dp}x{mp} does not cover {n_devices} devices")
    return Mesh(dp, mp)


def global_rows(n_local: int) -> Tuple[int, int]:
    """(first row of this rank, rows of all ranks) of a tensor whose dim 0
    holds this rank's ``n_local`` rows: ``(0, n_local)`` in one process."""
    return distributed.rank() * n_local, distributed.world_size() * n_local


def local_rows(x, index: int = None, count: int = None):
    """This rank's rows of a global batch-first array, tensor or list."""
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

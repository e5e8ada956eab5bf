"""JAX package variables <-> a ``state_dict`` of this port.

``from_jax_variables`` takes the JAX package's ``{"params", "batch_stats"}``
trees as nested dicts of numpy arrays (``jax.device_get`` of the flax
variables) and returns torch tensors under the port's names.  The port names
its modules after the flax modules, so the map is a rename plus a transpose:

- ``Dense_0`` levels (the JAX ``Dense`` wrapper) are dropped;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kT, kH, kW, I, O) -> ``weight`` (O, I, kT, kH, kW);
- LayerNorm / BatchNorm ``scale`` -> ``weight``; ``embedding`` -> ``weight``;
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- other leaves (CLS tokens, positions, type tokens) keep their names.

With ``model`` given it raises on any key left over or missing and on any
shape that differs, before ``load_state_dict`` would.

``to_jax_variables`` is its inverse: a port ``state_dict`` becomes the JAX
package's ``{"params", "batch_stats"}`` trees of f32 numpy arrays.  The
weight importers (``utils/``) are ports of functions that merge into trees
in the JAX layout; they work on its result and ``from_jax_variables``
brings theirs back, so the port keeps one map between its names and the
JAX names.  Which JAX leaf a ``weight`` or ``bias`` came from follows from
the module's name and the rank of its ``weight``: rank 5 a Conv ``kernel``;
rank 2 an ``embedding`` under a ``*_embeddings`` table, a plain flax
``nn.Dense`` ``kernel`` under ``in_proj`` (the decoder's packed projection)
and otherwise a ``Dense_0/kernel`` of the JAX ``Dense`` wrapper (its bias in
``Dense_0`` too); rank 1 a LayerNorm or BatchNorm ``scale``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_RENAMED = {"scale": "weight", "embedding": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_KEPT = {"bias", "cls_token", "pos_embedding", "act_token", "rel_token"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
# flax nn.Dense called directly (no JAX ``Dense`` wrapper, so no Dense_0)
_PLAIN_DENSE = {"in_proj"}


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_leaf(collection: str, path, value: np.ndarray):
    *mods, leaf = [p for p in path if p != "Dense_0"]
    value = np.array(value, dtype=np.float32)
    if collection == "batch_stats":
        if leaf not in _STATS:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        return mods + [_STATS[leaf]], value
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        else:
            raise KeyError(f"kernel of rank {value.ndim} at {'/'.join(path)}")
        return mods + ["weight"], value
    if leaf in _RENAMED:
        return mods + [_RENAMED[leaf]], value
    if leaf in _KEPT:
        return mods + [leaf], value
    raise KeyError(f"unknown parameter leaf {'/'.join(path)}")


def from_jax_variables(variables: Mapping,
                       model: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dicts of numpy arrays) -> port state_dict."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            names, value = _convert_leaf(collection, path, value)
            key = ".".join(names)
            if key in state:
                raise KeyError(f"two JAX leaves map to {key}")
            state[key] = torch.from_numpy(np.ascontiguousarray(value))
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing}, "
                           f"left over {extra}")
        bad = [f"{k}: {tuple(v.shape)} vs {tuple(want[k].shape)}"
               for k, v in state.items() if v.shape != want[k].shape]
        if bad:
            raise ValueError(f"shape mismatch: {bad}")
    return state


def _jax_leaf(module: str, leaf: str, weight_rank: Optional[int]):
    """(path, collection, transpose) of the JAX leaf a port tensor came
    from."""
    mods = module.split(".") if module else []
    if leaf in _STATS_BACK:
        return mods + [_STATS_BACK[leaf]], "batch_stats", None
    if leaf not in ("weight", "bias"):
        if leaf not in _KEPT:
            raise KeyError(f"unknown parameter leaf {module}.{leaf}")
        return mods + [leaf], "params", None
    if weight_rank == 2 and mods[-1].endswith("_embeddings"):
        return mods + ["embedding"], "params", None
    if weight_rank == 2:
        if mods[-1] not in _PLAIN_DENSE:
            mods = mods + ["Dense_0"]
        if leaf == "bias":
            return mods + ["bias"], "params", None
        return mods + ["kernel"], "params", (1, 0)
    if leaf == "bias":
        return mods + ["bias"], "params", None
    if weight_rank == 5:
        return mods + ["kernel"], "params", (2, 3, 4, 1, 0)
    if weight_rank == 1:
        return mods + ["scale"], "params", None
    raise KeyError(f"weight of rank {weight_rank} at {module}")


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, dict]:
    """Port state_dict -> flax variables (nested dicts of f32 numpy
    arrays, copies): the inverse of ``from_jax_variables``.  The
    ``batch_stats`` collection is present only when the model has
    BatchNorm statistics."""
    ranks = {key[:-len(".weight")]: value.dim()
             for key, value in state_dict.items() if key.endswith(".weight")}
    variables: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        path, collection, perm = _jax_leaf(module, leaf, ranks.get(module))
        array = np.array(value.detach().float().cpu())
        if perm is not None:
            array = np.ascontiguousarray(array.transpose(perm))
        node = variables[collection]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if path[-1] in node:
            raise KeyError(f"two port tensors map to {'/'.join(path)}")
        node[path[-1]] = array
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables

"""JAX package variables -> a ``state_dict`` of this port.

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
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_RENAMED = {"scale": "weight", "embedding": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_KEPT = {"bias", "cls_token", "pos_embedding", "act_token", "rel_token"}


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

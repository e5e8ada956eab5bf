"""JAX package variables <-> a ``state_dict`` of this port.

``from_jax_variables`` takes the JAX package's ``{"params", "batch_stats"}``
trees as nested dicts of numpy arrays (``jax.device_get`` of the flax
variables) and returns torch tensors under the port's names.  The port names
its modules after the flax modules, so the map is a rename plus a transpose:

- ``Dense_0`` levels (the JAX ``Dense`` wrapper) are dropped;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kT, kH, kW, I, O) -> ``weight`` (O, I, kT, kH, kW); a
  2-D Conv ``kernel`` (kH, kW, I / groups, O) (ResNeXt) -> (O, I / groups,
  kH, kW); MViT's ``DenseGeneral`` ``qkv`` ``kernel`` (D, 3, heads, hd) ->
  ``weight`` (3, heads, hd, D), its bias (3, heads, hd) as it is;
- LayerNorm / BatchNorm ``scale`` -> ``weight``; ``embedding`` -> ``weight``;
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- other leaves (CLS tokens, positions, type tokens, EM routing's ``w``,
  ``beta_u`` and ``beta_a``, MViT's positional embeddings and pooling
  kernels ``pool_q|k|v`` (kT, kH, kW, 1, hd), Swin's
  ``relative_position_bias_table``) keep their names and layout;
- the int8 trunk's ``quant_stats`` (``backbone/s_stem``,
  ``backbone/res_i/block_j/s_a|s_b|s_out``) keep their names and paths.

With ``model`` given it raises on any key left over or missing and on any
shape that differs, before ``load_state_dict`` would; the int8 scales may
be missing or left over, as the trunk's own load takes a state dict with
or without them (``models/backbone.SlowR50``).

A tree in the scanned layout of ``--scanLayers`` (``l_stack``,
``x_stack``, ``layers/DecoderLayer_0``, ...) is first unstacked
(``models/scan_stacks.unstack``): the port runs the same per-layer modules
either way.  The pretraining model's tree (``models/pretrain.py``:
``lxrt``, ``heads/lm_head/{transform_dense, transform_ln, bias}``,
``heads/seq_relationship``, ``heads/qa_head``, ``visn_head``) follows the
same rules.

``to_jax_variables`` is its inverse (with ``scan_layers`` in the scanned
layout): a port ``state_dict`` becomes the JAX
package's ``{"params", "batch_stats"}`` trees of f32 numpy arrays (and
``quant_stats`` for an int8 trunk).  The
weight importers (``utils/``) are ports of functions that merge into trees
in the JAX layout; they work on its result and ``from_jax_variables``
brings theirs back, so the port keeps one map between its names and the
JAX names.  Which JAX leaf a ``weight`` or ``bias`` came from follows from
the module's name and the rank of its ``weight``: rank 5 a Conv ``kernel``;
rank 2 an ``embedding`` under a ``*_embeddings`` table, a plain flax
``nn.Dense`` ``kernel`` under ``in_proj`` (the decoder's packed projection),
``linear_encoding`` (the patch tokenizer), directly under an ``r_{i}``
(a ViT block's ``qkv``, ``proj``, ``fc1``, ``fc2``) and anywhere in an
MViT or Swin block (``block_{i}``, ``layer_{i}_block_{j}``) or a Swin
``downsample_{i}_reduction``, and otherwise a ``Dense_0/kernel`` of the
JAX ``Dense`` wrapper (its bias in ``Dense_0`` too); rank 4 MViT's
``qkv`` kernel or a 2-D Conv ``kernel``; rank 1 a LayerNorm or BatchNorm
``scale``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from shgvqa_tpu_torch.models import scan_stacks

_RENAMED = {"scale": "weight", "embedding": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_KEPT = {"bias", "cls_token", "pos_embedding", "act_token", "rel_token",
         "w", "beta_u", "beta_a", "pos_embed_spatial", "pos_embed_temporal",
         "pos_embed_class", "pool_q", "pool_k", "pool_v",
         "relative_position_bias_table"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
# flax nn.Dense called directly (no JAX ``Dense`` wrapper, so no Dense_0):
# by name, or any dense layer right under an r-layer (a ViT block's)
_PLAIN_DENSE = {"in_proj", "linear_encoding"}
_VIT_BLOCK = re.compile(r"r_\d+")
# the MViT and Swin trunks' blocks and Swin's patch-merging reduction
_TRUNK_BLOCK = re.compile(r"(layer_\d+_)?block_\d+|downsample_\d+_reduction")
# MViT's fused qkv (flax ``DenseGeneral``), the one rank-4 kernel not a conv
_DENSE_GENERAL = "qkv"


def _plain_dense(mods) -> bool:
    return (mods[-1] in _PLAIN_DENSE
            or (len(mods) > 1 and _VIT_BLOCK.fullmatch(mods[-2]) is not None)
            or any(_TRUNK_BLOCK.fullmatch(m) for m in mods))
# the int8 trunk's activation scales (the JAX ``quant_stats`` leaves)
QUANT_STATS = ("s_stem", "s_a", "s_b", "s_out")
_COLLECTIONS = ("params", "batch_stats", "quant_stats")


def is_quant_scale(key: str) -> bool:
    """Whether a state_dict key is one of the int8 trunk's scales."""
    return key.rpartition(".")[2] in QUANT_STATS


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_leaf(collection: str, path, value: np.ndarray):
    *mods, leaf = [p for p in path if p != "Dense_0"]
    value = np.array(value, dtype=np.float32)
    if collection == "quant_stats":
        if leaf not in QUANT_STATS:
            raise KeyError(f"unknown quant_stats leaf {'/'.join(path)}")
        return mods + [leaf], value
    if collection == "batch_stats":
        if leaf not in _STATS:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        return mods + [_STATS[leaf]], value
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        elif value.ndim == 4 and mods[-1] == _DENSE_GENERAL:
            value = value.transpose(1, 2, 3, 0)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
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
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for collection in _COLLECTIONS:
        tree = scan_stacks.unstack(variables.get(collection, {}))
        for path, value in _leaves(tree):
            names, value = _convert_leaf(collection, path, value)
            key = ".".join(names)
            if key in state:
                raise KeyError(f"two JAX leaves map to {key}")
            # ascontiguousarray makes a scalar (a quant_stats leaf) 1-d
            state[key] = torch.from_numpy(
                np.ascontiguousarray(value)).reshape(value.shape)
    if model is not None:
        want = model.state_dict()
        missing = sorted(k for k in set(want) - set(state)
                         if not is_quant_scale(k))
        extra = sorted(k for k in set(state) - set(want)
                       if not is_quant_scale(k))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing}, "
                           f"left over {extra}")
        bad = [f"{k}: {tuple(v.shape)} vs {tuple(want[k].shape)}"
               for k, v in state.items()
               if k in want and v.shape != want[k].shape]
        if bad:
            raise ValueError(f"shape mismatch: {bad}")
    return state


def _jax_leaf(module: str, leaf: str, weight_rank: Optional[int]):
    """(path, collection, transpose) of the JAX leaf a port tensor came
    from."""
    mods = module.split(".") if module else []
    if leaf in QUANT_STATS:
        return mods + [leaf], "quant_stats", None
    if leaf in _STATS_BACK:
        return mods + [_STATS_BACK[leaf]], "batch_stats", None
    if leaf not in ("weight", "bias"):
        if leaf not in _KEPT:
            raise KeyError(f"unknown parameter leaf {module}.{leaf}")
        return mods + [leaf], "params", None
    if weight_rank == 2 and mods[-1].endswith("_embeddings"):
        return mods + ["embedding"], "params", None
    if weight_rank == 2:
        if not _plain_dense(mods):
            mods = mods + ["Dense_0"]
        if leaf == "bias":
            return mods + ["bias"], "params", None
        return mods + ["kernel"], "params", (1, 0)
    if leaf == "bias":
        return mods + ["bias"], "params", None
    if weight_rank == 5:
        return mods + ["kernel"], "params", (2, 3, 4, 1, 0)
    if weight_rank == 4 and mods[-1] == _DENSE_GENERAL:
        return mods + ["kernel"], "params", (3, 0, 1, 2)
    if weight_rank == 4:
        return mods + ["kernel"], "params", (2, 3, 1, 0)
    if weight_rank == 1:
        return mods + ["scale"], "params", None
    raise KeyError(f"weight of rank {weight_rank} at {module}")


def to_jax_variables(state_dict: Mapping[str, torch.Tensor],
                     scan_layers: bool = False) -> Dict[str, dict]:
    """Port state_dict -> flax variables (nested dicts of f32 numpy
    arrays, copies): the inverse of ``from_jax_variables``, in the scanned
    layout with ``scan_layers``.  The ``batch_stats`` collection is present
    only when the model has BatchNorm statistics, ``quant_stats`` only when
    it has int8 scales."""
    ranks = {key[:-len(".weight")]: value.dim()
             for key, value in state_dict.items() if key.endswith(".weight")}
    variables: Dict[str, dict] = {c: {} for c in _COLLECTIONS}
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
    for collection in _COLLECTIONS[1:]:
        if not variables[collection]:
            del variables[collection]
    if scan_layers:
        variables["params"] = scan_stacks.stack(variables["params"])
    return variables

"""The JAX package's scanned parameter layout (``--scanLayers``): the map
between it and the unscanned layout, for ``convert.py``.

JAX's ``shgvqa_tpu/models/scan_stacks.py`` runs homogeneous stacks under
``nn.scan``, which compiles one body and gives its parameters a leading
layer axis, or broadcasts one set for a weight-tied stack.  Torch has no
scan to compile, so the port runs the same per-layer modules whatever the
flag says; only the JAX trees differ:

- ``lxrt/encoder/l_stack/layers/BertLayer_0`` (and ``r_stack``): the
  ``l_{i}`` (``r_{i}``) stacked on a leading axis;
- ``lxrt/encoder/x_stack/x_tied/CrossLayer_0``: the tied ``x_tied`` as it is
  (broadcast); ``x_stack/x_layers/CrossLayer_0`` the untied ``x_{i}``
  stacked.  Only 'cross' and 'old' (``CrossLayer``) scan: 'self' and
  'cross_self' change their sequence shapes at step 0 and stay unrolled;
- ``hgq_encoder/x_stack/x_tied/CrossLayer_0``: the HG encoder's ``x_tied``
  under 'cross' / 'old';
- ``rel_decoder/layers/DecoderLayer_0`` (and ``action_decoder``): the
  ``layer_{i}`` stacked.

Task 'q''s ``bert_encoder`` does not scan.  A video model nests these under
``head``; the pretraining model's encoder is ``lxrt`` too.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np

_CROSS_LAYER = "CrossLayer_0"


def _stack(trees: List[Mapping]) -> dict:
    first = trees[0]
    return {key: (_stack([t[key] for t in trees])
                  if isinstance(first[key], Mapping)
                  else np.stack([np.asarray(t[key]) for t in trees]))
            for key in first}


def _slice(tree: Mapping, i: int) -> dict:
    return {key: (_slice(value, i) if isinstance(value, Mapping)
                  else np.asarray(value)[i])
            for key, value in tree.items()}


def _depth(tree: Mapping) -> int:
    value = next(iter(tree.values()))
    return _depth(value) if isinstance(value, Mapping) else len(value)


def _numbered(tree: Mapping, prefix: str) -> List[str]:
    pattern = re.compile(re.escape(prefix) + r"(\d+)")
    found = sorted((int(m.group(1)), key) for key in tree
                   if (m := pattern.fullmatch(key)))
    return [key for _, key in found]


def _is_cross_layer(tree: Mapping) -> bool:
    # 'cross' / 'old' build CrossLayer (one shared attention, two FFNs)
    return "visual_attention" in tree and "lang_ffn" in tree


def unstack(tree: Mapping) -> dict:
    """A JAX parameter tree in the scanned layout -> the unscanned layout
    (a tree without scanned stacks comes back equal)."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key in ("l_stack", "r_stack"):
            body = value["layers"]["BertLayer_0"]
            for i in range(_depth(body)):
                out[f"{key[0]}_{i}"] = _slice(body, i)
        elif key == "x_stack":
            if "x_tied" in value:
                out["x_tied"] = unstack(value["x_tied"][_CROSS_LAYER])
            else:
                body = value["x_layers"][_CROSS_LAYER]
                for i in range(_depth(body)):
                    out[f"x_{i}"] = _slice(body, i)
        elif key == "layers" and "DecoderLayer_0" in value:
            body = value["DecoderLayer_0"]
            for i in range(_depth(body)):
                out[f"layer_{i}"] = _slice(body, i)
        else:
            out[key] = unstack(value)
    return out


def _stack_encoder(enc: Mapping) -> dict:
    out = {k: v for k, v in enc.items()
           if not re.fullmatch(r"[lrx]_\d+|x_tied", k)}
    for prefix in ("l", "r"):
        names = _numbered(enc, f"{prefix}_")
        if names:
            out[f"{prefix}_stack"] = {"layers": {"BertLayer_0": _stack(
                [enc[n] for n in names])}}
    xs = _numbered(enc, "x_")
    tied = enc.get("x_tied")
    if tied is not None and _is_cross_layer(tied):
        out["x_stack"] = {"x_tied": {_CROSS_LAYER: tied}}
    elif xs and _is_cross_layer(enc[xs[0]]):
        out["x_stack"] = {"x_layers": {_CROSS_LAYER: _stack(
            [enc[n] for n in xs])}}
    else:
        out.update({n: enc[n] for n in xs})
        if tied is not None:
            out["x_tied"] = tied
    return out


def stack(tree: Mapping) -> dict:
    """A JAX parameter tree in the unscanned layout -> the scanned layout
    JAX builds under ``scan_layers=True``."""
    out: Dict[str, object] = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key == "lxrt":
            out[key] = {k: (_stack_encoder(v) if k == "encoder" else v)
                        for k, v in value.items()}
        elif key in ("rel_decoder", "action_decoder"):
            names = _numbered(value, "layer_")
            out[key] = {"layers": {"DecoderLayer_0": _stack(
                [value[n] for n in names])}}
        elif key == "hgq_encoder" and _is_cross_layer(value["x_tied"]):
            out[key] = {k: v for k, v in value.items() if k != "x_tied"}
            out[key]["x_stack"] = {"x_tied": {_CROSS_LAYER: value["x_tied"]}}
        else:
            out[key] = stack(value)
    return out

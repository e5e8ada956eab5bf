"""Pretrained BERT weights into the port's language tower: the port of
``shgvqa_tpu/utils/torch_import.py`` (its BERT half).

The reference's default path (no ``--fromScratch``) loads bert-base-uncased
into its LXRT model by name (``BertPreTrainedModel.from_pretrained``): the
``bert.`` prefix is stripped, the legacy LayerNorm names ``gamma``/``beta``
become ``weight``/``bias``, and every parameter whose name exists in the
model is overwritten: the text embeddings, as many ``encoder.layer.{i}``
BertLayers as both sides have (-> ``l_{i}``), and ``pooler.dense`` only
where the model's pooler has a ``dense`` (the cross pooler's ``dense2``
never matches, so bert's pooler lands in ``skipped``).  The visual stream,
the cross layers and the tokenizer keep their init.

The functions work on trees in the JAX layout (``convert.to_jax_variables``
of the port's ``state_dict``; ``convert.from_jax_variables`` brings the
result back).  The ViT half (``vit_block_params``, ``vit_to_r_layers``)
comes with ``--vitInit`` (ROADMAP queue A item 17).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file -> {name: np.ndarray}: a torch ``state_dict``
    (``torch.load(weights_only=True)``) or an ``.npz`` with the same
    names."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def normalize_bert_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """gamma -> weight, beta -> bias, and a leading ``bert.`` stripped."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if "gamma" in key:
            key = key.replace("gamma", "weight")
        if "beta" in key:
            key = key.replace("beta", "bias")
        if key.startswith("bert."):
            key = key[len("bert."):]
        out[key] = np.asarray(val)
    return out


def _dense(sd, prefix):
    return {"Dense_0": {"kernel": sd[f"{prefix}.weight"].T,
                        "bias": sd[f"{prefix}.bias"]}}


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _bert_layer(sd, prefix):
    """A torch BertLayer's slice -> the BertLayer tree."""
    return {
        "attention": {
            "self": {
                "query": _dense(sd, f"{prefix}.attention.self.query"),
                "key": _dense(sd, f"{prefix}.attention.self.key"),
                "value": _dense(sd, f"{prefix}.attention.self.value"),
            },
            "output": {
                "dense": _dense(sd, f"{prefix}.attention.output.dense"),
                "ln": _ln(sd, f"{prefix}.attention.output.LayerNorm"),
            },
        },
        "ffn": {
            "intermediate": _dense(sd, f"{prefix}.intermediate.dense"),
            "output": _dense(sd, f"{prefix}.output.dense"),
            "ln": _ln(sd, f"{prefix}.output.LayerNorm"),
        },
    }


def _merge(dst: Dict[str, Any], src: Dict[str, Any], path: str,
           loaded: List[str], skipped: List[str]) -> None:
    """Overwrite dst leaves from src where names and shapes match."""
    for key, val in src.items():
        here = f"{path}/{key}" if path else key
        if key not in dst:
            skipped.append(f"{here} (not in model)")
            continue
        if isinstance(val, dict):
            _merge(dst[key], val, here, loaded, skipped)
            continue
        cur = dst[key]
        if tuple(np.shape(cur)) != tuple(np.shape(val)):
            skipped.append(
                f"{here} (shape {np.shape(val)} vs model {np.shape(cur)})")
            continue
        dst[key] = np.asarray(val, dtype=np.asarray(cur).dtype)
        loaded.append(here)


def copy_tree(tree):
    """The dicts of a tree copied, its leaves shared (the merges replace
    leaves and never write into them)."""
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    return tree


def bert_to_lxrt_params(
    sd: Dict[str, np.ndarray],
    lxrt_params: Dict[str, Any],
    num_layers: int | None = None,
) -> Tuple[Dict[str, Any], Dict[str, List[str]]]:
    """Overwrite an LXRTModel (or LanguageEncoder) param tree (JAX layout)
    with bert weights; returns (new_params, {"loaded": [...], "skipped":
    [...]})."""
    sd = normalize_bert_keys(sd)
    params = copy_tree(lxrt_params)
    loaded: List[str] = []
    skipped: List[str] = []

    src: Dict[str, Any] = {}
    if "embeddings.word_embeddings.weight" in sd:
        src["embeddings"] = {
            "word_embeddings": {
                "embedding": sd["embeddings.word_embeddings.weight"]},
            "position_embeddings": {
                "embedding": sd["embeddings.position_embeddings.weight"]},
            "token_type_embeddings": {
                "embedding": sd["embeddings.token_type_embeddings.weight"]},
            "ln": _ln(sd, "embeddings.LayerNorm"),
        }

    # the l_{i} layers sit under "encoder" in LXRTModel, at the top of
    # LanguageEncoder
    enc_dst = params.get("encoder", params)
    n_avail = 0
    while f"encoder.layer.{n_avail}.attention.self.query.weight" in sd:
        n_avail += 1
    n_model = 0
    while f"l_{n_model}" in enc_dst:
        n_model += 1
    n = min(n_avail, n_model) if num_layers is None \
        else min(num_layers, n_avail, n_model)
    enc_src = {f"l_{i}": _bert_layer(sd, f"encoder.layer.{i}")
               for i in range(n)}
    if "encoder" in params:
        src["encoder"] = enc_src
    else:
        src.update(enc_src)

    if "pooler.dense.weight" in sd:
        src["pooler"] = {"dense": _dense(sd, "pooler.dense")}

    _merge(params, src, "", loaded, skipped)
    return params, {"loaded": loaded, "skipped": skipped}

"""Pretrained BERT and ViT weights into the port's encoder: the port of
``shgvqa_tpu/utils/torch_import.py``.

The reference's default path (no ``--fromScratch``) loads bert-base-uncased
into its LXRT model by name (``BertPreTrainedModel.from_pretrained``): the
``bert.`` prefix is stripped, the legacy LayerNorm names ``gamma``/``beta``
become ``weight``/``bias``, and every parameter whose name exists in the
model is overwritten: the text embeddings, as many ``encoder.layer.{i}``
BertLayers as both sides have (-> ``l_{i}``), and ``pooler.dense`` only
where the model's pooler has a ``dense`` (the cross pooler's ``dense2``
never matches, so bert's pooler lands in ``skipped``).  The visual stream,
the cross layers and the tokenizer keep their init.

``--vitInit``: ``vit_to_r_layers`` takes a timm ``vit_base_patch32_224``
state_dict's ``blocks[start_index:start_index + n]`` as the n ViT r-layers
(``models/vit.ViTBlock``), as the reference's ``load_vit_layers`` does
(``--startIndex`` 7 by default: five r-layers get the last five blocks).

The functions work on trees in the JAX layout (``convert.to_jax_variables``
of the port's ``state_dict``; ``convert.from_jax_variables`` brings the
result back).
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


def vit_block_params(sd: Dict[str, np.ndarray], prefix: str
                     ) -> Dict[str, Any]:
    """One timm ViT ``blocks.{i}`` state_dict slice -> a ViTBlock tree
    (norm1 / qkv / proj / norm2 / fc1 / fc2, plain dense layers: no
    ``Dense_0``; torch Linear weights transposed)."""
    def dense(name):
        return {"kernel": sd[f"{prefix}.{name}.weight"].T,
                "bias": sd[f"{prefix}.{name}.bias"]}

    return {"norm1": _ln(sd, f"{prefix}.norm1"), "qkv": dense("attn.qkv"),
            "proj": dense("attn.proj"), "norm2": _ln(sd, f"{prefix}.norm2"),
            "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2")}


def vit_to_r_layers(sd: Dict[str, np.ndarray], num_layers: int,
                    start_index: int = 0) -> Dict[str, Any]:
    """A timm ViT state_dict -> {"r_0": ..., "r_{n-1}"} ViTBlock trees from
    ``blocks[start_index:start_index + num_layers]``; raises where the
    checkpoint has fewer blocks (the reference's assert)."""
    n_avail = 0
    while f"blocks.{n_avail}.norm1.weight" in sd:
        n_avail += 1
    if num_layers + start_index > n_avail:
        raise ValueError(
            f"cannot take {num_layers} blocks from index {start_index}: "
            f"checkpoint has {n_avail} (reference assert, "
            f"modeling_capsbert.py:1383-1385)")
    return {f"r_{i}": vit_block_params(sd, f"blocks.{start_index + i}")
            for i in range(num_layers)}

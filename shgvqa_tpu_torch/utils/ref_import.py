"""A trained reference checkpoint into the port: the port of
``shgvqa_tpu/utils/ref_import.py``.

The reference saves ``torch.save(model.state_dict(), {name}.pth)`` and
evaluates with ``--load path/BEST``, which appends ``.pth`` and strips the
DataParallel ``module.`` prefixes.  ``reference_to_variables`` maps such a
state_dict onto the model's variables in the JAX layout
(``convert.to_jax_variables`` of the port's ``state_dict``; its result goes
back through ``convert.from_jax_variables``, strictly).  What the mapping
encodes:

- torch ``nn.Linear`` weights are (out, in), the JAX kernels (in, out);
  Conv3d weights (O, I, kT, kH, kW) become (kT, kH, kW, I, O);
- the reference's x-layers are N references to one module, so every
  ``x_layers.{i}`` holds the same tensors: ``x_layers.0`` is read into the
  tied ``x_tied``;
- ``pooler_dict`` and ``cross_attn_layer`` are ModuleDicts of every cross
  variant, with live parameters: only ``cross`` (its pooler's ``dense2``)
  is read;
- the tokenizer's ``position_encoding.pe.weight`` is sliced to the first
  ``visual_seq_length`` rows; ``visn_fc.conv.1`` and ``visn_fc.conv.4``
  are its two Conv3d layers;
- leaves are cast to the destination's dtype (the f32 parameters);
- the trunk travels inside the checkpoint (``vid_encoder.backbone.*``) and
  goes through ``utils/convert_slow_r50.convert``; its BatchNorm
  statistics are merged with ``allow_new``.

A leaf of another shape raises ``ValueError``, a destination the model does
not have ``KeyError``.  What the port does not run raises
``NotImplementedError`` naming its ROADMAP queue-A item: task ``q``, the
cross variants other than ``cross``, and the other backbones' converters.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from shgvqa_tpu_torch.utils import convert_slow_r50
from shgvqa_tpu_torch.utils.torch_import import (
    _bert_layer,
    _dense,
    _ln,
    copy_tree,
    load_torch_state_dict,
)


def strip_module_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The DataParallel ``module.`` prefix stripped from every name."""
    return {(k.replace("module.", "") if "module." in k else k): v
            for k, v in sd.items()}


def reference_checkpoint_path(path: str) -> str:
    """``path``, or ``path.pth`` when only that exists: the reference's
    extensionless ``--load path/BEST`` spelling."""
    if not os.path.isfile(path) and os.path.isfile(path + ".pth"):
        return path + ".pth"
    return path


def is_reference_checkpoint(path: str) -> bool:
    """Whether ``--load path`` names a reference ``.pth`` snapshot."""
    return reference_checkpoint_path(path).endswith(".pth")


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (or an ``.npz`` with the same names) ->
    {name: np.ndarray}, ``module.`` prefixes stripped."""
    return strip_module_prefix(
        load_torch_state_dict(reference_checkpoint_path(path)))


def _cross_layer(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """One reference cross-modal layer of the 'cross' variant (shared
    bidirectional cross-attention) -> the CrossLayer tree."""

    def att(p):
        return {"query": _dense(sd, f"{p}.query"),
                "key": _dense(sd, f"{p}.key"),
                "value": _dense(sd, f"{p}.value")}

    def att_out(p):
        return {"dense": _dense(sd, f"{p}.dense"),
                "ln": _ln(sd, f"{p}.LayerNorm")}

    def ffn(inter_p, out_p):
        return {"intermediate": _dense(sd, f"{inter_p}.dense"),
                "output": _dense(sd, f"{out_p}.dense"),
                "ln": _ln(sd, f"{out_p}.LayerNorm")}

    return {
        "visual_attention": {
            "att": att(f"{prefix}.visual_attention.att"),
            "output": att_out(f"{prefix}.visual_attention.output"),
        },
        "lang_ffn": ffn(f"{prefix}.lang_inter", f"{prefix}.lang_output"),
        "visn_ffn": ffn(f"{prefix}.visn_inter", f"{prefix}.visn_output"),
    }


def _decoder_layer(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """A reference TransformerDecoderLayer -> the decoder layer tree (torch
    MultiheadAttention's packed in_proj)."""
    out = {}
    for name in ("self_attn", "multihead_attn"):
        out[name] = {
            "in_proj": {"kernel": sd[f"{prefix}.{name}.in_proj_weight"].T,
                        "bias": sd[f"{prefix}.{name}.in_proj_bias"]},
            "out_proj": _dense(sd, f"{prefix}.{name}.out_proj"),
        }
    out["linear1"] = _dense(sd, f"{prefix}.linear1")
    out["linear2"] = _dense(sd, f"{prefix}.linear2")
    for i in (1, 2, 3):
        out[f"norm{i}"] = _ln(sd, f"{prefix}.norm{i}")
    return out


def _mlp_head(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """A classifier head: Sequential(Linear, GeLU, LayerNorm, Linear)."""
    return {"fc1": _dense(sd, f"{prefix}.0"),
            "ln": _ln(sd, f"{prefix}.2"),
            "fc2": _dense(sd, f"{prefix}.3")}


def _hg_embeddings(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    return {
        "word_embeddings": {
            "embedding": sd[f"{prefix}.word_embeddings.weight"]},
        "token_type_embeddings": {
            "embedding": sd[f"{prefix}.token_type_embeddings.weight"]},
        "ln": _ln(sd, f"{prefix}.LayerNorm"),
    }


def _encoder_prefix(sd: Dict[str, np.ndarray]) -> str:
    """The task-dependent encoder attribute of the reference model."""
    for name in ("lxrt_encoder", "deaf_encoder", "bert_encoder"):
        if any(k.startswith(f"{name}.model.bert.") for k in sd):
            return f"{name}.model.bert"
    raise ValueError(
        "no reference encoder found in state_dict (expected keys under "
        "lxrt_encoder/deaf_encoder/bert_encoder .model.bert.*)")


def _convert_backbone(sd: Dict[str, np.ndarray], backbone: str
                      ) -> Dict[str, Any]:
    """The checkpoint's trunk (``vid_encoder.backbone.*``) through the
    standalone converter."""
    sub = {k[len("vid_encoder.backbone."):]: v for k, v in sd.items()
           if k.startswith("vid_encoder.backbone.")}
    if not sub:
        return {}
    if backbone != "slow_r50":
        raise NotImplementedError(
            f"importing a {backbone!r} trunk is not ported yet (ROADMAP "
            "queue A item 17: tools/convert_slowfast.py, "
            "tools/convert_resnext101.py)")
    return convert_slow_r50.convert(sub)


def reference_to_variables(
    sd: Dict[str, np.ndarray],
    variables: Dict[str, Any],
    cfg,
) -> Tuple[Dict[str, Any], Dict[str, List[str]]]:
    """A reference AGQAModel state_dict onto ``variables`` ({"params",
    "batch_stats"?} in the JAX layout, not modified); returns
    (new_variables, {"mapped": [...], "skipped": [...]})."""
    if cfg.task == "q":
        raise NotImplementedError(
            "importing a task 'q' checkpoint is not ported yet (ROADMAP "
            "queue A item 15)")
    cat = cfg.encoder.cross_attn_type
    if cat != "cross":
        raise NotImplementedError(
            f"importing a cross_attn_type {cat!r} checkpoint is not ported "
            "yet (ROADMAP queue A item 15); the port reads 'cross'")
    sd = {k: np.asarray(v) for k, v in strip_module_prefix(sd).items()}
    variables = copy_tree(variables)
    params = variables["params"]
    head = params["head"] if "head" in params else params
    report: Dict[str, List[str]] = {"mapped": [], "skipped": []}

    _fill_lxrt(sd, _encoder_prefix(sd), head["lxrt"], cfg.encoder, report)

    if "hgq_encoder" in head:
        hq = "hgq_encoder"
        hgq: Dict[str, Any] = {
            "act_token": sd[f"{hq}.act_token"],
            "rel_token": sd[f"{hq}.rel_token"],
            "cls_token": sd[f"{hq}.cls_token"],
            "x_tied": _cross_layer(sd, f"{hq}.cross_attn_layer.cross"),
            "pooler": {"dense2": _dense(sd, f"{hq}.pooler_dict.cross.dense2")},
        }
        _strict_merge(head[hq], hgq, hq, report)

    for name in ("relation_query_embed", "action_query_embed"):
        if name in head and f"{name}.word_embeddings.weight" in sd:
            _strict_merge(head[name], _hg_embeddings(sd, name), name, report)

    for name in ("rel_decoder", "action_decoder"):
        if name in head and f"{name}.layers.0.linear1.weight" in sd:
            tree = {f"layer_{i}": _decoder_layer(sd, f"{name}.layers.{i}")
                    for i in range(cfg.decoder.num_layers)}
            _strict_merge(head[name], tree, name, report)

    for name in ("class_embed", "action_embed", "logit_fc"):
        if name in head and f"{name}.0.weight" in sd:
            _strict_merge(head[name], _mlp_head(sd, name), name, report)

    if "backbone" in params:
        bb = _convert_backbone(sd, cfg.backbone)
        if bb:
            _strict_merge(params["backbone"], bb["params"],
                          "backbone", report)
            if bb.get("batch_stats"):
                _strict_merge(
                    variables.setdefault("batch_stats", {})
                    .setdefault("backbone", {}),
                    bb["batch_stats"], "backbone/batch_stats", report,
                    allow_new=True)
        else:
            report["skipped"].append(
                "backbone (no vid_encoder.backbone.* keys in checkpoint)")

    return variables, report


def _fill_lxrt(sd, ref_enc: str, lxrt: Dict[str, Any], enc_cfg,
               report) -> None:
    n_vis = enc_cfg.visual_seq_length
    tree: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": {
                "embedding": sd[f"{ref_enc}.embeddings.word_embeddings"
                                ".weight"]},
            "position_embeddings": {
                "embedding": sd[f"{ref_enc}.embeddings.position_embeddings"
                                ".weight"]},
            "token_type_embeddings": {
                "embedding": sd[f"{ref_enc}.embeddings.token_type_embeddings"
                                ".weight"]},
            "ln": _ln(sd, f"{ref_enc}.embeddings.LayerNorm"),
        },
    }
    enc: Dict[str, Any] = {}
    if f"{ref_enc}.encoder.visn_fc.conv.1.weight" in sd:
        enc["visual_tokenizer"] = {
            "conv1": {
                "kernel": sd[f"{ref_enc}.encoder.visn_fc.conv.1.weight"]
                .transpose(2, 3, 4, 1, 0),
                "bias": sd[f"{ref_enc}.encoder.visn_fc.conv.1.bias"]},
            "conv2": {
                "kernel": sd[f"{ref_enc}.encoder.visn_fc.conv.4.weight"]
                .transpose(2, 3, 4, 1, 0),
                "bias": sd[f"{ref_enc}.encoder.visn_fc.conv.4.bias"]},
            "cls_token": sd[f"{ref_enc}.encoder.visn_fc.cls_token"],
            "pos_embedding": sd[
                f"{ref_enc}.encoder.visn_fc.position_encoding.pe.weight"
            ][:n_vis],
        }
    for i in range(enc_cfg.l_layers):
        enc[f"l_{i}"] = _bert_layer(sd, f"{ref_enc}.encoder.layer.{i}")
    for i in range(enc_cfg.r_layers):
        if f"{ref_enc}.encoder.r_layers.{i}.attention.self.query.weight" in sd:
            enc[f"r_{i}"] = _bert_layer(sd, f"{ref_enc}.encoder.r_layers.{i}")
    # every x_layers.{i} aliases one module: the first is the tied layer
    enc["x_tied"] = _cross_layer(sd, f"{ref_enc}.encoder.x_layers.0")
    tree["encoder"] = enc
    tree["pooler"] = {"dense2": _dense(
        sd, f"{ref_enc}.pooler_dict.cross.dense2")}
    _strict_merge(lxrt, tree, "lxrt", report)


def _strict_merge(dst: Dict[str, Any], src: Dict[str, Any], path: str,
                  report, allow_new: bool = False) -> None:
    """Overwrite dst leaves from src; a destination the model does not have
    or a shape that differs is an error (the reference's strict load)."""
    for key, val in src.items():
        here = f"{path}/{key}"
        if key not in dst:
            if allow_new:
                dst[key] = val
                continue
            raise KeyError(f"{here}: not in model params - config/topology "
                           "mismatch with the checkpoint")
        if isinstance(val, dict) and isinstance(dst[key], dict):
            _strict_merge(dst[key], val, here, report, allow_new)
            continue
        want, got = tuple(np.shape(dst[key])), tuple(np.shape(val))
        if want != got:
            raise ValueError(
                f"{here}: checkpoint shape {got} vs model {want} - wrong "
                "dims/flags for this checkpoint")
        dst[key] = np.asarray(val, dtype=np.asarray(dst[key]).dtype)
        report["mapped"].append(here)

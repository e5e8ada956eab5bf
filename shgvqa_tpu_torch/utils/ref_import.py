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
- the encoder's prefix follows the task: ``lxrt_encoder`` (hgqa, vqa,
  hgvqa), ``deaf_encoder`` (vhga), ``bert_encoder`` (q, whose
  BertFeatureExtraction holds embeddings, ``encoder.layer.{i}`` and a
  single-CLS pooler);
- the reference's x-layers are N references to one module, so every
  ``x_layers.{i}`` holds the same tensors: ``x_layers.0`` is read into the
  tied ``x_tied``; an untied model reads ``x_layers.{i}`` into each
  ``x_{i}`` (``x_layers.0`` where an index is absent);
- ``pooler_dict`` and ``cross_attn_layer`` are ModuleDicts of every cross
  variant, with live parameters: only the configured ``cross_attn_type``
  is read (its pooler's ``dense2`` under 'cross', ``dense`` otherwise);
  'old' is the 'cross' layer under its own key;
- ``--linearCls`` heads are one ``nn.Linear`` (``class_embed.weight``),
  the others ``Sequential(Linear, GeLU, LayerNorm, Linear)``;
- the tokenizer's ``position_encoding.pe.weight`` is sliced to the first
  ``visual_seq_length`` rows; ``visn_fc.conv.1`` and ``visn_fc.conv.4``
  are its two Conv3d layers;
- leaves are cast to the destination's dtype (the f32 parameters);
- the trunk travels inside the checkpoint (``vid_encoder.backbone.*``) and
  goes through its converter (``utils/convert_slow_r50``,
  ``convert_slowfast`` with slowfast_r50's or slowfast_r101's depths,
  ``convert_resnext101``), as the JAX importer does; its BatchNorm
  statistics are merged with ``allow_new``.  An mvit_B or video_swin_impl
  trunk in a checkpoint raises ``NotImplementedError``: convert it
  separately and load it with ``--backboneWeights``.

A leaf of another shape raises ``ValueError``, a destination the model does
not have ``KeyError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from shgvqa_tpu_torch.utils import (
    convert_resnext101,
    convert_slow_r50,
    convert_slowfast,
)
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


def _cross_layer(sd: Dict[str, np.ndarray], prefix: str,
                 cross_attn_type: str) -> Dict[str, Any]:
    """One reference cross-modal layer -> the tree of the port's layer of
    that type: 'cross' / 'old' ``CrossLayer``, 'self' ``SelfCrossLayer``,
    'cross_self' ``CrossAndSelfLayer``."""

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

    def block(name, core):
        return {core: att(f"{prefix}.{name}.{core}"),
                "output": att_out(f"{prefix}.{name}.output")}

    if cross_attn_type in ("cross", "old"):
        return {"visual_attention": block("visual_attention", "att"),
                "lang_ffn": ffn(f"{prefix}.lang_inter",
                                f"{prefix}.lang_output"),
                "visn_ffn": ffn(f"{prefix}.visn_inter",
                                f"{prefix}.visn_output")}
    vl_ffn = ffn(f"{prefix}.vl_inter", f"{prefix}.vl_output")
    if cross_attn_type == "self":
        return {"cross_att": block("cross_att", "self"), "vl_ffn": vl_ffn}
    if cross_attn_type == "cross_self":
        return {"visual_attention": block("visual_attention", "att"),
                "self_att_layer": block("self_att_layer", "self"),
                "vl_ffn": vl_ffn}
    raise ValueError(f"unknown cross_attn_type {cross_attn_type!r}")


def _x_layers(sd: Dict[str, np.ndarray], prefix: str, dst: Dict[str, Any],
              cross_attn_type: str) -> Dict[str, Any]:
    """The x-layers the model has (``x_tied``, or the untied ``x_{i}``)
    from the reference's ``{prefix}.{i}``; an index the checkpoint lacks
    reads index 0 (every index aliases one module there)."""
    out = {}
    for key in dst:
        if not key.startswith("x_"):
            continue
        i = 0 if key == "x_tied" else int(key[2:])
        if not any(k.startswith(f"{prefix}.{i}.") for k in sd):
            i = 0
        out[key] = _cross_layer(sd, f"{prefix}.{i}", cross_attn_type)
    return out


def _pooler(sd: Dict[str, np.ndarray], prefix: str,
            cross_attn_type: str) -> Dict[str, Any]:
    """The configured variant's pooler of ``{prefix}.pooler_dict``."""
    key = "dense2" if cross_attn_type == "cross" else "dense"
    return {key: _dense(sd, f"{prefix}.pooler_dict.{cross_attn_type}.{key}")}


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
    """A classifier head: Sequential(Linear, GeLU, LayerNorm, Linear), or
    one Linear (``--linearCls``)."""
    if f"{prefix}.weight" in sd:
        return _dense(sd, prefix)
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
    standalone converters."""
    sub = {k[len("vid_encoder.backbone."):]: v for k, v in sd.items()
           if k.startswith("vid_encoder.backbone.")}
    if not sub:
        return {}
    if backbone == "slow_r50":
        return convert_slow_r50.convert(sub)
    if backbone.startswith("slowfast"):
        depth = 101 if backbone.endswith("r101") else 50
        return convert_slowfast.convert(sub, convert_slowfast.DEPTHS[depth])
    if backbone == "resnext101":
        return convert_resnext101.convert(sub)
    raise NotImplementedError(
        f"backbone {backbone!r} import not wired; convert separately with "
        f"shgvqa_tpu_torch.utils.convert_* and load via --backboneWeights")


def reference_to_variables(
    sd: Dict[str, np.ndarray],
    variables: Dict[str, Any],
    cfg,
) -> Tuple[Dict[str, Any], Dict[str, List[str]]]:
    """A reference AGQAModel state_dict onto ``variables`` ({"params",
    "batch_stats"?} in the JAX layout, not modified); returns
    (new_variables, {"mapped": [...], "skipped": [...]})."""
    cat = cfg.encoder.cross_attn_type
    sd = {k: np.asarray(v) for k, v in strip_module_prefix(sd).items()}
    variables = copy_tree(variables)
    params = variables["params"]
    head = params["head"] if "head" in params else params
    report: Dict[str, List[str]] = {"mapped": [], "skipped": []}

    ref_enc = _encoder_prefix(sd)
    if cfg.task == "q":
        _fill_q_encoder(sd, ref_enc, head["bert_encoder"], cfg.encoder,
                        report)
    else:
        _fill_lxrt(sd, ref_enc, head["lxrt"], cfg.encoder, cat, report)

    if "hgq_encoder" in head:
        hq = "hgq_encoder"
        hgq: Dict[str, Any] = {
            "act_token": sd[f"{hq}.act_token"],
            "rel_token": sd[f"{hq}.rel_token"],
            "cls_token": sd[f"{hq}.cls_token"],
            "x_tied": _cross_layer(sd, f"{hq}.cross_attn_layer.{cat}", cat),
            "pooler": _pooler(sd, hq, cat),
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

    for name in ("class_embed", "action_embed", "logit_fc", "logit_fc2"):
        if name in head and (f"{name}.0.weight" in sd
                             or f"{name}.weight" in sd):
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


def _embeddings(sd, ref_enc: str) -> Dict[str, Any]:
    return {
        "word_embeddings": {
            "embedding": sd[f"{ref_enc}.embeddings.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd[f"{ref_enc}.embeddings.position_embeddings"
                            ".weight"]},
        "token_type_embeddings": {
            "embedding": sd[f"{ref_enc}.embeddings.token_type_embeddings"
                            ".weight"]},
        "ln": _ln(sd, f"{ref_enc}.embeddings.LayerNorm"),
    }


def _fill_lxrt(sd, ref_enc: str, lxrt: Dict[str, Any], enc_cfg, cat: str,
               report) -> None:
    n_vis = enc_cfg.visual_seq_length
    tree: Dict[str, Any] = {"embeddings": _embeddings(sd, ref_enc)}
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
    enc.update(_x_layers(sd, f"{ref_enc}.encoder.x_layers", lxrt["encoder"],
                         cat))
    tree["encoder"] = enc
    tree["pooler"] = _pooler(sd, ref_enc, cat)
    _strict_merge(lxrt, tree, "lxrt", report)


def _fill_q_encoder(sd, ref_enc: str, bert: Dict[str, Any], enc_cfg,
                    report) -> None:
    """Task 'q': the ``LanguageEncoder`` (``bert_encoder``: embeddings,
    ``l_{i}``, a single-CLS pooler) from the reference's
    BertFeatureExtraction."""
    tree: Dict[str, Any] = {"embeddings": _embeddings(sd, ref_enc)}
    for i in range(enc_cfg.l_layers):
        tree[f"l_{i}"] = _bert_layer(sd, f"{ref_enc}.encoder.layer.{i}")
    if f"{ref_enc}.pooler.dense.weight" in sd:
        tree["pooler"] = {"dense": _dense(sd, f"{ref_enc}.pooler.dense")}
    elif f"{ref_enc}.pooler_dict.self.dense.weight" in sd:
        tree["pooler"] = {"dense": _dense(
            sd, f"{ref_enc}.pooler_dict.self.dense")}
    _strict_merge(bert, tree, "bert_encoder", report)


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

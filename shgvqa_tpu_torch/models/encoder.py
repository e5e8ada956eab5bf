"""Tri-stream LXMERT-style encoder: the port of ``TriStreamEncoder``,
``LanguageEncoder`` and ``LXRTModel`` in ``shgvqa_tpu/models/encoder.py``
(unscanned path).

- ``l_{i}`` layers on text, ``r_{i}`` layers on the visual tokens, then the
  cross-modal layers of ``cross_attn_type`` (``models/cross.py``):
  ``x_tied``, ONE module called ``x_layers`` times as the published model
  ties them, or with ``tie_x_layers`` off (``--untieXLayers``) ``x_{i}``.
  Under 'self' the joint [visn; lang] stream carries the concatenated mask
  from the second x-layer on.
- The hypergraph decoders read the PRE-cross snapshots, returned explicitly.
- Masks are additive -10000, built in the compute dtype by ``extend_mask``.
- ``LXRTModel(deaf=True)`` (task 'vhga') forces the language mask to all
  masked; its pooler is ``Pooler2(visn, lang)`` under 'cross' and
  ``Pooler(visn)`` under every other type, 'old' included.
- ``LanguageEncoder`` is task 'q''s question-only model: embeddings,
  ``l_{i}`` and ``Pooler``.
- With ``output_attentions`` (the attention dumps) the encoders also
  return the probabilities of every layer as the JAX package does:
  ``{"lang": [l_i], "visn": [r_i], "cross": [each x-step's dict]}``.

The visual encoder's options:
- ``no_caps`` off (STAR's README command): the capsule tokenizer
  (``models/capsules.py``, 1 + T*H*W tokens of ``caps_dim``), then with
  ``caps_mask_features`` the language-conditioned mask on the embedded
  language CLS (``lang_emb[:, 0]``), then ``caps_proj`` to the hidden
  width.  On this path the cross layers exist only with
  ``caps_cross_attn`` (``--crossAttn``); without it there are none, and
  the streams meet only through the capsule mask;
- ``shared_weights`` (``--sharedWeights``): no ``r_{i}``; the visual
  tokens run through the language layers, one set of weights for both
  streams (it wins over ``vit_init``, as in the reference);
- ``vit_init`` (``--vitInit``): the ``r_{i}`` are ``models/vit.ViTBlock``,
  called without a mask;
- ``patches`` (``--patches``): the tokenizer's linear patch branch
  (``models/visual.py``).

``remat`` (a ``models/remat.py`` policy, or None without ``--remat``)
rematerializes what JAX's ``remat_class`` wraps: every l- and r-layer (the
ViT blocks too, and under ``--sharedWeights`` the l-layers' visual pass),
and under ``scan_layers`` the scanned cross stack of 'cross' / 'old'; the
unscanned cross layers and ``LanguageEncoder`` are not wrapped, and
``LXRTModel`` takes no policy unless its caller gives one.

``scan_layers`` (``--scanLayers``) runs the same per-layer modules: torch
has no scan to compile, so only the JAX parameter layout differs
(``models/scan_stacks.py`` maps it).  As in JAX it raises with
``vit_init`` or ``shared_weights`` and with attention dumps.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import EncoderConfig
from shgvqa_tpu_torch.models.capsules import (
    CapsuleVisualTokenizer,
    LanguageCapsuleMask,
)
from shgvqa_tpu_torch.models.cross import CROSS_LAYER_TYPES, _cat_masks
from shgvqa_tpu_torch.models.layers import (
    BertEmbeddings,
    BertLayer,
    Dense,
    Pooler,
    Pooler2,
    extend_mask,
)
from shgvqa_tpu_torch.models.remat import check_policy, remat_call
from shgvqa_tpu_torch.models.visual import VisualTokenizer
from shgvqa_tpu_torch.models.vit import ViTBlock


class TriStreamEncoder(nn.Module):
    """l_layers on text, r_layers on visual tokens, x_layers cross-modal."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, kernel_train: bool = False,
                 remat: Optional[str] = None):
        super().__init__()
        c = cfg
        if c.scan_layers and (c.vit_init or c.shared_weights):
            raise ValueError(
                "vit_init/shared_weights r_layers are not available with "
                "scan_layers; rerun with scan_layers=False")
        if remat is not None:
            check_policy(remat)
        self.remat = remat
        self.scan_layers = c.scan_layers
        kw = dict(hidden_size=c.hidden_size, num_heads=c.num_heads,
                  head_dim=c.head_dim, intermediate_size=c.intermediate_size,
                  dtype=dtype, use_kernel=use_kernel,
                  attn_dropout=c.attention_dropout,
                  hidden_dropout=c.hidden_dropout, kernel_train=kernel_train)
        self.caps = not c.no_caps
        if self.caps:
            self.caps_tokenizer = CapsuleVisualTokenizer(
                c.visual_feat_dim, c.hidden_size, c.visual_seq_length,
                c.num_prim_caps, c.num_vis_caps, c.pose_dim,
                c.hidden_dropout, dtype)
            self.caps_proj = Dense(self.caps_tokenizer.caps_dim,
                                   c.hidden_size, dtype)
            self.caps_mask = (LanguageCapsuleMask(
                c.hidden_size, c.num_vis_caps, c.caps_skip_connection, dtype)
                if c.caps_mask_features else None)
        else:
            self.visual_tokenizer = VisualTokenizer(
                c.visual_feat_dim, c.hidden_size, c.visual_seq_length, dtype,
                c.hidden_dropout, c.patches)
        self.l_names = [f"l_{i}" for i in range(c.l_layers)]
        for name in self.l_names:
            setattr(self, name, BertLayer(**kw))
        # --sharedWeights: the visual stream runs through the l-layers
        self.r_names = ([] if c.shared_weights
                        else [f"r_{i}" for i in range(c.r_layers)])
        for name in self.r_names:
            setattr(self, name, ViTBlock(
                c.hidden_size, c.num_heads, c.head_dim,
                c.intermediate_size // c.hidden_size, dtype)
                if c.vit_init else BertLayer(**kw))
        self.visn_names = self.l_names if c.shared_weights else self.r_names
        x_cls = CROSS_LAYER_TYPES[c.cross_attn_type]
        if self.caps and not c.caps_cross_attn:
            self.x_names = []
        else:
            self.x_names = (["x_tied"] * c.x_layers if c.tie_x_layers
                            else [f"x_{i}" for i in range(c.x_layers)])
        for name in dict.fromkeys(self.x_names):
            setattr(self, name, x_cls(**kw))
        self.joint = c.cross_attn_type == "self"
        # the scanned cross stack ('cross' / 'old') is the one cross stack
        # JAX rematerializes
        self.remat_cross = (c.scan_layers
                            and c.cross_attn_type in ("cross", "old"))

    def forward(self, lang_emb, lang_mask, visual_feats, visn_mask=None,
                g=None, output_attentions: bool = False):
        """lang_emb (B, Lt, D); lang_mask additive (B,1,1,Lt) or None;
        visual_feats (B, T, H, W, C).  Returns (lang, visn, lang_snapshot,
        visn_snapshot), and with ``output_attentions`` the attentions."""
        if self.scan_layers and output_attentions:
            raise ValueError(
                "output_attentions is unavailable with scan_layers; rerun "
                "with scan_layers=False for attention dumps")
        attn = {"lang": [], "visn": [], "cross": []}

        def run(layer, *args, remat=None):
            if not output_attentions:
                return remat_call(layer, remat, *args)
            *outs, probs = layer(*args, return_probs=True)
            return outs[0] if len(outs) == 1 else tuple(outs), probs

        if self.caps:
            caps = self.caps_tokenizer(visual_feats, g)
            if self.caps_mask is not None:
                caps = self.caps_mask(caps, lang_emb[:, 0])
            visn = self.caps_proj(caps)
        else:
            visn = self.visual_tokenizer(visual_feats, g)
        lang = lang_emb
        for name in self.l_names:
            lang = run(getattr(self, name), lang, lang_mask, g,
                       remat=self.remat)
            if output_attentions:
                lang, p = lang
                attn["lang"].append(p)
        for name in self.visn_names:
            visn = run(getattr(self, name), visn, visn_mask, g,
                       remat=self.remat)
            if output_attentions:
                visn, p = visn
                attn["visn"].append(p)
        lang_snapshot, visn_snapshot = lang, visn
        for step, name in enumerate(self.x_names):
            out = run(getattr(self, name), lang, lang_mask, visn, visn_mask,
                      g, step,
                      remat=self.remat if self.remat_cross else None)
            if output_attentions:
                out, p = out
                attn["cross"].append(p)
            lang, visn = out
            if self.joint and step == 0:
                visn_mask = _cat_masks(visn_mask, lang_mask,
                                       visn.shape[1] - lang.shape[1],
                                       lang.shape[1])
        if output_attentions:
            return lang, visn, lang_snapshot, visn_snapshot, attn
        return lang, visn, lang_snapshot, visn_snapshot


class LanguageEncoder(nn.Module):
    """The question-only model (task 'q'): embeddings -> ``l_{i}`` ->
    ``Pooler``."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, kernel_train: bool = False):
        super().__init__()
        c = cfg
        self.embeddings = BertEmbeddings(
            c.vocab_size, c.hidden_size, c.max_position_embeddings,
            c.type_vocab_size, dtype, c.hidden_dropout)
        self.l_names = [f"l_{i}" for i in range(c.l_layers)]
        for name in self.l_names:
            setattr(self, name, BertLayer(
                c.hidden_size, c.num_heads, c.head_dim, c.intermediate_size,
                dtype, use_kernel, c.attention_dropout, c.hidden_dropout,
                kernel_train))
        self.pooler = Pooler(c.hidden_size, dtype)
        self.dtype = dtype

    def forward(self, input_ids, input_mask, segment_ids=None, g=None):
        """Returns (the last layer's output, the pooled (B, D))."""
        ext = extend_mask(input_mask, self.dtype)
        x = self.embeddings(input_ids, segment_ids, g)
        for name in self.l_names:
            x = getattr(self, name)(x, ext, g)
        return x, self.pooler(x)


class LXRTModel(nn.Module):
    """Text + video encoder: embeddings -> tri-stream -> the pooled output
    (``Pooler2(visn, lang)`` under 'cross', else ``Pooler(visn)``); with
    ``deaf`` the language mask is all masked."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, kernel_train: bool = False,
                 deaf: bool = False, remat: Optional[str] = None):
        super().__init__()
        self.embeddings = BertEmbeddings(
            cfg.vocab_size, cfg.hidden_size, cfg.max_position_embeddings,
            cfg.type_vocab_size, dtype, cfg.hidden_dropout)
        self.encoder = TriStreamEncoder(cfg, dtype, use_kernel, kernel_train,
                                        remat)
        self.pooler = (Pooler2(cfg.hidden_size, dtype)
                       if cfg.cross_attn_type == "cross"
                       else Pooler(cfg.hidden_size, dtype))
        self.dtype = dtype
        self.deaf = deaf

    def forward(self, input_ids, input_mask, segment_ids, visual_feats,
                visual_mask=None, g=None, output_attentions: bool = False):
        """visual_mask: {0,1} (B, Lv) over the visual tokens, or None.
        Returns (pooled, lang, visn, lang_snapshot, visn_snapshot,
        lang_ext_mask), and with ``output_attentions`` the encoder's
        attentions."""
        if self.deaf:
            input_mask = torch.zeros_like(input_mask)
        lang_ext = extend_mask(input_mask, self.dtype)
        visn_ext = (extend_mask(visual_mask, self.dtype)
                    if visual_mask is not None else None)
        emb = self.embeddings(input_ids, segment_ids, g)
        enc = self.encoder(emb, lang_ext, visual_feats, visn_ext, g,
                           output_attentions)
        lang, visn, lang_snap, visn_snap = enc[:4]
        # under 'self' / 'cross_self' the joint stream is `visn`: Pooler
        # takes its first token
        pooled = (self.pooler(visn, lang) if isinstance(self.pooler, Pooler2)
                  else self.pooler(visn))
        return (pooled, lang, visn, lang_snap, visn_snap, lang_ext) + enc[4:]

"""SHG-VQA task models: the port of ``ShgVqaModel`` and ``VideoShgVqaModel``
in ``shgvqa_tpu/models/shgvqa.py`` (tasks 'hgqa' and 'vqa', inference).

'hgqa' forward:
1. features -> tri-stream encoder; ``logit`` from the pooled output through
   ``logit_fc``;
2. the decoders' memory is the PRE-cross visual snapshot;
3. the rel/act HG decoders run from zero targets with the query tables as
   positions under the situation-causal mask; MLP heads give ``rel_preds``
   and ``act_preds`` over (classes + 1), background 0;
4. per situation the hg tokens are [act slots ++ rel slots]; they go through
   the HG<->question cross encoder and ``hg_logit`` comes from the SAME
   ``logit_fc``.

In training mode (``model.train()``) every dropout site drops, with masks
drawn from the ``generator`` passed to ``forward`` (the device's default
generator when None), the training attention sites run the fused kernels
(``use_pallas_attention_train``) and, with ``use_pallas_ffn_train``, every
FFN block runs the fused train kernels.  The frozen trunk runs under
``torch.no_grad()``, as the JAX package's ``stop_gradient`` and its
two-launch trunk do; its BatchNorm always uses the stored statistics.
Every option the flagship does not use raises
(``configs.config.check_ported``; training options are checked when the
model runs in training mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import Config, check_ported, torch_dtype
from shgvqa_tpu_torch.data.featurize import hg_segment_ids, situation_causal_mask
from shgvqa_tpu_torch.data.transforms import NORM_STATS, normalize_clip
from shgvqa_tpu_torch.models.backbone import make_backbone
from shgvqa_tpu_torch.models.decoder import HGDecoder
from shgvqa_tpu_torch.models.encoder import LXRTModel
from shgvqa_tpu_torch.models.hg import HGEmbeddings, HGQCrossEncoder
from shgvqa_tpu_torch.models.layers import MLPHead, set_ffn_train_kernel


class ShgVqaModel(nn.Module):
    """Task-routed SHG-VQA head over pre-extracted visual features."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        enc, data = cfg.encoder, cfg.data
        dt = torch_dtype(cfg.compute_dtype)
        kernel = cfg.use_pallas_ffn
        kernel_train = cfg.use_pallas_attention_train
        d = enc.hidden_size
        self.lxrt = LXRTModel(enc, dt, kernel, kernel_train)
        if cfg.task == "hgqa":
            s = data.num_situations
            # the relation queries drop at HGEmbeddings' default 0.1, the
            # action queries at the decoder's emb_dropout (as the JAX model)
            self.relation_query_embed = HGEmbeddings(
                data.num_rel_queries, d, type_vocab_size=s, dtype=dt)
            self.action_query_embed = HGEmbeddings(
                data.num_act_queries, d, type_vocab_size=s, dtype=dt,
                dropout=cfg.decoder.emb_dropout)
            dec = cfg.decoder
            self.rel_decoder = HGDecoder(dec.num_layers, d, dec.num_heads,
                                         dec.ffn_dim, dt, dec.dropout,
                                         kernel_train)
            self.action_decoder = HGDecoder(dec.num_layers, d, dec.num_heads,
                                            dec.ffn_dim, dt, dec.dropout,
                                            kernel_train)
            self.class_embed = MLPHead(d, cfg.num_rel_classes + 1, dtype=dt)
            self.action_embed = MLPHead(d, cfg.num_act_classes + 1, dtype=dt)
            self.hgq_encoder = HGQCrossEncoder(
                enc, num_max_act=data.num_act, num_max_rel=data.num_rel,
                dtype=dt, use_kernel=kernel, kernel_train=kernel_train)
            for kind, slots in (("rel", data.num_rel), ("act", data.num_act)):
                self.register_buffer(f"{kind}_seg", torch.as_tensor(
                    hg_segment_ids(s, slots), dtype=torch.long),
                    persistent=False)
                self.register_buffer(f"{kind}_mask", torch.as_tensor(
                    situation_causal_mask(s, slots)), persistent=False)
        self.logit_fc = MLPHead(d, cfg.num_answers, dtype=dt)
        set_ffn_train_kernel(self, cfg.use_pallas_ffn_train)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: input_ids, input_mask, segment_ids (B, Lt) ints;
        visual_feats (B, T, H, W, C); optional visual_mask (B, Lv) {0,1}.
        ``generator`` draws the dropout masks in training mode."""
        if "choice_input_ids" in batch:
            raise NotImplementedError(
                "per-choice QA is not ported yet (ROADMAP queue A item 15)")
        cfg = self.cfg
        if self.training:
            check_ported(cfg, train=True)
        g = generator
        pooled, _, _, lang_snap, visn_snap, lang_ext = self.lxrt(
            batch["input_ids"], batch["input_mask"], batch.get("segment_ids"),
            batch["visual_feats"], batch.get("visual_mask"), g)
        logit = self.logit_fc(pooled)
        if cfg.task == "vqa":
            return {"logit": logit}

        memory = visn_snap
        b = memory.shape[0]
        s, d = cfg.data.num_situations, cfg.encoder.hidden_size
        rel_q = self.relation_query_embed(self.rel_seg.expand(b, -1), g)
        act_q = self.action_query_embed(self.act_seg.expand(b, -1), g)
        rel_out = self.rel_decoder(rel_q, memory, self.rel_mask, None, g)
        act_out = self.action_decoder(act_q, memory, self.act_mask, None, g)
        hg_in = torch.cat([act_out.reshape(b, s, -1, d),
                           rel_out.reshape(b, s, -1, d)], dim=2).reshape(b, -1, d)
        x_hg = self.hgq_encoder(lang_snap, lang_ext, hg_in, g)
        return {"logit": logit, "hg_logit": self.logit_fc(x_hg),
                "rel_preds": self.class_embed(rel_out),
                "act_preds": self.action_embed(act_out)}


class VideoShgVqaModel(nn.Module):
    """Frames -> answer: uint8 frames / 255 in the frames dtype, then
    ``normalize_clip`` with the trunk's ``NORM_STATS``, the frozen slow_r50
    trunk, and the ``ShgVqaModel`` head.

    Frames are (B, visual_t + 8, image_size, image_size, 3)."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_ported(cfg, video=True)
        self.cfg = cfg
        self.backbone = make_backbone(cfg.backbone,
                                      torch_dtype(cfg.compute_dtype))
        # flax infers the tokenizer's input width and token count from the
        # trunk's output; here they follow from the trunk and image_size
        self.head = ShgVqaModel(cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, visual_feat_dim=self.backbone.out_channels,
            visual_hw=self.backbone.spatial_out(cfg.data.image_size))))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        if "frames" in batch:
            feats = self.encode_frames(batch["frames"])
            batch = {k: v for k, v in batch.items() if k != "frames"}
            batch["visual_feats"] = feats
        return self.head(batch, generator)

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 frames -> (B, T, h, w, C) features; the
        frozen trunk records no graph."""
        if frames.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {frames.dtype}")
        with torch.no_grad():
            return self.backbone(self.normalize_frames(frames))

    def normalize_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 frames / 255 in the frames dtype, then ``normalize_clip``
        with the trunk's ``NORM_STATS``: the trunk's input."""
        pix_dt = torch_dtype(self.cfg.data.aug_dtype or self.cfg.compute_dtype)
        mean, std = NORM_STATS[self.cfg.backbone]
        return normalize_clip(frames.to(pix_dt) / 255.0, mean, std)

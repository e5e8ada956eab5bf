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

Both models are inference-only for now: they raise in training mode.  Every
option the flagship does not use raises (``configs.config.check_ported``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import Config, check_ported, torch_dtype
from shgvqa_tpu_torch.data.featurize import hg_segment_ids, situation_causal_mask
from shgvqa_tpu_torch.data.transforms import NORM_STATS, normalize_clip
from shgvqa_tpu_torch.models.backbone import make_backbone
from shgvqa_tpu_torch.models.decoder import HGDecoder
from shgvqa_tpu_torch.models.encoder import LXRTModel
from shgvqa_tpu_torch.models.hg import HGEmbeddings, HGQCrossEncoder
from shgvqa_tpu_torch.models.layers import MLPHead


def _require_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            "the port runs inference only (call .eval()); training is ROADMAP "
            "queue A slice 2")


class ShgVqaModel(nn.Module):
    """Task-routed SHG-VQA head over pre-extracted visual features."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        enc, data = cfg.encoder, cfg.data
        dt = torch_dtype(cfg.compute_dtype)
        kernel = cfg.use_pallas_ffn
        d = enc.hidden_size
        self.lxrt = LXRTModel(enc, dt, kernel)
        if cfg.task == "hgqa":
            s = data.num_situations
            self.relation_query_embed = HGEmbeddings(
                data.num_rel_queries, d, type_vocab_size=s, dtype=dt)
            self.action_query_embed = HGEmbeddings(
                data.num_act_queries, d, type_vocab_size=s, dtype=dt)
            dec = cfg.decoder
            self.rel_decoder = HGDecoder(dec.num_layers, d, dec.num_heads,
                                         dec.ffn_dim, dt)
            self.action_decoder = HGDecoder(dec.num_layers, d, dec.num_heads,
                                            dec.ffn_dim, dt)
            self.class_embed = MLPHead(d, cfg.num_rel_classes + 1, dtype=dt)
            self.action_embed = MLPHead(d, cfg.num_act_classes + 1, dtype=dt)
            self.hgq_encoder = HGQCrossEncoder(
                enc, num_max_act=data.num_act, num_max_rel=data.num_rel,
                dtype=dt, use_kernel=kernel)
            for kind, slots in (("rel", data.num_rel), ("act", data.num_act)):
                self.register_buffer(f"{kind}_seg", torch.as_tensor(
                    hg_segment_ids(s, slots), dtype=torch.long),
                    persistent=False)
                self.register_buffer(f"{kind}_mask", torch.as_tensor(
                    situation_causal_mask(s, slots)), persistent=False)
        self.logit_fc = MLPHead(d, cfg.num_answers, dtype=dt)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """batch: input_ids, input_mask, segment_ids (B, Lt) ints;
        visual_feats (B, T, H, W, C); optional visual_mask (B, Lv) {0,1}."""
        _require_eval(self)
        if "choice_input_ids" in batch:
            raise NotImplementedError(
                "per-choice QA is not ported yet (ROADMAP queue A item 15)")
        cfg = self.cfg
        pooled, _, _, lang_snap, visn_snap, lang_ext = self.lxrt(
            batch["input_ids"], batch["input_mask"], batch.get("segment_ids"),
            batch["visual_feats"], batch.get("visual_mask"))
        logit = self.logit_fc(pooled)
        if cfg.task == "vqa":
            return {"logit": logit}

        memory = visn_snap
        b = memory.shape[0]
        s, d = cfg.data.num_situations, cfg.encoder.hidden_size
        rel_q = self.relation_query_embed(self.rel_seg.expand(b, -1))
        act_q = self.action_query_embed(self.act_seg.expand(b, -1))
        rel_out = self.rel_decoder(rel_q, memory, self.rel_mask)
        act_out = self.action_decoder(act_q, memory, self.act_mask)
        hg_in = torch.cat([act_out.reshape(b, s, -1, d),
                           rel_out.reshape(b, s, -1, d)], dim=2).reshape(b, -1, d)
        x_hg = self.hgq_encoder(lang_snap, lang_ext, hg_in)
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

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _require_eval(self)
        if "frames" in batch:
            feats = self.encode_frames(batch["frames"])
            batch = {k: v for k, v in batch.items() if k != "frames"}
            batch["visual_feats"] = feats
        return self.head(batch)

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 frames -> (B, T, h, w, C) features."""
        if frames.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {frames.dtype}")
        pix_dt = torch_dtype(self.cfg.data.aug_dtype or self.cfg.compute_dtype)
        x = frames.to(pix_dt) / 255.0
        mean, std = NORM_STATS[self.cfg.backbone]
        return self.backbone(normalize_clip(x, mean, std))

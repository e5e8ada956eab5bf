"""SHG-VQA task models: the port of ``ShgVqaModel`` and ``VideoShgVqaModel``
in ``shgvqa_tpu/models/shgvqa.py``.

'hgqa' forward:
1. features -> tri-stream encoder; ``logit`` from the pooled output through
   ``logit_fc``;
2. the decoders' memory is the PRE-cross visual snapshot (the post-cross
   stream under ``after_cross_attn_feats``, which also gives the HG cross
   encoder the post-cross language);
3. the rel/act HG decoders run from zero targets with the query tables as
   positions under the situation-causal mask; the heads (MLPs, or ``Dense``
   under ``decoder.linear_cls``) give ``rel_preds`` and ``act_preds`` over
   (classes + 1), background 0.  In GT-HG mode (``gt_hg``) a batch that
   carries ``rel_tgt_ids`` / ``act_tgt_ids`` embeds those labels as the
   hypergraph instead (tables sized by the class vocabulary), skips the
   decoders and gives no ``rel_preds`` / ``act_preds``;
4. per situation the hg tokens are [act slots ++ rel slots]; they go through
   the HG<->question cross encoder (under ``use_hg_mask`` the batch's
   ``hg_mask`` masks the empty slots as keys) and ``hg_logit`` comes from
   the SAME ``logit_fc``.

The other tasks: 'q' is the question-only ``LanguageEncoder``
(``bert_encoder``) into ``logit_fc``; 'vqa' stops after step 1; 'vhga' is
'hgqa' with a deaf encoder (the language mask all masked); 'hgvqa' takes
``hg_logit`` from ``logit_fc2`` on concat(pooled, x_hg).  The cross layers
follow ``encoder.cross_attn_type`` and ``tie_x_layers``
(``models/encoder.py``, ``models/hg.py``).

Per-choice QA (STAR's ``--qaArrangeType add_sep|no_sep``, every task but
'q'): the batch's ``choice_input_ids`` / ``_mask`` / ``_segment_ids``
(B, C, Lt) fold the choice axis into the batch on the language side and
repeats the visual features (and ``visual_mask``) per choice before the
LXRT, as JAX does; ``logit`` is ``choice_score_fc(pooled)`` as (B, C).  The
hypergraph is decoded ONCE per clip, from choice 0's pre-cross snapshot;
its tokens and ``hg_mask`` repeat per choice into the HG cross encoder, and
``hg_logit`` is ``choice_score_fc(x_hg)`` (under 'hgvqa'
``choice_score_fc2`` on concat(pooled, x_hg)) as (B, C).

``forward(..., output_attentions=True)`` (``--outputAttn``) adds
``attentions``: ``{"encoder": the LXRT's dict, "hgq": the HG encoder's
list}``.  Every attention site then takes the plain path, whatever the
kernel switches say, since the kernels return no probabilities.

In training mode (``model.train()``) every dropout site drops, with masks
drawn from the ``generator`` passed to ``forward`` (the device's default
generator when None), the training attention sites run the fused kernels
(``use_pallas_attention_train``, or ``use_pallas_attention``, which the JAX
``Trainer`` turns on everywhere) and, with ``use_pallas_ffn_train``, every
FFN block runs the fused train kernels.  With ``use_pallas_attention``
(``--pallasAttention``) every attention site outside training runs the
fused forward kernel at rate 0.  With ``freeze_backbone`` the trunk runs
under ``torch.no_grad()``, as the JAX package's ``stop_gradient`` and its
two-launch trunk do; otherwise it trains in the graph.  Its BatchNorm
always uses the stored statistics.  In training mode with an augmenting
``augment_type`` the frames are augmented on the device before they are
normalized, with draws from the same generator.  ``quant_backbone='int8'``
(a frozen trunk only) runs the int8 trunk, whose scales
``VideoShgVqaModel.calibrate_quant`` records; ``backbone_chunks`` N runs a
frozen trunk's whole frames path (convert, augment, normalize, trunk) in N
micro-chunks one after another when N divides the batch (else the batch
runs whole, as in JAX), with the batch's augmentation drawn once.
Every option the flagship does not use raises
(``configs.config.check_ported``; training options are checked when the
model runs in training mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import (
    HG_TASKS,
    PER_CHOICE,
    Config,
    check_ported,
    torch_dtype,
)
from shgvqa_tpu_torch.data.featurize import hg_segment_ids, situation_causal_mask
from shgvqa_tpu_torch.data.transforms import (
    AUGMENT_TYPES,
    NORM_STATS,
    augment_clips,
    augment_draws,
    normalize_clip,
)
from shgvqa_tpu_torch.models.backbone import calibrate_quant, make_backbone
from shgvqa_tpu_torch.models.decoder import HGDecoder
from shgvqa_tpu_torch.models.encoder import LanguageEncoder, LXRTModel
from shgvqa_tpu_torch.models.hg import HGEmbeddings, HGQCrossEncoder
from shgvqa_tpu_torch.models.layers import (
    Dense,
    MLPHead,
    plain_attention,
    set_attention_kernel_eval,
    set_ffn_train_kernel,
)


class ShgVqaModel(nn.Module):
    """Task-routed SHG-VQA head over pre-extracted visual features."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        enc, data = cfg.encoder, cfg.data
        dt = torch_dtype(cfg.compute_dtype)
        kernel = cfg.use_pallas_ffn
        kernel_train = (cfg.use_pallas_attention_train
                        or cfg.use_pallas_attention)
        d = enc.hidden_size
        if cfg.task == "q":
            self.bert_encoder = LanguageEncoder(enc, dt, kernel, kernel_train)
        else:
            self.lxrt = LXRTModel(enc, dt, kernel, kernel_train,
                                  deaf=cfg.task == "vhga")
        if cfg.task in HG_TASKS:
            s = data.num_situations
            # GT-HG mode sizes the tables by the class vocabulary
            rel_table = (cfg.num_rel_classes + 1 if cfg.gt_hg
                         else data.num_rel_queries)
            act_table = (cfg.num_act_classes + 1 if cfg.gt_hg
                         else data.num_act_queries)
            # the relation queries drop at HGEmbeddings' default 0.1, the
            # action queries at the decoder's emb_dropout (as the JAX model)
            self.relation_query_embed = HGEmbeddings(
                rel_table, d, type_vocab_size=s, dtype=dt)
            self.action_query_embed = HGEmbeddings(
                act_table, d, type_vocab_size=s, dtype=dt,
                dropout=cfg.decoder.emb_dropout)
            dec = cfg.decoder
            self.rel_decoder = HGDecoder(dec.num_layers, d, dec.num_heads,
                                         dec.ffn_dim, dt, dec.dropout,
                                         kernel_train)
            self.action_decoder = HGDecoder(dec.num_layers, d, dec.num_heads,
                                            dec.ffn_dim, dt, dec.dropout,
                                            kernel_train)
            head = Dense if dec.linear_cls else MLPHead
            self.class_embed = head(d, cfg.num_rel_classes + 1, dtype=dt)
            self.action_embed = head(d, cfg.num_act_classes + 1, dtype=dt)
            self.hgq_encoder = HGQCrossEncoder(
                enc, num_max_act=data.num_act, num_max_rel=data.num_rel,
                dtype=dt, use_kernel=kernel, kernel_train=kernel_train)
            if cfg.task == "hgvqa" and data.qa_arrange_type not in PER_CHOICE:
                self.logit_fc2 = MLPHead(2 * d, cfg.num_answers, dtype=dt)
            for kind, slots in (("rel", data.num_rel), ("act", data.num_act)):
                self.register_buffer(f"{kind}_seg", torch.as_tensor(
                    hg_segment_ids(s, slots), dtype=torch.long),
                    persistent=False)
                self.register_buffer(f"{kind}_mask", torch.as_tensor(
                    situation_causal_mask(s, slots)), persistent=False)
        # per-choice QA: each (question, choice) pair scored by a scalar
        # head (the reference never wired its qa0..qa3 into a model); the
        # answer heads, which no per-choice forward reads, are not built,
        # as flax creates no parameters for them
        if cfg.task != "q" and data.qa_arrange_type in PER_CHOICE:
            self.choice_score_fc = MLPHead(d, 1, dtype=dt)
            if cfg.task == "hgvqa":
                self.choice_score_fc2 = MLPHead(2 * d, 1, dtype=dt)
        else:
            self.logit_fc = MLPHead(d, cfg.num_answers, dtype=dt)
        set_ffn_train_kernel(self, cfg.use_pallas_ffn_train)
        set_attention_kernel_eval(self, cfg.use_pallas_attention)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                output_attentions: bool = False) -> Dict[str, torch.Tensor]:
        """batch: input_ids, input_mask, segment_ids (B, Lt) ints;
        visual_feats (B, T, H, W, C); optional visual_mask (B, Lv) {0,1};
        per choice also choice_input_ids, choice_input_mask,
        choice_segment_ids (B, C, Lt).  ``generator`` draws the dropout
        masks in training mode.  With ``output_attentions`` every attention
        site runs the plain path (``layers.plain_attention``)."""
        if output_attentions:
            with plain_attention():
                return self._forward(batch, generator, True)
        return self._forward(batch, generator, False)

    def _forward(self, batch, generator, output_attentions):
        cfg = self.cfg
        if self.training:
            check_ported(cfg, train=True)
        g = generator
        if cfg.task == "q":
            _, pooled = self.bert_encoder(
                batch["input_ids"], batch["input_mask"],
                batch.get("segment_ids"), g)
            return {"logit": self.logit_fc(pooled)}
        per_choice = cfg.data.qa_arrange_type in PER_CHOICE
        if per_choice and "choice_input_ids" not in batch:
            raise ValueError(
                f"--qaArrangeType {cfg.data.qa_arrange_type} builds the "
                "per-choice heads only: a batch must carry choice_input_ids "
                "(STAR items do)")
        vfeats, vmask = batch["visual_feats"], batch.get("visual_mask")
        if per_choice:
            bsz, nch, lt = batch["choice_input_ids"].shape
            ids, imask, seg = (batch[f"choice_{k}"].reshape(bsz * nch, lt)
                               for k in ("input_ids", "input_mask",
                                         "segment_ids"))
            vfeats = vfeats.repeat_interleave(nch, dim=0)
            if vmask is not None:
                vmask = vmask.repeat_interleave(nch, dim=0)
        else:
            ids, imask = batch["input_ids"], batch["input_mask"]
            seg = batch.get("segment_ids")
        enc = self.lxrt(ids, imask, seg, vfeats, vmask, g, output_attentions)
        pooled, lang, visn, lang_snap, visn_snap, lang_ext = enc[:6]
        out = {"attentions": {"encoder": enc[6]}} if output_attentions else {}
        out["logit"] = (self.choice_score_fc(pooled).reshape(bsz, nch)
                        if per_choice else self.logit_fc(pooled))
        if cfg.task == "vqa":
            return out

        memory = visn if cfg.after_cross_attn_feats else visn_snap
        lang_feats = lang if cfg.after_cross_attn_feats else lang_snap
        if per_choice:
            # the pre-cross visual snapshot is the same for a clip's
            # choices: decode the hypergraph once a clip
            memory = memory.reshape(bsz, nch, *memory.shape[1:])[:, 0]
        b = memory.shape[0]
        s, d = cfg.data.num_situations, cfg.encoder.hidden_size
        rel_seg, act_seg = self.rel_seg.expand(b, -1), self.act_seg.expand(b, -1)
        if cfg.gt_hg and "rel_tgt_ids" in batch and "act_tgt_ids" in batch:
            rel_out = self.relation_query_embed(rel_seg, g,
                                                batch["rel_tgt_ids"])
            act_out = self.action_query_embed(act_seg, g,
                                              batch["act_tgt_ids"])
        else:
            rel_q = self.relation_query_embed(rel_seg, g)
            act_q = self.action_query_embed(act_seg, g)
            rel_out = self.rel_decoder(rel_q, memory, self.rel_mask, None, g)
            act_out = self.action_decoder(act_q, memory, self.act_mask, None,
                                          g)
            out["rel_preds"] = self.class_embed(rel_out)
            out["act_preds"] = self.action_embed(act_out)
        hg_in = torch.cat([act_out.reshape(b, s, -1, d),
                           rel_out.reshape(b, s, -1, d)], dim=2).reshape(b, -1, d)
        hg_mask = batch.get("hg_mask") if cfg.use_hg_mask else None
        if per_choice:
            # the question<->hypergraph cross attention runs per choice
            hg_in = hg_in.repeat_interleave(nch, dim=0)
            if hg_mask is not None:
                hg_mask = hg_mask.repeat_interleave(nch, dim=0)
        x_hg = self.hgq_encoder(lang_feats, lang_ext, hg_in, g, hg_mask,
                                output_attentions)
        if output_attentions:
            x_hg, out["attentions"]["hgq"] = x_hg
        if per_choice:
            head = (self.choice_score_fc2(torch.cat([pooled, x_hg], dim=-1))
                    if cfg.task == "hgvqa" else self.choice_score_fc(x_hg))
            out["hg_logit"] = head.reshape(bsz, nch)
        else:
            out["hg_logit"] = (
                self.logit_fc2(torch.cat([pooled, x_hg], dim=-1))
                if cfg.task == "hgvqa" else self.logit_fc(x_hg))
        return out


class VideoShgVqaModel(nn.Module):
    """Frames -> answer: uint8 frames / 255 in the frames dtype, in training
    the augmentation of ``data.augment_type``, then ``normalize_clip`` with
    the trunk's ``NORM_STATS``, the slow_r50 trunk (frozen or trained, by
    ``freeze_backbone``), and the ``ShgVqaModel`` head.

    Frames are (B, visual_t + 8, image_size, image_size, 3)."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_ported(cfg, video=True)
        if cfg.quant_backbone and not cfg.freeze_backbone:
            raise ValueError(
                "--quantBackbone requires a frozen trunk: the int8 forward "
                "has zero gradient through round()")
        self.cfg = cfg
        # the plain trunk keeps the registry's two-argument call
        quant = {"quant": cfg.quant_backbone} if cfg.quant_backbone else {}
        self.backbone = make_backbone(cfg.backbone,
                                      torch_dtype(cfg.compute_dtype), **quant)
        # flax infers the tokenizer's input width and token count from the
        # trunk's output; here they follow from the trunk and image_size
        self.head = ShgVqaModel(cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, visual_feat_dim=self.backbone.out_channels,
            visual_hw=self.backbone.spatial_out(cfg.data.image_size))))
        # the training augmentation's path (data/transforms.AUG_PATHS): a
        # CUDA graph of the train step switches it to "capacity", which
        # reads nothing on the host (train/graph.fixed_capacity)
        self.aug_path = "subbatch" if cfg.data.aug_subbatch else "select"

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                output_attentions: bool = False) -> Dict[str, torch.Tensor]:
        """``generator`` draws the augmentation and then the dropout masks
        in training mode."""
        if "frames" in batch:
            feats = self.encode_frames(batch["frames"], generator)
            batch = {k: v for k, v in batch.items() if k != "frames"}
            batch["visual_feats"] = feats
        return self.head(batch, generator, output_attentions)

    def encode_frames(self, frames: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 frames -> (B, T, h, w, C) features.  A
        frozen trunk records no graph, and with ``backbone_chunks`` N
        dividing B runs in N micro-chunks; a trained one is in the
        graph."""
        if frames.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {frames.dtype}")
        if not self.cfg.freeze_backbone:
            return self.backbone(self.normalize_frames(frames, generator))
        nc, b = self.cfg.backbone_chunks, frames.shape[0]
        with torch.no_grad():
            if nc <= 1 or b % nc:
                return self.backbone(self.normalize_frames(frames, generator))
            draws = (augment_draws(self.cfg.data.augment_type, b, generator,
                                   frames.device)
                     if self._augments() else None)
            size = b // nc
            feats = []
            for i in range(0, b, size):
                rows = (None if draws is None else
                        {k: v[i:i + size] for k, v in draws.items()})
                feats.append(self.backbone(self.normalize_frames(
                    frames[i:i + size], generator, rows)))
            return torch.cat(feats)

    def _augments(self) -> bool:
        return (self.training
                and self.cfg.data.augment_type in AUGMENT_TYPES)

    def normalize_frames(self, frames: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
        """The trunk's input: uint8 frames / 255 in the frames dtype, in
        training mode the augmentation of ``data.augment_type`` (draws from
        ``generator``, or these clips' rows of ``augment_draws``), then
        ``normalize_clip`` with the trunk's ``NORM_STATS``."""
        data = self.cfg.data
        pix_dt = torch_dtype(data.aug_dtype or self.cfg.compute_dtype)
        mean, std = NORM_STATS[self.cfg.backbone]
        x = frames.to(pix_dt) / 255.0
        if self._augments():
            x = augment_clips(x, data.augment_type, generator,
                              self.aug_path, data.aug_fold_chains, draws)
        return normalize_clip(x, mean, std)

    def calibrate_quant(self, frames: torch.Tensor) -> None:
        """The int8 trunk's scales from uint8 ``frames``, unaugmented, as
        the JAX driver's ``init`` records them on its example batch
        (``models/backbone.calibrate_quant``)."""
        training = self.training
        self.eval()
        try:
            calibrate_quant(self.backbone, self.normalize_frames(frames))
        finally:
            self.train(training)

"""Reference-flag-compatible CLI: the port's own copy of
``shgvqa_tpu/configs/cli.py``.

Every flag of the reference's argparse namespace (``AGQA/src/param.py``) and
every extension of the JAX package is accepted with its spelling and
default, and parsed into the same typed ``Config`` (tests hold the two
parsers equal).  Accepting a flag is not implementing it: the models,
the trainer and the driver call ``configs.config.check_ported``, which
raises ``NotImplementedError`` naming the ROADMAP item of any option the
port does not run yet.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from shgvqa_tpu_torch.configs.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="shgvqa_tpu_torch (reference-flag compatible)")

    # splits
    p.add_argument("--train", default="train")
    p.add_argument("--valid", default="valid")
    p.add_argument("--test", default=None)

    # training hyperparams
    p.add_argument("--batchSize", dest="batch_size", type=int, default=32)
    p.add_argument("--optim", default="bert")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=9595)
    p.add_argument("--output", type=str, default="snap/run")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--tqdm", action="store_true")
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--loadLXMERT", dest="load_lxmert", type=str, default=None)
    # --loadLXMERTQA (param.py:61-64): restore a pretraining snapshot AND
    # initialize the answer head by answer-string matching.  Every reference
    # driver ships with the call commented out (agqaHGQA.py:119-121,
    # agqaQ.py:98-100, agqaVQA.py:101-103) — here the wiring is live
    # (Trainer.load_lxmert_qa / qa_answer_table.py:84-158 semantics).
    p.add_argument("--loadLXMERTQA", dest="load_lxmert_qa", type=str,
                   default=None)
    p.add_argument("--fromScratch", dest="from_scratch", action="store_true")
    p.add_argument("--mceLoss", dest="mce_loss", action="store_true")
    p.add_argument("--noObjWeight", dest="no_object_weight", type=float, default=0.1)
    p.add_argument("--logFreq", dest="log_freq", type=int, default=50)

    # architecture
    p.add_argument("--llayers", type=int, default=5)
    p.add_argument("--xlayers", type=int, default=2)
    p.add_argument("--rlayers", type=int, default=5)
    p.add_argument("--dlayers", type=int, default=5)
    p.add_argument("--crossAttnType", dest="cross_attn_type", default="cross",
                   choices=["cross", "self", "cross_self", "old"])
    p.add_argument("--noCaps", dest="no_caps", action="store_true")
    p.add_argument("--outputAttn", dest="output_attention", action="store_true")
    p.add_argument("--linearCls", dest="linear_cls", action="store_true")
    p.add_argument("--embDropRate", dest="emb_drop_rate", type=float, default=0.15)
    p.add_argument("--decoderDropRate", dest="decoder_drop_rate", type=float, default=0.15)

    # capsule/patch flags (capsule path is off in every published recipe)
    p.add_argument("--NUM_PRIM_CAPS", type=int, default=32)
    p.add_argument("--NUM_VIS_CAPS", type=int, default=32)
    p.add_argument("--POSE_DIM", type=int, default=4)
    p.add_argument("--HW", type=int, default=7)
    # linear 32x32-RGB-patch tokenizer, backbone skipped (models/visual.py)
    p.add_argument("--patches", action="store_true")
    p.add_argument("--attnRouting", dest="attn_routing", action="store_true")
    p.add_argument("--skipConnection", dest="skip_connection", action="store_true")
    p.add_argument("--sharedWeights", dest="shared_weights", action="store_true")
    p.add_argument("--normInputs", dest="norm_inputs", action="store_true")
    p.add_argument("--crossAttn", dest="cross_attn", action="store_true")
    p.add_argument("--freezeWeights", dest="freeze_weights", action="store_true")
    p.add_argument("--vitInit", dest="vit_init", action="store_true")
    p.add_argument("--startIndex", dest="start_index", type=int, default=7)
    p.add_argument("--margin", type=float, default=0.1)

    # STAR specifics
    p.add_argument("--qType", dest="qtype", default="Feasibility",
                   choices=["Interaction", "Sequence", "Prediction", "Feasibility"])
    p.add_argument("--mergeData", dest="merge_data", action="store_true")
    p.add_argument("--mergeAll", dest="merge_all", action="store_true")
    p.add_argument("--qaArrangeType", dest="qa_arrange_type", default="add_sep_all",
                   choices=["add_sep_all", "no_sep_all", "add_sep", "no_sep"])

    # hypergraph geometry
    p.add_argument("--numRel", dest="num_rel", type=int, default=8)
    p.add_argument("--numAct", dest="num_act", type=int, default=3)
    p.add_argument("--addAction", dest="add_action", action="store_true")
    p.add_argument("--addRelation", dest="add_relation", action="store_true")
    p.add_argument("--numSituations", dest="num_situations", type=int, default=16)
    p.add_argument("--clipLEN", dest="clip_len", type=int, default=16)
    p.add_argument("--trainSubSet", dest="train_sub_set", action="store_true")

    # augmentation / backbone
    p.add_argument("--augmentType", dest="augment_type", default="no_aug",
                   choices=["no_aug", "no_aug_slowfast", "aug_mix", "rand_aug",
                            "rand_aug_slowfast"])
    p.add_argument("--backbone", default="slow_r50",
                   choices=["slow_r50", "slowfast_r50", "slowfast_r101",
                            "resnext101", "video_swin", "mvit_B",
                            "video_swin_impl"])
    p.add_argument("--afterCrossAttnFeats", dest="after_cross_attn_feats",
                   action="store_true")
    p.add_argument("--imageSize", dest="image_size", type=int, default=None,
                   help="frame resize (one side).  Default is per-backbone: "
                        "256 for slowfast variants (data_transforms.py:83,"
                        "119, crop_size=256 at :36), 224 otherwise; the "
                        "visual token grid follows as imageSize/32 per side")

    # task flags
    p.add_argument("--taskQ", dest="task_q", action="store_true")
    p.add_argument("--taskVQA", dest="task_vqa", action="store_true")
    p.add_argument("--taskHGQA", dest="task_hgqa", action="store_true")
    p.add_argument("--taskVHGA", dest="task_vhga", action="store_true")
    p.add_argument("--taskHGVQA", dest="task_hgvqa", action="store_true")
    p.add_argument("--GTHG", dest="gt_hg", action="store_true")
    p.add_argument("--useHGMask", dest="use_hg_mask", action="store_true")
    p.add_argument("--LossHGPerFrame", dest="loss_hg_per_frame", action="store_true")

    # AGQA test protocols
    p.add_argument("--novelComp", dest="novel_comp", action="store_true")
    p.add_argument("--indirectRef", dest="indirect_ref", action="store_true")
    p.add_argument("--compSteps", dest="comp_steps", action="store_true")

    # parallelism / workers
    # --multiGPU: the reference wraps the model in nn.DataParallel
    # (agqaHGQA.py:124-129, README.md:159); here it builds a data-parallel
    # jax.sharding.Mesh over every visible device (cli/common.py
    # build_driver_mesh).  --dataParallel/--modelParallel pick an explicit
    # dp x tp layout (tensor parallelism has no reference counterpart).
    p.add_argument("--multiGPU", action="store_true")
    p.add_argument("--numWorkers", dest="num_workers", type=int, default=8)

    # TPU-native extensions (no reference counterpart)
    p.add_argument("--dataDir", dest="data_dir", default="data")
    p.add_argument("--frameDir", dest="frame_dir", default="frames")
    p.add_argument("--dataset", default=None, choices=[None, "agqa", "star"])
    p.add_argument("--computeDtype", dest="compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--untieXLayers", dest="untie_x_layers", action="store_true")
    p.add_argument("--scanLayers", dest="scan_layers", action="store_true",
                   help="scanned layer stacks (different param tree)")
    p.add_argument("--pallasAttention", dest="use_pallas_attention",
                   action="store_true")
    p.add_argument("--noPallasAttentionTrain",
                   dest="use_pallas_attention_train", action="store_false",
                   help="disable the fused attention kernel at training "
                        "sites (on by default; see kernels/attention.py)")
    p.add_argument("--noPallasFFN", dest="use_pallas_ffn",
                   action="store_false")
    p.add_argument("--pallasFFNTrain", dest="use_pallas_ffn_train",
                   action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--rematPolicy", dest="remat_policy", default="",
                   choices=["", "dots", "dots_batch", "dots_attn"],
                   help="remat save policy: '' recomputes everything; "
                        "'dots' keeps matmul outputs and recomputes the "
                        "elementwise tail in backward")
    p.add_argument("--quantBackbone", dest="quant_backbone", default="",
                   choices=["", "int8"],
                   help="run the FROZEN trunk quantized (slow_r50): int8 "
                        "halves its HBM traffic and doubles the MXU rate; "
                        "activation scales calibrate on the init batch. "
                        "Implies --freeze-backbone semantics (the trunk "
                        "gets no gradient)")
    p.add_argument("--freezeBackbone", dest="freeze_backbone",
                   action="store_true",
                   help="freeze the video trunk (no gradients, no "
                        "optimizer state) - the STAR recipe's semantics "
                        "(star.py:87-88) exposed for every driver; AGQA's "
                        "reference default only eval()s BatchNorm")
    p.add_argument("--backboneChunks", dest="backbone_chunks", type=int,
                   default=1,
                   help="run the frozen backbone (and its frame "
                        "preprocessing) in N sequential micro-chunks; "
                        "peak-HBM lever for large batches, numerics "
                        "unchanged (configs/config.py)")
    p.add_argument("--stepsPerLoop", dest="steps_per_loop", type=int,
                   default=1,
                   help="train k BertAdam steps per launch (on a card "
                        "one replay of a k-step CUDA graph over k staged "
                        "batches; the same steps and draws as k single "
                        "steps: train/graph.py)")
    p.add_argument("--profile", action="store_true",
                   help="capture a profiler trace to {output}/profile")
    p.add_argument("--dataParallel", dest="data_parallel", type=int, default=-1)
    p.add_argument("--modelParallel", dest="model_parallel", type=int, default=1)
    p.add_argument("--syntheticData", dest="synthetic_data", type=int,
                   default=0, metavar="N",
                   help="run on N synthetic examples instead of files "
                        "(smoke/bench)")
    p.add_argument("--syntheticValid", dest="synthetic_valid", type=int,
                   default=0, metavar="M",
                   help="with --syntheticData: size the valid/test splits "
                        "at M items instead of N (keeps per-epoch eval "
                        "cheap in smoke runs)")
    p.add_argument("--vocab", dest="vocab_path", default=None,
                   help="WordPiece vocab.txt (default: {dataDir}/vocab.txt)")
    p.add_argument("--buildVocab", dest="build_vocab", action="store_true",
                   help="opt-in: when vocab.txt is missing, build a "
                        "whole-word vocab from the split corpus instead of "
                        "failing (NOT tokenization-parity with the "
                        "reference's bert-base-uncased vocab)")
    p.add_argument("--parityEval", dest="parity_eval", action="store_true",
                   help="reproduce the reference's drop_last=True valid "
                        "loader (agqaHGQA.py:74-78): the last partial valid "
                        "batch is dropped instead of padded+kept, so scores "
                        "are apples-to-apples with reference runs")
    p.add_argument("--bertWeights", dest="bert_weights", default=None,
                   help="bert-base pytorch_model.bin (or .npz) for the "
                        "non---fromScratch pretrained load (default: "
                        "{dataDir}/pytorch_model.bin)")
    # LXMERT pretraining flags (param.py:106-116, verbatim spellings)
    p.add_argument("--taskMatched", dest="task_matched", action="store_true")
    p.add_argument("--taskMaskLM", dest="task_mask_lm", action="store_true")
    p.add_argument("--taskObjPredict", dest="task_obj_predict",
                   action="store_true")
    p.add_argument("--taskQA", dest="task_qa_pretrain", action="store_true")
    p.add_argument("--taskContrastive", dest="task_contrastive",
                   action="store_true")
    p.add_argument("--visualLosses", dest="visual_losses",
                   default="obj,attr,feat")
    p.add_argument("--qaSets", dest="qa_sets", default=None)
    # --excludeSet is accepted verbatim (param.py:114) but has NO consumer
    # in the reference's shipped sources either (only param.py defines it);
    # kept for CLI compatibility.
    p.add_argument("--excludeSet", dest="exclude_set", default="")
    # --taskGrounding is a LATENT CRASH in the reference: the GroundingHead
    # import is commented out (modeling_capsbert.py:37,44) so :2040 raises
    # NameError the moment the flag is set.  Accept the spelling, fail with
    # a diagnosis instead of an obscure crash.
    p.add_argument("--taskGrounding", dest="task_grounding",
                   action="store_true")
    p.add_argument("--wordMaskRate", dest="word_mask_rate", type=float,
                   default=0.15)
    p.add_argument("--objMaskRate", dest="obj_mask_rate", type=float,
                   default=0.15)
    p.add_argument("--frameLoader", dest="frame_loader", default="auto",
                   choices=["auto", "native", "pil"],
                   help="frame decoder: native C++ (threaded libpng) with "
                        "PIL fallback (auto), or force one")
    p.add_argument("--backboneWeights", dest="backbone_weights", default=None,
                   help="converted backbone msgpack "
                        "(tools/convert_slow_r50.py; default: "
                        "{dataDir}/{backbone}_flax.msgpack)")
    p.add_argument("--vitWeights", dest="vit_weights", default=None,
                   help="ViT-B/32 checkpoint for --vitInit r-layer "
                        "initialization (timm vit_base_patch32_224 "
                        "state_dict; default: "
                        "{dataDir}/vit_base_patch32_224.bin)")
    return p


def _resolve_task(ns: argparse.Namespace) -> str:
    if ns.task_q:
        return "q"
    if ns.task_vqa:
        return "vqa"
    if ns.task_hgvqa:
        return "hgvqa"
    if ns.task_vhga:
        return "vhga"
    return "hgqa"


def parse_reference_flags(argv: Optional[Sequence[str]] = None,
                          dataset: Optional[str] = None) -> Config:
    """Parse reference-style argv into a typed Config.

    ``dataset`` may be forced by the entry point (the reference selects the
    dataset by which driver script you run: agqaHGQA.py vs star.py).
    """
    ns = build_parser().parse_args(argv)
    if getattr(ns, "task_grounding", False):
        raise SystemExit(
            "--taskGrounding is not runnable: the reference's GroundingHead "
            "import is commented out (modeling_capsbert.py:37,44), so the "
            "flag NameErrors there too (:2040). No grounding head exists to "
            "rebuild.")
    if getattr(ns, "attn_routing", False):
        raise SystemExit(
            "--attnRouting is not runnable: the reference hardcodes "
            "is_attn_routing=False and raises NotImplementedError otherwise "
            "(modeling_capsbert.py:1005,1010-1011).")
    cfg = Config()
    ds = dataset or ns.dataset or "agqa"

    # Per-backbone input geometry: the reference's slowfast transforms
    # resize to 256 (data_transforms.py:83,119) -> 8x8 feature grids; every
    # other pipeline uses 224 -> 7x7.  --imageSize overrides; the visual
    # token grid is always imageSize/32 (all trunks downsample 32x).
    image_size = ns.image_size or (
        256 if ns.backbone.startswith("slowfast") else 224)
    visual_hw = image_size // 32
    # slowfast features are the [slow, fast] channel concat at fast temporal
    # resolution: 2048 + 256 (models/backbones_extra.py SlowFastR50)
    visual_feat_dim = (3072 if ns.patches
                       else 2304 if ns.backbone.startswith("slowfast")
                       else cfg.encoder.visual_feat_dim)

    if ns.no_caps and ns.clip_len <= 8:
        raise SystemExit(
            f"--noCaps with --clipLEN {ns.clip_len}: the conv tokenizer is "
            "VALID over time (two kernel-5 convs, modeling_capsbert.py:"
            "989-996), so it needs clipLEN > 8 (the reference uses 16 -> 8 "
            "temporal tokens)")
    enc = cfg.encoder.__class__(
        no_caps=ns.no_caps,
        num_prim_caps=ns.NUM_PRIM_CAPS,
        num_vis_caps=ns.NUM_VIS_CAPS,
        pose_dim=ns.POSE_DIM,
        caps_skip_connection=ns.skip_connection,
        shared_weights=ns.shared_weights,
        caps_cross_attn=ns.cross_attn,
        patches=ns.patches,
        vit_init=ns.vit_init,
        # --patches flips the visual feature dim to the 32x32 RGB patch
        # flatten_dim (modeling_capsbert.py:173-174, 981-986); slowfast
        # trunks emit 2304 channels (see above)
        visual_feat_dim=visual_feat_dim,
        visual_hw=visual_hw,
        l_layers=ns.llayers,
        x_layers=ns.xlayers,
        r_layers=ns.rlayers,
        cross_attn_type=ns.cross_attn_type,
        tie_x_layers=not ns.untie_x_layers,
        scan_layers=ns.scan_layers,
        # caps tokenizer keeps the raw temporal length (no 16->8 conv
        # compression), so visual_t = clip_len; the no-caps conv tokenizer
        # is VALID in time (two kernel-5 convs, models/visual.py), so
        # visual_t = clip_len - 8 — the reference hardcodes t=8 for its
        # fixed clip of 16 (modeling_capsbert.py:188-189); deriving it keeps
        # masks and tokens consistent at any --clipLEN
        visual_t=(ns.clip_len - 8 if ns.no_caps else ns.clip_len),
    )
    dec = cfg.decoder.__class__(
        num_layers=ns.dlayers,
        dropout=ns.decoder_drop_rate,
        emb_dropout=ns.emb_drop_rate,
        linear_cls=ns.linear_cls,
    )
    data = cfg.data.__class__(
        dataset=ds,
        train_split=ns.train,
        valid_split=ns.valid,
        test_split=ns.test,
        data_dir=ns.data_dir,
        frame_dir=ns.frame_dir,
        clip_len=ns.clip_len,
        num_situations=ns.num_situations,
        num_rel=ns.num_rel,
        num_act=ns.num_act,
        augment_type=ns.augment_type,
        qa_arrange_type=ns.qa_arrange_type,
        qtype=ns.qtype,
        merge_data=ns.merge_data,
        merge_all=ns.merge_all,
        novel_comp=ns.novel_comp,
        indirect_ref=ns.indirect_ref,
        comp_steps=ns.comp_steps,
        tiny=ns.tiny,
        fast=ns.fast,
        train_sub_set=ns.train_sub_set,
        num_workers=ns.num_workers,
        parity_eval=ns.parity_eval,
        image_size=image_size,
    )
    optim = cfg.optim.__class__(
        optim=ns.optim,
        lr=ns.lr,
        epochs=ns.epochs,
        batch_size=ns.batch_size,
        eval_batch_size=max(1, ns.batch_size // 4) if ds == "agqa" else ns.batch_size,
    )
    mesh = cfg.mesh.__class__(
        data_parallel=ns.data_parallel,
        model_parallel=ns.model_parallel,
    )

    # STAR class counts differ from AGQA (see BASELINE.md)
    if ds == "star":
        num_rel_classes, num_act_classes, num_answers = 563, 111, 4
    else:
        num_rel_classes, num_act_classes, num_answers = 456, 157, 171

    cfg = Config(
        task=_resolve_task(ns),
        encoder=enc,
        decoder=dec,
        data=data,
        optim=optim,
        mesh=mesh,
        backbone=ns.backbone,
        # --quantBackbone implies a frozen trunk (the int8 forward has zero
        # gradient through round()); otherwise reference semantics: STAR
        # freezes (star.py:87-88), AGQA only eval()s BN
        freeze_backbone=(ds == "star") or bool(ns.quant_backbone)
        or ns.freeze_backbone,
        freeze_weights=ns.freeze_weights,
        from_scratch=ns.from_scratch,
        loss_hg_per_frame=ns.loss_hg_per_frame,
        use_hg_mask=ns.use_hg_mask,
        gt_hg=ns.gt_hg,
        eos_coef=ns.no_object_weight,
        mce_loss=ns.mce_loss,
        num_rel_classes=num_rel_classes,
        num_act_classes=num_act_classes,
        num_answers=num_answers,
        seed=ns.seed,
        output=ns.output,
        load=ns.load,
        log_freq=ns.log_freq,
        output_attention=ns.output_attention,
        compute_dtype=ns.compute_dtype,
        quant_backbone=ns.quant_backbone,
        remat=ns.remat,
        remat_policy=ns.remat_policy,
        profile=ns.profile,
        use_pallas_attention=ns.use_pallas_attention,
        use_pallas_attention_train=ns.use_pallas_attention_train,
        use_pallas_ffn=ns.use_pallas_ffn,
        use_pallas_ffn_train=ns.use_pallas_ffn_train,
        backbone_chunks=ns.backbone_chunks,
        steps_per_loop=ns.steps_per_loop,
    )
    cfg = cfg.replace(after_cross_attn_feats=ns.after_cross_attn_feats)
    cfg.validate()
    return cfg


def parse_reference_flags_with_extras(argv: Optional[Sequence[str]] = None,
                                      dataset: Optional[str] = None):
    """Like parse_reference_flags, plus driver-only extras (synthetic data
    size, vocab path, tqdm)."""
    ns = build_parser().parse_args(argv)
    cfg = parse_reference_flags(argv, dataset)
    extras = {
        "synthetic_data": ns.synthetic_data,
        "synthetic_valid": ns.synthetic_valid,
        "vocab_path": ns.vocab_path,
        "build_vocab": ns.build_vocab,
        "tqdm": ns.tqdm,
        "load_lxmert": ns.load_lxmert,
        "load_lxmert_qa": ns.load_lxmert_qa,
        "bert_weights": ns.bert_weights,
        "backbone_weights": ns.backbone_weights,
        "vit_weights": ns.vit_weights,
        "start_index": ns.start_index,
        "frame_loader": ns.frame_loader,
        "multi_gpu": ns.multiGPU,
        "pretrain": {
            "task_matched": ns.task_matched,
            "task_mask_lm": ns.task_mask_lm,
            "task_obj_predict": ns.task_obj_predict,
            "task_qa": ns.task_qa_pretrain,
            "task_contrastive": ns.task_contrastive,
            "visual_losses": ns.visual_losses,
            "qa_sets": ns.qa_sets,
            "word_mask_rate": ns.word_mask_rate,
            "obj_mask_rate": ns.obj_mask_rate,
        },
    }
    return cfg, extras

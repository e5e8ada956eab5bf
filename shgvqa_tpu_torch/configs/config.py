"""Typed configuration: the port's own copy of ``shgvqa_tpu/configs/config.py``.

The dataclasses keep the JAX package's field names and defaults, so one set
of overrides configures both packages.  ``check_ported`` names every option
this slice of the port does not implement yet; the models call it and raise
``NotImplementedError`` instead of ignoring an option.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class EncoderConfig:
    """LXMERT-style tri-stream encoder dimensions (bert-base by default)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    l_layers: int = 5
    x_layers: int = 2
    r_layers: int = 5

    # 'cross' | 'self' | 'cross_self' | 'old'
    cross_attn_type: str = "cross"
    scan_layers: bool = False
    # the published model ties its x_layers: one module called x_layers times
    tie_x_layers: bool = True

    no_caps: bool = True
    num_prim_caps: int = 32
    num_vis_caps: int = 32
    pose_dim: int = 4
    caps_mask_features: bool = True
    caps_skip_connection: bool = False
    shared_weights: bool = False
    caps_cross_attn: bool = False
    patches: bool = False
    vit_init: bool = False
    visual_feat_dim: int = 2048
    visual_t: int = 8          # temporal tokens after the conv tokenizer (16 -> 8)
    visual_hw: int = 7         # spatial tokens per side

    @property
    def visual_seq_length(self) -> int:
        return self.visual_t * self.visual_hw * self.visual_hw + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class DecoderConfig:
    """Situation-hypergraph DETR-style decoder."""

    num_layers: int = 5
    num_heads: int = 12
    ffn_dim: int = 2048
    dropout: float = 0.15
    emb_dropout: float = 0.15
    linear_cls: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset geometry and paths."""

    dataset: str = "agqa"
    train_split: str = "train"
    valid_split: Optional[str] = "valid"
    test_split: Optional[str] = None

    data_dir: str = "data"
    frame_dir: str = "frames"

    clip_len: int = 16
    num_situations: int = 16
    num_rel: int = 8
    num_act: int = 3
    max_seq_length: int = 40
    image_size: int = 224

    # training only: no_aug / no_aug_slowfast leave the frames alone,
    # rand_aug / rand_aug_slowfast run RandAugment, aug_mix AugMix
    # (data/transforms.py)
    augment_type: str = "no_aug"
    # dtype of the frames pipeline; "" follows compute_dtype
    aug_dtype: str = ""
    # run each heavy op class on the clips that drew it
    aug_subbatch: bool = True
    # aug_mix: the chains as one (width * B) batch
    aug_fold_chains: bool = True
    qa_arrange_type: str = "add_sep_all"
    qtype: str = "Feasibility"
    merge_data: bool = False
    merge_all: bool = False

    novel_comp: bool = False
    indirect_ref: bool = False
    comp_steps: bool = False

    tiny: bool = False
    fast: bool = False
    train_sub_set: bool = False

    num_workers: int = 8
    prefetch: int = 2
    parity_eval: bool = False

    @property
    def hg_tokens_per_situation(self) -> int:
        return self.num_rel + self.num_act

    @property
    def num_rel_queries(self) -> int:
        return self.num_situations * self.num_rel

    @property
    def num_act_queries(self) -> int:
        return self.num_situations * self.num_act


@dataclass(frozen=True)
class OptimConfig:
    """BertAdam-equivalent optimizer."""

    optim: str = "bert"
    lr: float = 1e-5
    epochs: int = 100
    batch_size: int = 32
    eval_batch_size: int = 8
    warmup: float = 0.1
    schedule: str = "warmup_linear"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    grad_clip: float = 5.0
    early_stop_patience: int = 10


@dataclass(frozen=True)
class MeshConfig:
    """Data/model parallel layout."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    """Top-level run configuration."""

    task: str = "hgqa"             # 'q' | 'vqa' | 'hgqa' | 'vhga' | 'hgvqa'

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    backbone: str = "slow_r50"
    freeze_backbone: bool = True
    freeze_weights: bool = False
    from_scratch: bool = True

    loss_hg_per_frame: bool = True
    use_hg_mask: bool = False
    gt_hg: bool = False
    eos_coef: float = 0.1
    mce_loss: bool = False

    num_rel_classes: int = 456
    num_act_classes: int = 157
    num_answers: int = 171

    after_cross_attn_feats: bool = False

    seed: int = 9595
    output: str = "snap/run"
    load: Optional[str] = None
    log_freq: int = 50
    output_attention: bool = False

    # execution policy
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    quant_backbone: str = ""
    remat: bool = False
    remat_policy: str = ""
    profile: bool = False
    use_pallas_attention: bool = False
    use_pallas_attention_train: bool = True
    # the fused FFN kernel at every inference FFN site (kernels/ffn.py)
    use_pallas_ffn: bool = True
    use_pallas_ffn_train: bool = False
    donate_state: bool = True
    steps_per_loop: int = 1
    backbone_chunks: int = 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def background_idx(self) -> int:
        return 0

    def validate(self) -> None:
        assert self.task in ("q", "vqa", "hgqa", "vhga", "hgvqa"), self.task
        assert self.encoder.hidden_size % self.encoder.num_heads == 0
        assert self.data.num_rel_queries % self.data.clip_len == 0
        assert self.encoder.cross_attn_type in ("cross", "self", "cross_self", "old")


def tiny_test_config(**overrides) -> Config:
    """A CPU-sized config for unit tests: tiny dims, same topology."""
    enc = EncoderConfig(
        vocab_size=128,
        hidden_size=32,
        num_heads=4,
        intermediate_size=64,
        l_layers=2,
        x_layers=2,
        r_layers=2,
        visual_feat_dim=16,
        visual_t=2,
        visual_hw=2,
    )
    dec = DecoderConfig(num_layers=2, num_heads=4, ffn_dim=64)
    data = DataConfig(
        clip_len=4,
        num_situations=4,
        num_rel=3,
        num_act=2,
        max_seq_length=12,
        image_size=32,
    )
    optim = OptimConfig(lr=1e-3, epochs=2, batch_size=2, eval_batch_size=2)
    cfg = Config(
        encoder=enc,
        decoder=dec,
        data=data,
        optim=optim,
        num_rel_classes=11,
        num_act_classes=7,
        num_answers=13,
        compute_dtype="float32",
    )
    cfg = cfg.replace(**overrides)
    cfg.validate()
    return cfg


# the tasks whose model predicts a hypergraph
HG_TASKS = ("hgqa", "vhga", "hgvqa")

# STAR's per-choice QA arrangements (--qaArrangeType): one encoding per
# (question, choice) pair, scored by the model's scalar choice head
PER_CHOICE = ("add_sep", "no_sep")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# (field path, value the port supports, ROADMAP queue-A item that ports it)
_UNPORTED = (
    ("encoder.scan_layers", False, "19 (scan stacks)"),
    ("encoder.no_caps", True, "17 (capsules)"),
    ("encoder.shared_weights", False, "17 (--sharedWeights)"),
    ("encoder.patches", False, "17 (--patches)"),
    ("encoder.vit_init", False, "17 (--vitInit)"),
)

# options only training reads
_TRAIN_UNPORTED = (
    ("remat", False, "19 (remat policies)"),
)

_VIDEO_UNPORTED = (
    ("backbone", "slow_r50", "17 (other backbones)"),
)


def check_ported(cfg: Config, video: bool = False, train: bool = False
                 ) -> None:
    """Raise NotImplementedError for any option this slice does not port.

    ``video=True`` also checks the frames path (backbone options);
    ``train=True`` the options only training reads."""
    checks = (_UNPORTED + (_VIDEO_UNPORTED if video else ())
              + (_TRAIN_UNPORTED if train else ()))
    for path, want, item in checks:
        got = cfg
        for part in path.split("."):
            got = getattr(got, part)
        if got != want:
            raise NotImplementedError(
                f"{path}={got!r} is not ported yet (ROADMAP queue A item "
                f"{item}); the port supports {path}={want!r}")

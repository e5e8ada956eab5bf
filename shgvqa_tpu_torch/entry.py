"""Entry points of the port: the flagship config, an example batch, the
frames -> ``hg_logit`` forward on the card, and the flagship train step.

``flagship_cfg`` and ``example_batch`` copy ``__graft_entry__._flagship_cfg``
and ``_example_batch`` (published AGQA HGQA dims: bert-base, 5/2/5 encoder
layers, 5 decoder layers, a 16 x (8 rel + 3 act) hypergraph, slow_r50, bf16
compute).  ``entry`` returns ``(fn, args)`` like ``__graft_entry__.entry``;
it runs the frames path of ``bench.py``: uint8 frames through on-device
normalization, the trunk and the head.  ``train_entry`` returns what the
flagship train step needs: the model in training mode, its optimizer
(global-norm clip + BertAdam over the trainable parameters), a generator
for the augmentation and the dropout masks and a labelled batch (the
labels of ``__graft_entry__._example_batch(with_labels=True)``); the
trunk frozen and no augmentation (the config's defaults), or with
``published=True`` the published AGQA recipe's trunk and augmentation
(``published_train_cfg``).  ``quant_backbone='int8'`` runs the frozen
trunk in int8 (``trunk_cfg``), its scales calibrated on the batch after the
BatchNorm statistics; ``backbone_chunks`` N runs the frozen frames path in
N micro-chunks.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a CUDA device it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from shgvqa_tpu_torch.configs.config import Config
from shgvqa_tpu_torch.models.backbone import calibrate_frozen_bn
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel, VideoShgVqaModel
from shgvqa_tpu_torch.train.optimizer import BertAdam, make_optimizer
from shgvqa_tpu_torch.train.step import trainable_mask


def flagship_cfg() -> Config:
    cfg = Config()
    cfg.validate()
    return cfg


def example_batch(cfg: Config, batch_size: int = 2, seed: int = 0,
                  with_labels: bool = False) -> Dict[str, np.ndarray]:
    """Random inputs at the config's shapes; float frames in [0, 1); with
    ``with_labels`` also a one-hot answer ``target`` and per-frame relation
    and action label grids with their lengths (the same draws as
    ``__graft_entry__._example_batch``)."""
    rng = np.random.RandomState(seed)
    d, e = cfg.data, cfg.encoder
    batch = {
        "input_ids": rng.randint(
            1, e.vocab_size, (batch_size, d.max_seq_length)).astype(np.int32),
        "input_mask": np.ones((batch_size, d.max_seq_length), np.int32),
        "segment_ids": np.zeros((batch_size, d.max_seq_length), np.int32),
        "frames": rng.rand(
            batch_size, d.clip_len, d.image_size, d.image_size, 3
        ).astype(np.float32),
        "visual_mask": np.ones((batch_size, e.visual_seq_length), np.int32),
        "hg_mask": np.ones(
            (batch_size, d.num_situations, d.num_act + d.num_rel), np.int32),
    }
    if with_labels:
        tgt = np.zeros((batch_size, cfg.num_answers), np.float32)
        tgt[np.arange(batch_size),
            rng.randint(cfg.num_answers, size=batch_size)] = 1.0
        s = d.num_situations
        batch.update({
            "rel_labels": rng.randint(
                1, cfg.num_rel_classes + 1,
                (batch_size, s, d.num_rel)).astype(np.int32),
            "rel_lengths": rng.randint(
                1, d.num_rel + 1, (batch_size, s)).astype(np.int32),
            "act_labels": rng.randint(
                1, cfg.num_act_classes + 1,
                (batch_size, s, d.num_act)).astype(np.int32),
            "act_lengths": rng.randint(
                1, d.num_act + 1, (batch_size, s)).astype(np.int32),
            "target": tgt,
        })
    return batch


def published_train_cfg() -> Config:
    """The flagship as the published AGQA recipe trains it
    (``README.md``: no ``--freezeBackbone``, ``--augmentType rand_aug``):
    the trunk trains, and RandAugment runs on the device."""
    cfg = flagship_cfg()
    return cfg.replace(freeze_backbone=False, data=dataclasses.replace(
        cfg.data, augment_type="rand_aug"))


def trunk_cfg(cfg: Config, quant_backbone: str = "",
              backbone_chunks: int = 1) -> Config:
    """``cfg`` with ``--quantBackbone`` and ``--backboneChunks``; the int8
    trunk is frozen, as the CLI implies."""
    return cfg.replace(quant_backbone=quant_backbone,
                       backbone_chunks=backbone_chunks,
                       freeze_backbone=(cfg.freeze_backbone
                                        or bool(quant_backbone)))


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev


def build_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """A ``VideoShgVqaModel`` (task 'q': the question-only ``ShgVqaModel``,
    as the JAX driver's ``make_model``) with seeded random weights, in eval
    mode, on ``device`` (channels-last 3-D convs on the card)."""
    dev = resolve_device(device)
    cls = ShgVqaModel if cfg.task == "q" else VideoShgVqaModel
    model = init_weights(cls(cfg), seed).eval()
    if dev.type == "cuda":
        return model.to(device=dev, memory_format=torch.channels_last_3d)
    return model.to(dev)


def device_batch(cfg: Config, batch_size: int = 2, seed: int = 0,
                 device="cuda", with_labels: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """``example_batch`` with uint8 frames (the input pipeline's dtype),
    staged on ``device``."""
    dev = resolve_device(device)
    batch = example_batch(cfg, batch_size, seed, with_labels)
    batch["frames"] = (batch["frames"] * 255.0).astype(np.uint8)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def hg_logit_forward(model: VideoShgVqaModel,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    with torch.inference_mode():
        return model(batch)["hg_logit"]


def entry(device="cuda", batch_size: int = 2, seed: int = 0,
          quant_backbone: str = "", backbone_chunks: int = 1
          ) -> Tuple[Callable, tuple]:
    """(fn, args): ``fn(*args)`` is the flagship uint8 frames -> hg_logit
    forward with random weights from ``seed`` (with ``quant_backbone``
    the int8 trunk, its scales calibrated on the batch)."""
    cfg = trunk_cfg(flagship_cfg(), quant_backbone, backbone_chunks)
    model = build_model(cfg, device, seed)
    batch = device_batch(cfg, batch_size, seed, device)
    if quant_backbone:
        model.calibrate_quant(batch["frames"])
    return hg_logit_forward, (model, batch)


# schedule length of ``train_entry``'s optimizer: short enough that the
# warmup's lr (0 on the first step) moves the weights within a few steps
TRAIN_T_TOTAL = 100


class TrainEntry(NamedTuple):
    model: VideoShgVqaModel
    optimizer: BertAdam
    generator: torch.Generator
    batch: Dict[str, torch.Tensor]


def train_entry(device="cuda", batch_size: int = 32, seed: int = 0,
                published: bool = False, quant_backbone: str = "",
                backbone_chunks: int = 1) -> TrainEntry:
    """The flagship train step's pieces at the published batch (32): the
    model with random weights from ``seed`` in training mode (the trunk's
    BatchNorm statistics calibrated on the batch's unaugmented frames, as a
    pretrained trunk's normalize its activations: ``calibrate_frozen_bn``;
    training leaves them alone), its optimizer (the config's BertAdam over
    ``TRAIN_T_TOTAL`` steps, so the first update has lr 0), a generator
    seeded with ``seed`` on ``device`` for the augmentation and the dropout
    masks, and a labelled batch with uint8 frames.  The trunk is frozen and
    the frames unaugmented, or with ``published`` as the published recipe
    trains (``published_train_cfg``); with ``quant_backbone`` the int8
    trunk (frozen), its scales calibrated on the batch after the
    statistics.  Run a step with
    ``train.step.make_train_step(model.cfg, model, optimizer)``."""
    cfg = trunk_cfg(published_train_cfg() if published else flagship_cfg(),
                    quant_backbone, backbone_chunks)
    model = build_model(cfg, device, seed)
    dev = resolve_device(device)
    batch = device_batch(cfg, batch_size, seed, dev, with_labels=True)
    calibrate_frozen_bn(model.backbone,
                        model.normalize_frames(batch["frames"]))
    if quant_backbone:
        model.calibrate_quant(batch["frames"])
    model.train()
    o = cfg.optim
    optimizer = make_optimizer(
        model, o.lr, TRAIN_T_TOTAL, o.warmup, o.schedule, o.b1, o.b2, o.eps,
        o.weight_decay, o.grad_clip, trainable_mask(model, cfg), o.optim)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainEntry(model, optimizer, generator, batch)

"""Entry points of the port: the flagship config, an example batch, and the
frames -> ``hg_logit`` forward on the card.

``flagship_cfg`` and ``example_batch`` copy ``__graft_entry__._flagship_cfg``
and ``_example_batch`` (published AGQA HGQA dims: bert-base, 5/2/5 encoder
layers, 5 decoder layers, a 16 x (8 rel + 3 act) hypergraph, slow_r50, bf16
compute).  ``entry`` returns ``(fn, args)`` like ``__graft_entry__.entry``;
it runs the frames path of ``bench.py``: uint8 frames through on-device
normalization, the trunk and the head.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a CUDA device it raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from shgvqa_tpu_torch.configs.config import Config
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel


def flagship_cfg() -> Config:
    cfg = Config()
    cfg.validate()
    return cfg


def example_batch(cfg: Config, batch_size: int = 2, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """Random inputs at the config's shapes; float frames in [0, 1)."""
    rng = np.random.RandomState(seed)
    d, e = cfg.data, cfg.encoder
    return {
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


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev


def build_model(cfg: Config, device="cuda", seed: int = 0) -> VideoShgVqaModel:
    """A ``VideoShgVqaModel`` with seeded random weights, in eval mode, on
    ``device`` (channels-last 3-D convs on the card)."""
    dev = resolve_device(device)
    model = init_weights(VideoShgVqaModel(cfg), seed).eval()
    if dev.type == "cuda":
        return model.to(device=dev, memory_format=torch.channels_last_3d)
    return model.to(dev)


def device_batch(cfg: Config, batch_size: int = 2, seed: int = 0,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """``example_batch`` with uint8 frames (the input pipeline's dtype),
    staged on ``device``."""
    dev = resolve_device(device)
    batch = example_batch(cfg, batch_size, seed)
    batch["frames"] = (batch["frames"] * 255.0).astype(np.uint8)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def hg_logit_forward(model: VideoShgVqaModel,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    with torch.inference_mode():
        return model(batch)["hg_logit"]


def entry(device="cuda", batch_size: int = 2, seed: int = 0
          ) -> Tuple[Callable, tuple]:
    """(fn, args): ``fn(*args)`` is the flagship uint8 frames -> hg_logit
    forward with random weights from ``seed``."""
    cfg = flagship_cfg()
    model = build_model(cfg, device, seed)
    return hg_logit_forward, (model, device_batch(cfg, batch_size, seed,
                                                  device))

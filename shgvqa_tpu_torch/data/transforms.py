"""Clip normalization: the port's copy of ``NORM_STATS`` and
``normalize_clip`` from ``shgvqa_tpu/data/transforms.py``.  Augmentation is
not ported yet (ROADMAP queue A item 12)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

NORM_STATS: Dict[str, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {
    "slow_r50": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "slowfast_r50": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "slowfast_r101": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "resnext101": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "mvit_B": ((0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "video_swin_impl": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def normalize_clip(frames01: torch.Tensor, mean, std) -> torch.Tensor:
    """(..., 3) frames in [0, 1] -> (x - mean) / std over the channel axis,
    in the frames' dtype."""
    mean = torch.tensor(mean, dtype=frames01.dtype, device=frames01.device)
    std = torch.tensor(std, dtype=frames01.dtype, device=frames01.device)
    return (frames01 - mean) / std

"""Hypergraph query featurization: the port's copy of the two helpers of
``shgvqa_tpu/data/featurize.py`` that the model reads."""

from __future__ import annotations

import numpy as np


def hg_segment_ids(num_situations: int, slots_per_situation: int) -> np.ndarray:
    """Situation-index token-type ids for HG queries: each situation index
    repeated once per slot."""
    return np.repeat(
        np.arange(num_situations, dtype=np.int32), slots_per_situation
    )


def situation_causal_mask(num_situations: int, slots_per_situation: int,
                          neg: float = float("-inf")) -> np.ndarray:
    """Additive (Q, Q) mask: situation t attends to situations <= t (-inf
    above the block diagonal)."""
    situ = np.triu(np.full((num_situations, num_situations), neg,
                           dtype=np.float32), k=1)
    return np.repeat(np.repeat(situ, slots_per_situation, axis=1),
                     slots_per_situation, axis=0)

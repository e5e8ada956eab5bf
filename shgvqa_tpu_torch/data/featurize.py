"""Vectorized featurization: the port's own copy of the helpers of
``shgvqa_tpu/data/featurize.py`` that the model and the AGQA data read.

- question encoding: ``[CLS] q [SEP]`` then zero-pad to ``max_seq_length``;
  padding id 0, mask 1 for real tokens;
- hypergraph label grids: per-situation label lists padded with 0 (class 0
  is background; real labels start at 1) to ``num_rel``/``num_act`` wide,
  subsampled to ``num_situations`` frames by nearest-neighbour linspace;
- hg_mask per situation: the action-token mask then the relation-token
  mask, the decoder's hg token order;
- segment ids of the HG queries and the situation-causal mask.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def uniform_subsample_indices(t: int, num_samples: int) -> np.ndarray:
    """Nearest-neighbour linspace indices of ``num_samples`` out of ``t``."""
    assert t > 0 and num_samples > 0
    idx = np.linspace(0.0, float(t - 1), num_samples, dtype=np.float32)
    return np.clip(idx, 0, t - 1).astype(np.int64)


def encode_questions(sents: Sequence[str], tokenizer, max_seq_length: int
                     ) -> Dict[str, np.ndarray]:
    """[CLS] tokens [SEP] + zero pad; returns int32 (B, L) arrays."""
    n = len(sents)
    input_ids = np.zeros((n, max_seq_length), dtype=np.int32)
    input_mask = np.zeros((n, max_seq_length), dtype=np.int32)
    segment_ids = np.zeros((n, max_seq_length), dtype=np.int32)
    cls_id = tokenizer.vocab["[CLS]"]
    sep_id = tokenizer.vocab["[SEP]"]
    for i, sent in enumerate(sents):
        toks = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(sent.strip()))
        toks = toks[: max_seq_length - 2]
        ids = [cls_id] + toks + [sep_id]
        input_ids[i, : len(ids)] = ids
        input_mask[i, : len(ids)] = 1
    return {
        "input_ids": input_ids,
        "input_mask": input_mask,
        "segment_ids": segment_ids,
    }


def pack_hg_labels(per_situation_labels: Sequence[Sequence[int]],
                   num_situations: int, max_slots: int
                   ) -> Dict[str, np.ndarray]:
    """Ragged per-situation label lists -> fixed grid + lengths.

    Returns labels (S, K) int32 padded with 0, lengths (S,) int32 clamped to
    K, and the subsample indices of the frames."""
    t = len(per_situation_labels)
    grid = np.zeros((t, max_slots), dtype=np.int32)
    raw_lengths = np.zeros((t,), dtype=np.int32)
    for i, labs in enumerate(per_situation_labels):
        labs = list(labs)[:max_slots]
        grid[i, : len(labs)] = labs
        raw_lengths[i] = len(per_situation_labels[i])
    idx = uniform_subsample_indices(t, num_situations)
    labels = grid[idx]
    lengths = np.minimum(raw_lengths[idx], max_slots).astype(np.int32)
    return {"labels": labels, "lengths": lengths, "subsample_indices": idx}


def hg_token_mask(act_labels: np.ndarray, rel_labels: np.ndarray) -> np.ndarray:
    """Binary mask over hypergraph tokens, act slots then rel slots: 1 where
    the padded label grid is nonzero."""
    act_mask = (act_labels > 0).astype(np.int32)
    rel_mask = (rel_labels > 0).astype(np.int32)
    return np.concatenate([act_mask, rel_mask], axis=-1)


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

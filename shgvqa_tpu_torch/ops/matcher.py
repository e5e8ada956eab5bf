"""Batched exact Hungarian matching on the device: the port of the per-frame
mode of ``shgvqa_tpu/ops/matcher.py``.

The per-frame problems are small (B x S problems of num_rel x num_rel and
num_act x num_act), so each is solved exactly by the Held-Karp subset DP of
``hungarian_bitmask_dp`` (:117-156), batched over a leading dimension in
place of ``vmap``: n forward steps, each one gather + min over
(..., 2^n, n), and n backtrack steps, with no data-dependent control flow
and no host round trip.  ``torch.argmin`` and ``jnp.argmin`` both take the
first minimum, so ties resolve as in the JAX solver and the target grids
agree bit for bit.

Rectangular problems are padded to square with a constant cost column
(``assign_padded`` :164-182), which keeps them exact.  Costs are
-softmax(logits)[target class], computed without a graph.  The global mode
(one 128 x 128 problem per clip, ``loss_hg_per_frame=False``) needs the
augmenting-path solver and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

INF = 1e9
DP_MAX_N = 12


def hungarian_bitmask_dp(cost: torch.Tensor) -> torch.Tensor:
    """Exact n x n assignment minimizing the total cost, for every problem
    of a batch: cost (..., n, n) -> row_to_col (..., n) int64."""
    n = cost.shape[-1]
    m = 1 << n
    dev = cost.device
    cost = cost.float()
    masks = torch.arange(m, device=dev)
    bit = 1 << torch.arange(n, device=dev)
    in_mask = (masks[:, None] & bit[None, :]) != 0              # (m, n)
    xor_table = masks[:, None] ^ bit[None, :]                   # (m, n)
    dp = torch.full(cost.shape[:-2] + (m,), INF, device=dev)
    dp[..., 0] = 0.0
    choices = []
    for i in range(n):
        cand = torch.where(in_mask, dp[..., xor_table] + cost[..., i, None, :],
                           INF)                                  # (..., m, n)
        choices.append(torch.argmin(cand, dim=-1))
        dp = torch.amin(cand, dim=-1)
    row_to_col = torch.zeros(cost.shape[:-1], dtype=torch.long, device=dev)
    mask = torch.full(cost.shape[:-2] + (1,), m - 1, dtype=torch.long,
                      device=dev)
    for i in range(n - 1, -1, -1):
        j = torch.gather(choices[i], -1, mask)
        row_to_col[..., i] = j[..., 0]
        mask = mask ^ (1 << j)
    return row_to_col


def assign_padded(cost: torch.Tensor, num_valid_cols: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assignment on (..., n_rows, n_cols) costs of which the first
    ``num_valid_cols`` (...) columns are real; the others are padded to the
    constant 0, above any real -softmax cost.  Returns (row_to_col
    (..., n_rows), matched (..., n_rows) bool)."""
    n_rows, n_cols = cost.shape[-2:]
    n = max(n_rows, n_cols)
    if n > DP_MAX_N:
        raise NotImplementedError(
            f"a {n_rows} x {n_cols} assignment needs the augmenting-path "
            "solver, which is not ported yet (ROADMAP queue A item 8)")
    valid = num_valid_cols[..., None, None]
    cols = torch.arange(n_cols, device=cost.device)
    cost = torch.where(cols < valid, cost, 0.0)
    if n != n_rows or n != n_cols:
        square = cost.new_zeros(cost.shape[:-2] + (n, n))
        square[..., :n_rows, :n_cols] = cost
        cost = square
    row_to_col = hungarian_bitmask_dp(cost)[..., :n_rows]
    return row_to_col, row_to_col < num_valid_cols[..., None]


def match_targets_per_frame(logits: torch.Tensor, labels: torch.Tensor,
                            lengths: torch.Tensor, background_idx: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame Hungarian matching: logits (B, S, R, C) raw class logits,
    labels (B, S, K) padded target labels, lengths (B, S) valid targets
    per frame.  Returns (target classes (B, S, R) int64, the background
    index where unmatched; matched (B, S, R) bool)."""
    with torch.no_grad():
        b, s, r, _ = logits.shape
        labels = labels.long()
        prob = torch.softmax(logits.float(), dim=-1)
        idx = labels[:, :, None, :].expand(b, s, r, labels.shape[-1])
        cost = -torch.gather(prob, -1, idx)                      # (B, S, R, K)
        row_to_col, matched = assign_padded(cost, lengths.long())
        gathered = torch.gather(
            labels, -1, row_to_col.clamp(max=labels.shape[-1] - 1))
        return torch.where(matched, gathered, background_idx), matched

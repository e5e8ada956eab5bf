"""Batched exact Hungarian matching on the device: the port of
``shgvqa_tpu/ops/matcher.py``.

- The per-frame problems are small (B x S problems of num_rel x num_rel and
  num_act x num_act), so each is solved exactly by the Held-Karp subset DP
  of ``hungarian_bitmask_dp`` (:117-156), batched over a leading dimension
  in place of ``vmap``: n forward steps, each one gather + min over
  (..., 2^n, n), and n backtrack steps, with no data-dependent control flow
  and no host round trip.
- The global problems (one per clip, 128 x 128 for the relations and
  48 x 48 for the actions of the flagship, ``loss_hg_per_frame=False``) go
  to ``hungarian_square`` (:37-114), the shortest-augmenting-path solver:
  on the card the hand-written kernel of ``csrc/matcher.cu`` (one launch a
  batch; its shared-memory path up to ``shgvqa_hungarian_max_n()``, its
  large path, cost in global memory, above it, so any n), on the CPU its
  plain version ``hungarian_square_reference``, the JAX solver's
  fixed-trip arithmetic batched over a leading dimension.

``torch.argmin`` and ``jnp.argmin`` both take the first minimum (as the
kernel's reduction does), so ties resolve as in the JAX solvers and the
target grids agree bit for bit.  Rectangular problems are padded to square
with a constant cost column (``assign_padded`` :164-182), which keeps them
exact.  Costs are -softmax(logits)[target class], computed without a graph.
Nothing here reads a device value on the host on a card, so a CUDA graph of
the train step captures the matching.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.kernels.attention import _stream

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


def _augmenting_path_solve(cost: torch.Tensor, early_exit: bool = True):
    """The JAX ``hungarian_square`` on a batch (P, n, n) of f32 costs, step
    for step (1-indexed, column 0 the path sentinel).  Returns (p (P, n+1)
    the row of each column, u and v (P, n+1) the potentials, steps (P,) the
    search steps each problem took while not done).

    JAX runs each row's search and path walk for a fixed n + 1 trips.  Once
    a problem is done its trips are masked no-ops: ``delta`` is 0 and
    ``used_f`` is 0, so u, v and minv move by 0 * x, and ``better`` is
    False, so minv and way keep their values.  With ``early_exit`` the loops
    stop when every problem of the batch is done (a host read of the flags
    a step); the results are the fixed trips' own."""
    bsz, n = cost.shape[0], cost.shape[-1]
    dev = cost.device
    m = n + 1
    cx = torch.zeros(bsz, m, m, device=dev)
    cx[:, 1:, 1:] = cost.float()
    u = torch.zeros(bsz, m, device=dev)
    v = torch.zeros(bsz, m, device=dev)
    p = torch.zeros(bsz, m, dtype=torch.long, device=dev)
    way = torch.zeros(bsz, m, dtype=torch.long, device=dev)
    steps = torch.zeros(bsz, dtype=torch.long, device=dev)
    rows = torch.arange(bsz, device=dev)
    cols = torch.arange(m, device=dev)
    for i in range(1, m):
        p[:, 0] = i
        minv = torch.full((bsz, m), INF, device=dev)
        used = torch.zeros(bsz, m, dtype=torch.bool, device=dev)
        j0 = torch.zeros(bsz, dtype=torch.long, device=dev)
        done = torch.zeros(bsz, dtype=torch.bool, device=dev)
        for _ in range(m):
            if early_exit and bool(done.all()):
                break
            active = ~done
            used = used | ((cols == j0[:, None]) & active[:, None])
            i0 = p[rows, j0]
            cur = cx[rows, i0] - u[rows, i0][:, None] - v
            better = (cur < minv) & ~used & active[:, None]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(used, INF, minv)
            masked[:, 0] = INF
            j1 = torch.argmin(masked, dim=-1)
            delta = torch.where(active, masked[rows, j1], 0.0)[:, None]
            used_f = torch.where(active[:, None], used.float(), 0.0)
            u = u + delta * torch.zeros_like(u).scatter_add_(1, p, used_f)
            v = v - delta * used_f
            minv = minv - delta * (1.0 - used.float())
            j0 = torch.where(active, j1, j0)
            steps += active
            done = done | (p[rows, j0] == 0)
        for _ in range(m):
            active = j0 != 0
            if early_exit and not bool(active.any()):
                break
            j1 = way[rows, j0]
            p[rows, j0] = torch.where(active, p[rows, j1], p[rows, j0])
            j0 = torch.where(active, j1, j0)
    return p, u, v, steps


def _row_to_col(p: torch.Tensor) -> torch.Tensor:
    """(P, n+1) row of each column -> (P, n) column of each row, 0-based."""
    n = p.shape[-1] - 1
    cols = torch.arange(n, device=p.device).expand(p.shape[0], n)
    return torch.zeros_like(cols).scatter_(1, p[:, 1:] - 1, cols)


def hungarian_square_reference(cost: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: cost (..., n, n) -> row_to_col (..., n)
    int64, a permutation minimizing the total cost of each problem."""
    n = cost.shape[-1]
    p = _augmenting_path_solve(cost.reshape(-1, n, n))[0]
    return _row_to_col(p).reshape(cost.shape[:-1])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/matcher.cu`` with its C signatures declared."""
    lib = _build.load("matcher")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shgvqa_hungarian.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.shgvqa_hungarian.restype = i32
    lib.shgvqa_hungarian_max_n.argtypes = []
    lib.shgvqa_hungarian_max_n.restype = i32
    lib.shgvqa_hungarian_large.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.shgvqa_hungarian_large.restype = i32
    lib.shgvqa_hungarian_large_smem_max_n.argtypes = []
    lib.shgvqa_hungarian_large_smem_max_n.restype = i32
    lib.shgvqa_hungarian_large_stride.argtypes = [i32]
    lib.shgvqa_hungarian_large_stride.restype = ctypes.c_size_t
    lib.shgvqa_matcher_error_string.argtypes = [i32]
    lib.shgvqa_matcher_error_string.restype = ctypes.c_char_p
    return lib


# the kernel's paths (``_launch``'s ``path``): the cost in shared memory;
# the cost in global memory with the state in shared memory, or in a
# global workspace
PATHS = ("shared", "large", "large_global")


def _pick_path(lib, n: int) -> str:
    """The path for n: shared memory while the (n+1)^2 cost fits a block,
    else the large path, its state in shared memory while that fits."""
    if n <= lib.shgvqa_hungarian_max_n():
        return "shared"
    if n <= lib.shgvqa_hungarian_large_smem_max_n():
        return "large"
    return "large_global"


def _launch(cost: torch.Tensor, path: str = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on the current stream for cost (P, n, n) f32
    contiguous: (row_to_col (P, n) int64, steps (P,) int32, the search
    steps each problem took).  ``path`` (one of ``PATHS``) is chosen by n
    when None; a path given explicitly must take n (the card check runs
    each)."""
    bsz, n = cost.shape[0], cost.shape[-1]
    lib = _lib()
    with torch.cuda.device(cost.device):
        path = path or _pick_path(lib, n)
        row_to_col = torch.empty(bsz, n, dtype=torch.long, device=cost.device)
        steps = torch.empty(bsz, dtype=torch.int32, device=cost.device)
        args = (cost.data_ptr(), row_to_col.data_ptr(), steps.data_ptr())
        if path == "shared":
            err = lib.shgvqa_hungarian(*args, bsz, n, _stream(cost.device))
        elif path in ("large", "large_global"):
            workspace = None
            if path == "large_global":
                workspace = torch.empty(
                    bsz * lib.shgvqa_hungarian_large_stride(n),
                    dtype=torch.uint8, device=cost.device)
            err = lib.shgvqa_hungarian_large(
                *args, None if workspace is None else workspace.data_ptr(),
                bsz, n, _stream(cost.device))
        else:
            raise ValueError(f"hungarian_square: path {path!r} is not one "
                             f"of {PATHS}")
    if err:
        raise RuntimeError(
            f"hungarian_square kernel launch failed: CUDA error {err} "
            f"({lib.shgvqa_matcher_error_string(err).decode()})")
    hungarian_square.launches += 1
    return row_to_col, steps


def hungarian_square(cost: torch.Tensor) -> torch.Tensor:
    """Exact n x n assignment minimizing the total cost, for every problem
    of a batch: cost (..., n, n) -> row_to_col (..., n) int64.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  ``hungarian_square.launches`` counts its launches."""
    if cost.shape[-1] != cost.shape[-2] or cost.dim() < 2:
        raise ValueError(f"hungarian_square takes (..., n, n) costs, got "
                         f"{tuple(cost.shape)}")
    if cost.device.type == "cpu":
        return hungarian_square_reference(cost)
    if cost.device.type != "cuda":
        raise NotImplementedError(f"hungarian_square has no kernel for "
                                  f"{cost.device}")
    n = cost.shape[-1]
    flat = cost.reshape(-1, n, n).float().contiguous()
    return _launch(flat)[0].reshape(cost.shape[:-1])


hungarian_square.launches = 0


def assign_padded(cost: torch.Tensor, num_valid_cols: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assignment on (..., n_rows, n_cols) costs of which the first
    ``num_valid_cols`` (...) columns are real; the others are padded to the
    constant 0, above any real -softmax cost.  Up to ``DP_MAX_N`` the subset
    DP solves it, above the augmenting-path solver.  Returns (row_to_col
    (..., n_rows), matched (..., n_rows) bool)."""
    n_rows, n_cols = cost.shape[-2:]
    n = max(n_rows, n_cols)
    valid = num_valid_cols[..., None, None]
    cols = torch.arange(n_cols, device=cost.device)
    cost = torch.where(cols < valid, cost, 0.0)
    if n != n_rows or n != n_cols:
        square = cost.new_zeros(cost.shape[:-2] + (n, n))
        square[..., :n_rows, :n_cols] = cost
        cost = square
    solver = hungarian_bitmask_dp if n <= DP_MAX_N else hungarian_square
    row_to_col = solver(cost)[..., :n_rows]
    return row_to_col, row_to_col < num_valid_cols[..., None]


def _class_cost(prob: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """cost[..., i, j] = -prob[..., i, labels[..., j]]: prob (..., Q, C),
    labels (..., K) -> (..., Q, K)."""
    idx = labels[..., None, :].expand(labels.shape[:-1] + (prob.shape[-2],
                                                           labels.shape[-1]))
    return -torch.gather(prob, -1, idx)


def _match_targets(logits, labels, lengths, background_idx):
    """Queries (..., Q, C) matched to the first ``lengths`` (...) of the
    labels (..., K): (target classes (..., Q), matched (..., Q))."""
    with torch.no_grad():
        labels = labels.long()
        prob = torch.softmax(logits.float(), dim=-1)
        row_to_col, matched = assign_padded(_class_cost(prob, labels),
                                            lengths.long())
        gathered = torch.gather(
            labels, -1, row_to_col.clamp(max=labels.shape[-1] - 1))
        return torch.where(matched, gathered, background_idx), matched


def match_targets_per_frame(logits: torch.Tensor, labels: torch.Tensor,
                            lengths: torch.Tensor, background_idx: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame Hungarian matching: logits (B, S, R, C) raw class logits,
    labels (B, S, K) padded target labels, lengths (B, S) valid targets
    per frame.  Returns (target classes (B, S, R) int64, the background
    index where unmatched; matched (B, S, R) bool)."""
    return _match_targets(logits, labels, lengths, background_idx)


def match_targets_global(logits: torch.Tensor, labels: torch.Tensor,
                         lengths: torch.Tensor, background_idx: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-clip Hungarian matching (``loss_hg_per_frame=False``): logits
    (B, Q, C), labels (B, N) padded target labels whose first ``lengths``
    (B,) are real.  Returns (target classes (B, Q) int64, the background
    index where unmatched; matched (B, Q) bool)."""
    return _match_targets(logits, labels, lengths, background_idx)


def compact_labels(labels: torch.Tensor, lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The driver layout's per-situation labels (B, S, K) with lengths
    (B, S) as one (B, S * K) row per clip whose real labels come first, in
    situation order (a stable sort on the device, as the JAX set loss does:
    the reference's matcher concatenates a clip's targets), and the (B,)
    count of real labels."""
    bsz, s, k = labels.shape
    valid = (torch.arange(k, device=labels.device)
             < lengths[:, :, None]).reshape(bsz, s * k)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    flat = torch.gather(labels.reshape(bsz, s * k), -1, order)
    return flat, valid.sum(dim=-1).to(lengths.dtype)

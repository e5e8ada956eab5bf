"""The port's per-frame Hungarian matcher (ops/matcher.py) against the JAX
``match_targets_per_frame``: the same target grid and ``matched`` bit for
bit (ties included), and the same total cost as scipy's
``linear_sum_assignment`` on every problem."""

import itertools

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from shgvqa_tpu.ops import matcher as jax_matcher
from shgvqa_tpu_torch.ops import matcher
from test_torch_common import t


def _problem(seed, b, s, r, c, ties=False):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, s, r, c).astype(np.float32) * 2.0
    labels = rng.randint(1, c, (b, s, r)).astype(np.int32)
    if ties:   # repeated labels give equal cost columns
        labels[..., 1] = labels[..., 0]
        logits[..., :2, :] = logits[..., :1, :]
    lengths = rng.randint(1, r + 1, (b, s)).astype(np.int32)
    return logits, labels, lengths


@pytest.mark.parametrize("r,ties", [(8, False), (8, True), (3, False),
                                    (3, True)])
def test_per_frame_matching_equals_jax_and_scipy(r, ties):
    logits, labels, lengths = _problem(r + ties, 3, 4, r, 20, ties)
    want_t, want_m = jax_matcher.match_targets_per_frame(logits, labels,
                                                         lengths)
    got_t, got_m = matcher.match_targets_per_frame(t(logits), t(labels),
                                                   t(lengths))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))

    # the assignment's total cost equals scipy's optimum on every problem
    prob = torch.softmax(t(logits), -1).numpy()
    cost = -np.take_along_axis(prob, labels[:, :, None, :], axis=-1)
    row_to_col, matched = matcher.assign_padded(t(cost), t(lengths))
    np.testing.assert_array_equal(matched.numpy(), got_m.numpy())
    for bi, si in itertools.product(range(3), range(4)):
        n = lengths[bi, si]
        c = cost[bi, si, :, :n]                                   # (R, n)
        rows, cols = linear_sum_assignment(c)
        ours = sum(c[i, row_to_col[bi, si, i]] for i in range(r)
                   if matched[bi, si, i])
        assert matched[bi, si].sum() == n
        np.testing.assert_allclose(ours, c[rows, cols].sum(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_bitmask_dp_is_optimal_by_enumeration(n):
    rng = np.random.RandomState(n)
    cost = rng.randn(6, n, n).astype(np.float32)
    got = matcher.hungarian_bitmask_dp(t(cost)).numpy()
    for c, perm in zip(cost, got):
        assert sorted(perm) == list(range(n))
        best = min(sum(c[i, p[i]] for i in range(n))
                   for p in itertools.permutations(range(n)))
        np.testing.assert_allclose(sum(c[i, perm[i]] for i in range(n)),
                                   best, rtol=0, atol=1e-6)


def test_problems_beyond_the_dp_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        matcher.assign_padded(torch.zeros(16, 16), torch.tensor(16))

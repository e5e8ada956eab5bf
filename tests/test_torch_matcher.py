"""The port's Hungarian matching (``ops/matcher.py``) against the JAX
package.  Per frame: ``match_targets_per_frame`` bit for bit (ties
included) and the total cost of scipy's ``linear_sum_assignment``.
Globally: the plain ``hungarian_square`` (the plain version of the kernel
``csrc/matcher.cu``) against the JAX ``jax.lax`` solver, row for row, on
random costs and on costs made of ties; its total cost against scipy's;
early exit against the fixed trip counts; the global ``assign_padded``,
``match_targets_global`` and ``hungarian_set_loss`` in the driver layout
against JAX's; the card path through a stand-in C entry, its dispatch
above the shared-memory limit to the large path, and its refusals (no
fallback); a numpy mirror of the large path (the column chunks, the
lanes' scans, the butterfly, the state plan) against the plain solver at
n = 239 and 480."""

import contextlib
import itertools
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from shgvqa_tpu.losses import set_prediction as jax_loss
from shgvqa_tpu.ops import matcher as jax_matcher
from shgvqa_tpu_torch.losses import set_prediction
from shgvqa_tpu_torch.ops import matcher
from test_torch_common import t, tensor_at

# the global mode's loss tolerance
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_square():
    return jax.jit(jax.vmap(jax_matcher.hungarian_square))


def _costs(kind, n, batch, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        # -softmax-like costs in (-1, 0]
        return -rng.rand(batch, n, n).astype(np.float32)
    # ties: few distinct values, exactly representable, so every rounding
    # of a sum agrees and only the tie rules decide
    return (-rng.randint(0, 4, size=(batch, n, n)) / 8.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n", [13, 24, 48])
def test_plain_solver_matches_jax_row_for_row(jax_square, n, kind):
    costs = _costs(kind, n, 3, seed=n)
    want = np.asarray(jax_square(jnp.asarray(costs)))
    got = matcher.hungarian_square(t(costs))
    assert got.dtype == torch.long and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for c, r in zip(costs, got.numpy()):
        assert sorted(r) == list(range(n))
        rows, cols = linear_sum_assignment(c)
        assert abs(c[np.arange(n), r].sum() - c[rows, cols].sum()) <= 1e-5


def test_every_problem_made_of_ties():
    """All costs equal: the first-minimum rules give the identity."""
    got = matcher.hungarian_square(torch.full((2, 16, 16), -0.5))
    assert torch.equal(got, torch.arange(16).expand(2, 16))


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_early_exit_is_the_fixed_trips(kind):
    """The masked tail of the fixed trip counts is a no-op: stopping when
    every problem is done leaves p, u and v bit-equal."""
    costs = t(_costs(kind, 20, 4, seed=3))
    early = matcher._augmenting_path_solve(costs, early_exit=True)
    fixed = matcher._augmenting_path_solve(costs, early_exit=False)
    for a, b in zip(early, fixed):
        assert torch.equal(a, b)
    steps = early[3]
    assert (steps >= 20).all() and (steps < 20 * 21).all()


def test_batched_plain_solver_is_each_problem_alone():
    costs = t(_costs("random", 14, 5, seed=8))
    batched = matcher.hungarian_square_reference(costs.reshape(5, 1, 14, 14))
    for i in range(5):
        assert torch.equal(batched[i, 0],
                           matcher.hungarian_square_reference(costs[i]))


def test_assign_padded_above_the_dp_matches_jax():
    """Rectangular (20, 17) problems with 0-17 real columns: the square
    solver's side of ``assign_padded``."""
    rng = np.random.RandomState(4)
    cost = -rng.rand(4, 20, 17).astype(np.float32)
    valid = np.array([17, 9, 0, 3], np.int32)
    want = jax.vmap(jax_matcher.assign_padded)(jnp.asarray(cost),
                                               jnp.asarray(valid))
    got = matcher.assign_padded(t(cost), t(valid).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _driver_labels(rng, b, s, k, classes):
    lengths = rng.randint(0, k + 1, size=(b, s)).astype(np.int32)
    lengths[0] = 0                                  # a clip with no target
    labels = rng.randint(1, classes, size=(b, s, k)).astype(np.int32)
    labels[np.arange(k)[None, None] >= lengths[..., None]] = 0
    return labels, lengths


@pytest.mark.parametrize("s,r,classes", [(4, 4, 12), (4, 2, 8), (3, 8, 30)],
                         ids=["q16", "q8-dp", "q24"])
def test_global_targets_and_loss_match_jax(s, r, classes):
    """The driver layout: (B, S, K) labels compacted on the device, the
    whole clip matched (the subset DP at Q <= 12, the square solver above),
    against ``match_targets_global`` and ``hungarian_set_loss`` of JAX."""
    rng = np.random.RandomState(s * r)
    b, q = 3, s * r
    logits = rng.randn(b, q, classes + 1).astype(np.float32) * 2.0
    labels, lengths = _driver_labels(rng, b, s, r, classes + 1)
    weights = jax_loss.empty_weight(classes + 1, 0.1)
    want = jax_loss.hungarian_set_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lengths),
        weights, per_frame=False, num_situations=s)
    got = set_prediction.hungarian_set_loss(
        t(logits), t(labels), t(lengths),
        set_prediction.empty_weight(classes + 1, 0.1), per_frame=False,
        num_situations=s)
    for key in ("loss_ce", "class_error"):
        assert abs(float(got[key]) - float(want[key])) <= TOL * max(
            1.0, abs(float(want[key]))), key

    flat, n_valid = matcher.compact_labels(t(labels).long(), t(lengths))
    jflat = np.zeros_like(labels.reshape(b, -1))
    for i in range(b):
        real = [x for row, n in zip(labels[i], lengths[i]) for x in row[:n]]
        jflat[i, :len(real)] = real
        assert int(n_valid[i]) == len(real)
        assert flat[i, :len(real)].tolist() == real
    jt, jm = jax_matcher.match_targets_global(
        jnp.asarray(logits), jnp.asarray(jflat),
        jnp.asarray(n_valid.numpy()))
    gt, gm = matcher.match_targets_global(t(logits), flat, n_valid)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))
    assert not gm[0].any()


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
    """Beyond ``DP_MAX_N`` the square solver takes the problem: on the CPU
    its plain version (the JAX solver's rows), on a device without the
    kernel an error, never a fallback."""
    cost = -torch.rand(16, 16, generator=torch.Generator().manual_seed(0))
    rows, matched = matcher.assign_padded(cost, torch.tensor(16))
    want = jax_matcher.assign_padded(jnp.asarray(cost.numpy()), 16)[0]
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
    assert matched.all()
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        matcher.assign_padded(torch.zeros(16, 16, device="meta"),
                              torch.tensor(16, device="meta"))


# -- the card path ------------------------------------------------------------

@contextlib.contextmanager
def _stand_in(monkeypatch, entry, max_n=238, large=None, large_max_n=9641):
    monkeypatch.setattr(matcher, "_lib", lambda: SimpleNamespace(
        shgvqa_hungarian=entry, shgvqa_hungarian_max_n=lambda: max_n,
        shgvqa_hungarian_large=large,
        shgvqa_hungarian_large_smem_max_n=lambda: large_max_n,
        shgvqa_hungarian_large_stride=lambda n: (24 * (n + 1) + 255)
        // 256 * 256,
        shgvqa_matcher_error_string=lambda err: b"stand-in error"))
    monkeypatch.setattr(matcher, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    yield


def test_card_path_with_a_stand_in_entry(monkeypatch):
    """``_launch`` on CPU tensors with the C entry replaced by the plain
    solver: the entry gets (P, n, n) f32 and writes row_to_col and the
    steps, which the wrapper returns; launches count the calls."""
    costs = t(_costs("random", 30, 4, seed=2))
    calls = []

    def entry(pc, pr, ps, bsz, n, stream):
        c = tensor_at(pc, (bsz, n, n), torch.float32).clone()
        p, _, _, steps = matcher._augmenting_path_solve(c)
        tensor_at(pr, (bsz, n), torch.long).copy_(matcher._row_to_col(p))
        tensor_at(ps, (bsz,), torch.int32).copy_(steps)
        calls.append((bsz, n))
        return 0

    before = matcher.hungarian_square.launches
    with _stand_in(monkeypatch, entry):
        got, steps = matcher._launch(costs)
    assert calls == [(4, 30)]
    assert torch.equal(got, matcher.hungarian_square_reference(costs))
    assert steps.dtype == torch.int32 and (steps >= 30).all()
    assert matcher.hungarian_square.launches == before + 1


def test_card_path_dispatches_above_the_shared_memory_limit(monkeypatch):
    """Above ``shgvqa_hungarian_max_n()`` the wrapper never raises for
    size: it calls the large entry, its state in shared memory (no
    workspace) up to ``shgvqa_hungarian_large_smem_max_n()``, above it in a
    workspace of ``stride(n)`` bytes a problem; each entry gets (P, n, n)
    f32 and writes row_to_col and the steps, a launch counted each."""
    costs = t(_costs("random", 30, 3, seed=4))
    calls = []

    def small(*args):
        calls.append("shared")
        return 0

    def large(pc, pr, ps, pw, bsz, n, stream):
        calls.append(("large", pw is None, bsz, n))
        c = tensor_at(pc, (bsz, n, n), torch.float32).clone()
        p, _, _, steps = matcher._augmenting_path_solve(c)
        tensor_at(pr, (bsz, n), torch.long).copy_(matcher._row_to_col(p))
        tensor_at(ps, (bsz,), torch.int32).copy_(steps)
        if pw is not None:
            stride = (24 * (n + 1) + 255) // 256 * 256
            tensor_at(pw, (bsz * stride,), torch.uint8).fill_(7)
        return 0

    before = matcher.hungarian_square.launches
    want = matcher.hungarian_square_reference(costs)
    for max_n, large_max_n, expect in ((29, 9641, ("large", True, 3, 30)),
                                       (29, 29, ("large", False, 3, 30)),
                                       (30, 29, "shared")):
        calls.clear()
        with _stand_in(monkeypatch, small, max_n=max_n, large=large,
                       large_max_n=large_max_n):
            got, steps = matcher._launch(costs)
        assert calls == [expect]
        if expect != "shared":
            assert torch.equal(got, want) and (steps >= 30).all()
    assert matcher.hungarian_square.launches == before + 3
    with _stand_in(monkeypatch, small, max_n=238, large=large):
        calls.clear()
        matcher._launch(costs, path="large_global")
        matcher._launch(costs, path="shared")
    assert calls == [("large", False, 3, 30), "shared"]


def test_card_path_raises_and_never_falls_back(monkeypatch):
    costs = t(_costs("random", 30, 2, seed=1))
    with _stand_in(monkeypatch, lambda *args: 98):
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            matcher._launch(costs)
    with _stand_in(monkeypatch, lambda *args: 0):
        with pytest.raises(ValueError, match="path 'global'"):
            matcher._launch(costs, path="global")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(matcher, "_lib", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        matcher._launch(costs)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        matcher.hungarian_square(torch.empty(2, 30, 30, device="meta"))


# -- mirrors of csrc/matcher.cu ------------------------------------------------

_CU = open(os.path.join(os.path.dirname(matcher.__file__), "..", "csrc",
                        "matcher.cu")).read()


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


WARP = _cu_constant("kWarp")
MAX_SLOTS = _cu_constant("kMaxSlots")
MAX_WARPS = _cu_constant("kMaxWarps")
STATE_WORDS = _cu_constant("kStateWords")
CANDIDATE_BYTES = 2 * MAX_WARPS * 4 * 4          # kCandidateBytes
KINF = np.float32(1e9)
F32_INF = np.float32(np.inf)
# an H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_OPTIN = 232448


def order_key(x):
    """csrc/matcher.cu order_key: -0.0 + 0.0 = +0.0, then the sign-flipped
    bits: a < b exactly when key(a) < key(b)."""
    bits = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(
        np.uint32)


def key_value(k):
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(
        np.uint32).view(np.float32)


def test_argmin_key_orders_like_the_float_compare():
    """The key keeps the order of < (so the first minimum of the keys is the
    first minimum of the values), maps -0.0 and +0.0 to one key, keeps
    INF = 1e9 under the +inf of a lane without columns, and reads back the
    value (a -0.0 minimum as +0.0)."""
    rng = np.random.RandomState(0)
    vals = np.concatenate([
        rng.randn(2000).astype(np.float32) * 10 ** rng.uniform(-30, 30, 2000),
        np.float32([0.0, -0.0, KINF, -KINF, F32_INF, -F32_INF, 1e-45,
                    -1e-45, 3.4e38, -3.4e38, 0.5, 0.5])]).astype(np.float32)
    a, b = np.meshgrid(vals, vals)
    np.testing.assert_array_equal(order_key(a) < order_key(b), a < b)
    np.testing.assert_array_equal(order_key(a) == order_key(b), a == b)
    assert order_key(np.float32(-0.0)) == order_key(np.float32(0.0))
    assert order_key(KINF) < order_key(F32_INF)
    back = key_value(order_key(vals))
    np.testing.assert_array_equal(back.view(np.uint32), np.where(
        vals == 0, np.float32(0.0), vals).view(np.uint32))


def shared_path_mirror(cost):
    """The shared path on one (n, n) f32 problem as the warp runs it, with
    numpy arrays [lane, slot] for the registers: column j in lane j % 32 as
    its slot j // 32, each column's v, minv, used, p[j] and u[p[j]] held by
    its lane; a step branch-free over the slots; each lane's first minimum
    over its slots (a strict <), then the two reductions (the least key,
    the least column among the lanes that hold it) and delta read back from
    the key; the used columns' rows' u moved in the registers and written
    back to u (by row) when the row's search ends, then the path walk on p
    and way.  Returns (row_to_col, steps, u by row, v by column)."""
    n = cost.shape[0]
    m = n + 1
    slots = -(-m // WARP)
    assert slots <= MAX_SLOTS
    f32 = np.float32
    cx = np.zeros((m, m), f32)
    cx[1:, 1:] = cost
    u = np.zeros(m, f32)
    p = np.zeros(m, np.int64)
    way = np.zeros(m, np.int64)
    cols = np.arange(WARP)[:, None] + WARP * np.arange(slots)[None, :]
    live = cols < m
    safe = np.minimum(cols, m - 1)
    v = np.zeros((WARP, slots), f32)
    lanes = np.arange(WARP)
    steps = 0
    for i in range(1, m):
        pj = np.where(cols == 0, i, np.where(live, p[safe], 0))
        up = u[pj]
        minv = np.full((WARP, slots), KINF, f32)
        used = np.zeros((WARP, slots), bool)
        j0, i0, ui0 = 0, i, u[i]
        for _ in range(m):
            used |= cols == j0
            cij = np.where(live, cx[i0, safe], f32(0))
            cur = (cij - ui0).astype(f32) - v
            better = live & ~used & (cur < minv)
            minv = np.where(better, cur, minv)
            way[cols[better]] = j0
            masked = np.where(~live, F32_INF,
                              np.where(used | (cols == 0), KINF, minv))
            k = np.argmin(masked, axis=1)            # each lane's first minimum
            best = masked[lanes, k]
            best_j = np.where(best == F32_INF, m, cols[lanes, k])
            key = order_key(best)
            kmin = key.min()
            j1 = int(np.where(key == kmin, best_j, np.iinfo(np.int32).max)
                     .min())
            delta = key_value(kmin)
            up = np.where(used, (up + delta).astype(f32), up)
            v = np.where(used, (v - delta).astype(f32), v)
            minv = np.where(used, minv, (minv - delta).astype(f32))
            j0 = j1
            steps += 1
            i0, ui0 = int(pj[j0 % WARP, j0 // WARP]), up[j0 % WARP, j0 // WARP]
            if i0 == 0:
                break
        u[pj[used]] = up[used]                       # the deferred write-back
        p[0] = i
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.zeros(n, np.int64)
    row_to_col[p[1:] - 1] = np.arange(n)
    v_col = np.zeros(m, f32)
    v_col[cols[live]] = v[live]
    return row_to_col, steps, u, v_col


def _zero_targets(n, batch):
    """Clips without targets: every column padded to the constant 0."""
    return np.zeros((batch, n, n), np.float32)


@pytest.mark.parametrize("n,kind", [(48, "random"), (48, "ties"),
                                    (48, "zero"), (128, "random"),
                                    (128, "ties"), (128, "zero"),
                                    (238, "random"), (238, "ties"),
                                    (100, "zero")])
def test_shared_path_mirror_is_the_plain_solver_step_for_step(n, kind):
    """The register-state search (column state in the lanes' registers, u
    written back when a row's search ends, the two-reduction argmin) gives
    the plain solver's rows, search steps and potentials bit for bit (the
    u of every row, the v of every column; a zero's sign aside), at the
    relations' n = 128, the actions' 48 and the path's limit 238, on random,
    tie-heavy and zero-target costs (those take n (n + 1) / 2 steps, so the
    largest is 100)."""
    cost = (_zero_targets(n, 1) if kind == "zero"
            else _costs(kind, n, 1, seed=n))[0]
    got, steps, u, v = shared_path_mirror(cost)
    p, want_u, want_v, want_steps = matcher._augmenting_path_solve(
        t(cost)[None])
    np.testing.assert_array_equal(got, matcher._row_to_col(p)[0].numpy())
    assert steps == int(want_steps[0])
    np.testing.assert_array_equal(u, want_u[0].numpy())
    np.testing.assert_array_equal(v, want_v[0].numpy())
    if kind == "zero":
        assert steps == n * (n + 1) // 2


def large_path_plan(n, optin=H100_OPTIN):
    """The wrapper's choice and the large path's state block for n: 'shared'
    while the (n+1)^2 cost, u, p and way fit, else 'large' with the
    kStateWords x 4 bytes a column in shared memory beside the warps'
    candidates, else 'large_global' with a workspace of the state rounded
    up to 256 bytes a problem; and the block's warps."""
    m = n + 1
    warps = min(MAX_WARPS, -(-m // WARP))
    if 4 * m * (m + 1) + 8 * m <= optin and m <= WARP * MAX_SLOTS:
        return "shared", 0, 1
    state = 4 * STATE_WORDS * m
    if CANDIDATE_BYTES + state <= optin:
        return "large", state, warps
    return "large_global", (state + 255) // 256 * 256, warps


def large_path_mirror(cost):
    """The large path on one (n, n) f32 problem as the block runs it: W =
    min(32, ceil((n + 1) / 32)) warps, thread t owning the run of columns
    t * per .. t * per + per - 1 (lane order is column order); each
    thread's first minimum over its run (strict <) and its column's p and
    u; each warp's first lane with the least key; then the warps' (key,
    column, p, u) reduced the same way.  Returns (row_to_col, steps)."""
    n = cost.shape[0]
    m = n + 1
    warps = min(MAX_WARPS, -(-m // WARP))
    threads = warps * WARP
    per = -(-m // threads)
    f32 = np.float32
    u = np.zeros(m, f32)
    v = np.zeros(m, f32)
    p = np.zeros(m, np.int64)
    way = np.zeros(m, np.int64)
    cols = np.arange(threads * per).reshape(threads, per)
    live = cols < m
    safe = np.minimum(cols, m - 1)
    steps = 0
    for i in range(1, m):
        minv = np.full(m, KINF, f32)
        used = np.arange(m) == 0
        p[0] = i
        j0, i0, ui0 = 0, i, u[i]
        for _ in range(m):
            row = np.concatenate([[f32(0)], cost[i0 - 1]]).astype(f32)
            cur = (row - ui0).astype(f32) - v
            better = ~used & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            masked = np.where(used | (np.arange(m) == 0), KINF, minv)
            run = np.where(live, masked[safe], F32_INF)        # [thread, per]
            k = np.argmin(run, axis=1)
            best = run[np.arange(threads), k]
            best_j = np.where(best == F32_INF, m, cols[np.arange(threads), k])
            pc = np.where(best_j < m, p[np.minimum(best_j, m - 1)], 0)
            uc = u[pc]
            key = order_key(best).reshape(warps, WARP)
            kw = key.min(axis=1)
            win = np.argmax(key == kw[:, None], axis=1)        # the first lane
            flat = np.arange(warps) * WARP + win
            jw, pw, uw = best_j[flat], pc[flat], uc[flat]
            kmin = kw.min()
            w = int(np.argmax(kw == kmin))                       # the first warp
            j1, i0, ui0 = int(jw[w]), int(pw[w]), uw[w]
            delta = key_value(kmin)
            rows = p[used]
            u[rows] = (u[rows] + delta).astype(f32)
            v = np.where(used, (v - delta).astype(f32), v)
            minv = np.where(used, minv, (minv - delta).astype(f32))
            j0 = j1
            steps += 1
            if i0 == 0:
                break
            used[j0] = True
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.zeros(n, np.int64)
    row_to_col[p[1:] - 1] = np.arange(n)
    return row_to_col, steps


@pytest.mark.parametrize("n,kind", [(239, "random"), (480, "random"),
                                    (239, "ties")])
def test_large_path_mirror_is_the_plain_solver(n, kind):
    """Above the shared-memory path's limit the mirror of the multi-warp
    large path gives the plain solver's rows and search steps bit for bit,
    and its total cost is scipy's (1e-5 relative); the wrapper's plan: the
    shared path to 238, the state in shared memory beside the warps'
    candidates to 9,641, a workspace above."""
    assert large_path_plan(238)[0] == "shared"
    assert large_path_plan(n) == ("large", 4 * STATE_WORDS * (n + 1),
                                  min(32, -(-(n + 1) // 32)))
    assert large_path_plan(9641)[0] == "large"
    assert large_path_plan(9642) == ("large_global",
                                     (24 * 9643 + 255) // 256 * 256, 32)
    cost = _costs(kind, n, 1, seed=n)[0]
    got, steps = large_path_mirror(cost)
    p, _, _, want_steps = matcher._augmenting_path_solve(t(cost)[None])
    np.testing.assert_array_equal(got, matcher._row_to_col(p)[0].numpy())
    assert steps == int(want_steps[0])
    r, c = linear_sum_assignment(cost)
    total = cost[np.arange(n), got].sum(dtype=np.float64)
    assert abs(total - cost[r, c].sum(dtype=np.float64)) <= 1e-5 * abs(total)

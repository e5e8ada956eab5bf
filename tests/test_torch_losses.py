"""The port's losses (losses/) against the JAX package's: the per-frame
Hungarian set loss and class error, the answer BCE, the weighted cross
entropy's torch weighted-mean semantics and the background weight."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shgvqa_tpu.losses import set_prediction as jax_set
from shgvqa_tpu.losses import vqa as jax_vqa
from shgvqa_tpu_torch.losses import (
    bce_vqa_loss,
    empty_weight,
    hungarian_set_loss,
    matched_top1_accuracy,
    weighted_cross_entropy,
)
from test_torch_common import close, t

TOL = 1e-5


@pytest.mark.parametrize("slots,classes", [(8, 457), (3, 158), (3, 8)])
def test_hungarian_set_loss_matches_jax(slots, classes):
    rng = np.random.RandomState(slots + classes)
    b, s = 3, 16
    logits = rng.randn(b, s * slots, classes).astype(np.float32)
    labels = rng.randint(1, classes, (b, s, slots)).astype(np.int32)
    lengths = rng.randint(1, slots + 1, (b, s)).astype(np.int32)
    w = jax_set.empty_weight(classes, 0.1)
    want = jax_set.hungarian_set_loss(logits, labels, lengths, w,
                                      per_frame=True, num_situations=s)
    got = hungarian_set_loss(t(logits), t(labels), t(lengths),
                             empty_weight(classes, 0.1), per_frame=True,
                             num_situations=s)
    assert set(got) == {"loss_ce", "class_error"}
    for key in got:
        close(got[key], want[key], TOL)


def test_global_matching_mode_raises():
    """The global mode runs on the CPU (its plain solver; the JAX loss in
    tests/test_torch_matcher.py); on a device without the matcher's kernel
    it raises rather than fall back."""
    got = hungarian_set_loss(torch.zeros(1, 16, 5), torch.ones(1, 2, 8).int(),
                             torch.ones(1, 2).int(), empty_weight(5, 0.1),
                             per_frame=False, num_situations=2)
    # zero logits predict the background, 0; every matched target is 1
    assert torch.isfinite(got["loss_ce"]) and got["class_error"] == 100.0
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        hungarian_set_loss(torch.zeros(1, 16, 5, device="meta"),
                           torch.ones(1, 2, 8, device="meta").int(),
                           torch.ones(1, 2, device="meta").int(),
                           empty_weight(5, 0.1, device="meta"),
                           per_frame=False, num_situations=2)


def test_bce_vqa_loss_matches_jax_and_torch():
    rng = np.random.RandomState(0)
    logits = (rng.randn(4, 171) * 4).astype(np.float32)
    target = np.eye(171, dtype=np.float32)[rng.randint(171, size=4)]
    got = bce_vqa_loss(t(logits), t(target))
    close(got, jax_vqa.bce_vqa_loss(jnp.asarray(logits), target), TOL)
    close(got, F.binary_cross_entropy_with_logits(t(logits), t(target))
          * 171, TOL)


def test_weighted_cross_entropy_is_torch_weighted_mean():
    rng = np.random.RandomState(1)
    logits = rng.randn(5, 7, 11).astype(np.float32)
    targets = rng.randint(0, 11, (5, 7))
    w = empty_weight(11, 0.1)
    assert w[0] == pytest.approx(0.1) and bool((w[1:] == 1).all())
    got = weighted_cross_entropy(t(logits), t(targets), w)
    close(got, F.cross_entropy(t(logits).reshape(-1, 11),
                               t(targets).reshape(-1), weight=w), TOL)
    close(got, jax_set.weighted_cross_entropy(
        logits, targets, jax_set.empty_weight(11, 0.1)), TOL)


def test_matched_top1_accuracy_over_matched_slots_only():
    logits = torch.tensor([[[0.0, 1.0], [1.0, 0.0], [1.0, 0.0]]])
    targets = torch.tensor([[1, 1, 0]])
    matched = torch.tensor([[True, True, False]])
    assert matched_top1_accuracy(logits, targets, matched).item() == 50.0
    assert matched_top1_accuracy(logits, targets,
                                 torch.zeros_like(matched)).item() == 0.0

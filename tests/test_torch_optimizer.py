"""The port's BertAdam (train/optimizer.py) against the JAX
``make_optimizer``: global-norm clip + BertAdam with a trainable mask over
three steps, with the clip both idle and active; the first update's lr of
0; masked parameters untouched (no weight decay); the three schedules; an
unknown ``--optim`` name refused.  The stock optimizers are held to the
JAX ones in ``tests/test_torch_weights_import.py``."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shgvqa_tpu.train import optimizer as jax_opt
from shgvqa_tpu_torch.train import optimizer
from test_torch_common import close, t

SHAPES = {"a": (3, 4), "b": (5,), "frozen": (2, 2)}
MASK = {"a": True, "b": True, "frozen": False}


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for name, value in values.items():
            setattr(self, name, torch.nn.Parameter(t(value)))


def test_bert_adam_with_clip_and_mask_matches_jax_over_three_steps():
    rng = np.random.RandomState(0)
    values = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    # global norms ~1 (clip idle), ~40 (clip active), ~3
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for scale in (0.3, 10.0, 0.8)]
    kw = dict(lr=1e-2, t_total=10, warmup=0.1, schedule="warmup_linear",
              weight_decay=0.01, grad_clip=5.0)
    tx = jax_opt.make_optimizer(trainable_mask=MASK, **kw)
    jparams = {k: jnp.asarray(v) for k, v in values.items()}
    state = tx.init(jparams)
    model = _Params(values)
    opt = optimizer.make_optimizer(model, trainable_mask=MASK, **kw)
    assert len(opt.params) == 2
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in model.named_parameters():
            p.grad = t(g[name])
        norm = opt.step()
        want_norm = np.sqrt(sum((g[k] ** 2).sum() for k in ("a", "b")))
        close(norm, want_norm, 1e-5)
        for name, p in model.named_parameters():
            close(p, jparams[name], 1e-6)
            if i == 0 or name == "frozen":   # lr 0 first; frozen: no decay
                np.testing.assert_array_equal(p.detach().numpy(),
                                              values[name])
    assert opt.step_count == 3
    assert opt.lr_at(0) == 0.0


@pytest.mark.parametrize("name", sorted(optimizer.SCHEDULES))
def test_schedules_match_jax(name):
    for x in (0.0, 0.05, 0.1, 0.3, 0.99, 1.0, 1.3):
        want = float(jax_opt.SCHEDULES[name](jnp.float32(x), 0.1))
        assert optimizer.SCHEDULES[name](x, 0.1) == pytest.approx(
            want, rel=1e-6, abs=1e-7)


def test_other_optimizers_raise():
    """A name that is neither BertAdam's nor one of the reference's stock
    optimizers raises, as the JAX ``plain_optimizer`` does."""
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        optimizer.make_optimizer(_Params({"a": np.zeros(2, np.float32)}),
                                 1e-3, 10, name="adagrad")
    with pytest.raises(ValueError, match="unknown optimizer"):
        jax_opt.make_optimizer(1e-3, 10, name="adagrad")

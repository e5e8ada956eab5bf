"""The port's LXMERT pretraining (models/pretrain.py, cli/pretrain.py's
batches, losses and step) against the JAX package at tiny_test_config
size in f32.

- the losses within 1e-5, the masking utilities, ``AnswerTable`` and
  ``answer_head_surgery`` exactly;
- ``LxmertPretrainModel``'s outputs and every parameter's gradient of the
  five losses on carried (perturbed) weights within 1e-4, the tied
  decoder giving the embedding's row 0 JAX's gradient;
- ``make_batch`` bit-equal to the JAX driver's batch rebuilt from JAX's
  pieces on one seed;
- three pretraining steps (BertAdam, warmup 0.1, every parameter) against
  JAX's model, losses and ``make_optimizer``, every dropout rate 0, by
  ``test_torch_train_step``'s rule.

One JAX init and one jitted JAX loss-and-gradient are shared by the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data import featurize as jax_featurize
from shgvqa_tpu.models import pretrain as jax_pretrain
from shgvqa_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from shgvqa_tpu_torch.cli import pretrain as driver
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.models import pretrain
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from test_torch_common import close, load_port, perturb, t
from test_torch_train_step import NOISE, UPDATE_TOL

NUM_ANSWERS, BSZ, STEPS, LR, T_TOTAL = 5, 4, 3, 1e-3, 10
ALL_TASKS = dict(task_mask_lm=True, task_matched=True, task_qa=True,
                 task_contrastive=True, task_obj_predict=True,
                 visual_losses="obj,attr,feat", word_mask_rate=0.15,
                 obj_mask_rate=0.15)
INPUTS = driver.MODEL_INPUTS


def _no_dropout(cfg):
    return cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=0.0, attention_dropout=0.0))


def _items(cfg, n=10, seed=3):
    """``PretrainItems`` of random encodings (half the rows padded) and
    features, answers -1 for one item."""
    rng = np.random.RandomState(seed)
    e, lt = cfg.encoder, cfg.data.max_seq_length
    ids = rng.randint(1, e.vocab_size, (n, lt)).astype(np.int32)
    mask = np.ones((n, lt), np.int32)
    mask[::2, lt // 2:] = 0
    ids[mask == 0] = 0
    feats = rng.randn(n, e.visual_t + 8, e.visual_hw, e.visual_hw,
                      e.visual_feat_dim).astype(np.float32)
    answers = rng.randint(NUM_ANSWERS, size=n).astype(np.int32)
    answers[1] = -1
    return driver.PretrainItems(
        enc={"input_ids": ids, "input_mask": mask,
             "segment_ids": np.zeros_like(ids)},
        answers=answers, feats=lambda i: feats[i], mask_id=3,
        vocab_size=e.vocab_size, visual_t=e.visual_t)


def _jax_make_batch(idx, rng, data, pt):
    """The JAX driver's ``make_batch`` (a closure of its ``main``) rebuilt
    from JAX's pieces, line for line."""
    enc = data.enc
    ids = enc["input_ids"][idx].copy()
    im = enc["input_mask"][idx].copy()
    seg = enc["segment_ids"][idx].copy()
    feats = np.stack([data.feats(int(i)) for i in idx])
    is_matched = np.ones((len(idx),), np.int32)
    if pt["task_matched"]:
        swap = rng.rand(len(idx)) < 0.5
        perm = rng.permutation(len(idx))
        for r in np.where(swap)[0]:
            o = perm[r]
            if int(idx[o]) != int(idx[r]):
                ids[r], im[r], seg[r] = (enc["input_ids"][idx[o]],
                                         enc["input_mask"][idx[o]],
                                         enc["segment_ids"][idx[o]])
                is_matched[r] = 0
    lm_labels = np.full_like(ids, -1)
    if pt["task_mask_lm"]:
        ids, lm_labels = jax_pretrain.mask_words(
            ids, im, mask_token_id=data.mask_id, vocab_size=data.vocab_size,
            rate=pt["word_mask_rate"], rng=rng)
    feat_mask = np.zeros(feats.shape[:-1], np.float32)
    feats_in = feats
    if pt["task_obj_predict"]:
        feats_in, feat_mask = jax_pretrain.mask_visual_feats(
            feats, rate=pt["obj_mask_rate"], rng=rng)
    sub = jax_featurize.uniform_subsample_indices(feats.shape[1],
                                                  data.visual_t)
    return {
        "input_ids": ids.astype(np.int32),
        "input_mask": im.astype(np.int32),
        "segment_ids": seg.astype(np.int32),
        "visual_feats": feats_in,
        "visual_target": feats[:, sub].reshape(len(idx), -1,
                                               feats.shape[-1]),
        "feat_mask": feat_mask[:, sub].reshape(len(idx), -1),
        "lm_labels": lm_labels.astype(np.int32),
        "is_matched": is_matched,
        "qa_labels": data.answers[idx],
    }


def _jax_losses(out, batch, pt):
    """The JAX driver's ``loss_fn`` body on the model's outputs."""
    metrics = {}
    total = jnp.float32(0.0)
    if pt["task_mask_lm"]:
        lm = jax_pretrain.masked_lm_loss(out["lm_logits"], batch["lm_labels"])
        total, metrics["lm_loss"] = total + lm, lm
    if pt["task_matched"]:
        ml = jax_pretrain.matched_loss(out["matched_logits"],
                                       batch["is_matched"])
        total, metrics["matched_loss"] = total + ml, ml
    if pt["task_qa"]:
        logp = jax.nn.log_softmax(out["qa_logits"].astype(jnp.float32), -1)
        valid = (batch["is_matched"] > 0) & (batch["qa_labels"] >= 0)
        nll = -jnp.take_along_axis(
            logp, jnp.maximum(batch["qa_labels"], 0)[:, None], 1)[:, 0]
        qa = jnp.sum(jnp.where(valid, nll, 0.0)) / jnp.maximum(
            jnp.sum(valid), 1)
        total, metrics["qa_loss"] = total + qa, qa
    if pt["task_contrastive"]:
        cl = jax_pretrain.cosine_contrastive_loss(
            out["lang_cls"], out["pooled"], batch["is_matched"] * 2 - 1)
        total, metrics["contrastive_loss"] = total + cl, cl
    if pt["task_obj_predict"] and "feat" in pt["visual_losses"]:
        vf = jax_pretrain.visual_feat_loss(
            out["visn_pred"], batch["visual_target"], batch["feat_mask"])
        total, metrics["visn_loss"] = total + vf, vf
    metrics["total_loss"] = total
    return total, metrics


def _batches(cfg, n=STEPS + 1):
    data, rng = _items(cfg), np.random.RandomState(7)
    return [driver.make_batch(rng.permutation(10)[:BSZ], rng, data,
                              ALL_TASKS) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_pre():
    """The JAX model's perturbed init, its outputs, loss and gradients on
    the first batch, and three BertAdam steps on the next three."""
    cfg = _no_dropout(jax_tiny())
    batches = _batches(cfg)
    model = jax_pretrain.LxmertPretrainModel(cfg, num_answers=NUM_ANSWERS)
    e = cfg.encoder
    inputs = {k: batches[0][k] for k in INPUTS}
    init = jax.jit(lambda r, b: model.init(
        r, b, jnp.zeros((e.vocab_size, e.hidden_size), jnp.float32),
        deterministic=True))
    variables = jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(init(jax.random.PRNGKey(0), inputs)),
        np.random.RandomState(1)))

    def loss_fn(params, batch):
        table = params["params"]["lxrt"]["embeddings"]["word_embeddings"][
            "embedding"]
        out = model.apply(params, {k: batch[k] for k in INPUTS}, table,
                          deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        total, metrics = _jax_losses(out, batch, ALL_TASKS)
        return total, (metrics, out)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (metrics0, out0)), grads0 = vg(variables, batches[0])
    tx = jax_make_optimizer(lr=LR, t_total=T_TOTAL, warmup=0.1, flat=False)
    update = jax.jit(tx.update)
    params, opt_state, steps = variables, tx.init(variables), []
    for batch in batches[1:]:
        (_, (m, _)), g = vg(params, batch)
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(jax.device_get(m))
    return dict(cfg=cfg, batches=batches, variables=variables,
                out=jax.device_get(out0), metrics=jax.device_get(metrics0),
                grads=jax.device_get(grads0), steps=steps,
                params=jax.device_get(params))


def _port_model(jax_pre):
    cfg = _no_dropout(tiny_test_config())
    model = load_port(pretrain.LxmertPretrainModel(cfg, NUM_ANSWERS),
                      jax_pre["variables"])
    return cfg, model


def _tensors(batch):
    return {k: t(v) for k, v in batch.items()}


def test_outputs_and_gradients_match_jax(jax_pre):
    _, model = _port_model(jax_pre)
    model.train()
    batch = _tensors(jax_pre["batches"][0])
    out = model({k: batch[k] for k in INPUTS}, torch.Generator())
    for key in ("lm_logits", "matched_logits", "qa_logits", "visn_pred",
                "pooled", "lang_cls"):
        assert out[key].dtype == torch.float32, key
        close(out[key], jax_pre["out"][key], 1e-4)
    total, metrics = driver.pretrain_losses(ALL_TASKS, out, batch)
    assert set(metrics) == set(jax_pre["metrics"])
    for key, want in jax_pre["metrics"].items():
        close(metrics[key], want, 1e-4)
    total.backward()
    want = from_jax_variables(jax_pre["grads"])
    for name, p in model.named_parameters():
        scale = max(want[name].abs().max().item(), 1.0)
        close(p.grad / scale, want[name] / scale, 1e-4)
    # the tied decoder reaches the embedding's row 0, which the lookup
    # freezes: JAX gives it a gradient, and so does the port
    row0 = want["lxrt.embeddings.word_embeddings.weight"][0]
    assert row0.abs().max() > 0


def test_three_steps_match_jax(jax_pre):
    _, model = _port_model(jax_pre)
    model.train()
    opt = make_optimizer(model, LR, T_TOTAL, warmup=0.1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = driver.make_pretrain_step(model, opt, ALL_TASKS)
    g = torch.Generator().manual_seed(0)
    for batch, want in zip(jax_pre["batches"][1:], jax_pre["steps"]):
        got = step(_tensors(batch), g)
        assert set(got) == set(want)
        for key in want:
            close(got[key], want[key], 1e-4)
    want_params = from_jax_variables(jax_pre["params"])
    rms_m = torch.cat([m.flatten() for m in opt.m]).square().mean().sqrt()
    max_move = sum(opt.lr_at(i) for i in range(STEPS)) * 0.1 / 0.999 ** 0.5 \
        * STEPS ** 0.5
    moments = dict(zip(map(id, opt.params), opt.m))
    for name, p in model.named_parameters():
        d_port = p.detach() - before[name]
        d_jax = want_params[name] - before[name]
        noise = moments[id(p)].abs() < NOISE * rms_m
        err = (d_port - d_jax)[~noise].norm().item()
        assert err <= UPDATE_TOL * d_jax[~noise].norm().item() + 1e-12, \
            (name, err)
        assert ((d_port - d_jax)[noise].abs() <= 2 * max_move).all(), name


def test_make_batch_is_bit_equal_to_jax_pieces():
    cfg = tiny_test_config()
    data = _items(cfg)
    for pt in (ALL_TASKS, dict(ALL_TASKS, task_matched=False,
                               task_obj_predict=False)):
        ra, rb = np.random.RandomState(11), np.random.RandomState(11)
        for _ in range(3):
            idx = ra.permutation(10)[:BSZ]
            assert (rb.permutation(10)[:BSZ] == idx).all()
            got = driver.make_batch(idx, ra, data, pt)
            want = _jax_make_batch(idx, rb, data, pt)
            assert got.keys() == want.keys()
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], key)
        assert ra.rand() == rb.rand()


@pytest.mark.parametrize("kind", ["lm", "matched", "contrastive", "visual"])
def test_losses_match_jax(kind):
    rng = np.random.RandomState(5)
    if kind == "lm":
        logits = rng.randn(3, 6, 11).astype(np.float32)
        labels = np.where(rng.rand(3, 6) < 0.4,
                          rng.randint(11, size=(3, 6)), -1).astype(np.int32)
        args, fns = (logits, labels), (pretrain.masked_lm_loss,
                                       jax_pretrain.masked_lm_loss)
        # no position masked: the denominator is 1
        empty = (logits, np.full((3, 6), -1, np.int32))
        close(pretrain.masked_lm_loss(*map(t, empty)), 0.0, 1e-7)
    elif kind == "matched":
        args = (rng.randn(5, 2).astype(np.float32),
                np.array([0, 1, 1, 0, 1], np.int32))
        fns = (pretrain.matched_loss, jax_pretrain.matched_loss)
    elif kind == "contrastive":
        a = rng.randn(6, 8).astype(np.float32)
        b = a + 0.3 * rng.randn(6, 8).astype(np.float32)
        b[4] = -a[4]
        args = (a, b, np.array([1, -1, 1, -1, -1, 1], np.int32))
        fns = (pretrain.cosine_contrastive_loss,
               jax_pretrain.cosine_contrastive_loss)
        torch_ref = torch.nn.functional.cosine_embedding_loss(
            t(a), t(b), t(args[2]), margin=0.1)
        close(fns[0](*map(t, args)), torch_ref.item(), 1e-5)
    else:
        args = (rng.randn(2, 5, 4).astype(np.float32),
                rng.randn(2, 5, 4).astype(np.float32),
                (rng.rand(2, 5) < 0.5).astype(np.float32))
        fns = (pretrain.visual_feat_loss, jax_pretrain.visual_feat_loss)
    close(fns[0](*map(t, args)), np.asarray(fns[1](*map(jnp.asarray, args))),
          1e-5)


def test_masking_utilities_match_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(5, 100, (6, 20)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 15:] = 0
    for seed in (0, 1):
        got = pretrain.mask_words(ids, mask, 100, 3, 0.3,
                                  np.random.RandomState(seed))
        want = jax_pretrain.mask_words(ids, mask, 100, 3, 0.3,
                                       np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (got[1][:, 0] == -1).all() and (got[1][:, 15:] == -1).all()
    feats = rng.randn(2, 4, 3, 3, 5).astype(np.float32)
    got = pretrain.mask_visual_feats(feats, 0.4, np.random.RandomState(2))
    want = jax_pretrain.mask_visual_feats(feats, 0.4,
                                          np.random.RandomState(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_answer_table_and_surgery_match_jax():
    answers = ["cat", "a dog", "The Table.", "open", "an apple", "Cat"]
    got, want = pretrain.AnswerTable(answers), jax_pretrain.AnswerTable(answers)
    assert got.ans2id == want.ans2id and got.id2ans == want.id2ans
    assert len(got) == len(want) == 5
    for ans in ("CAT", "the dog", "apple.", "close", " Open "):
        assert got.convert(ans) == want.convert(ans)
    rng = np.random.RandomState(0)
    d = 6
    ans_w = rng.randn(len(got), d).astype(np.float32)
    ans_b = rng.randn(len(got)).astype(np.float32)
    model_w = rng.randn(5, d).astype(np.float32)
    model_b = rng.randn(5).astype(np.float32)
    for label2ans in ({0: "dog", 1: "CAT", 2: "unknownthing", 3: "table",
                       4: "close"}, ["apple", "x", "open", "cat", "dog"]):
        out = pretrain.answer_head_surgery(ans_w, ans_b, model_w, model_b,
                                           label2ans, got)
        ref = jax_pretrain.answer_head_surgery(ans_w, ans_b, model_w,
                                               model_b, label2ans, want)
        for g, w in zip(out, ref):
            np.testing.assert_array_equal(g, w)
    assert out[2:] == (4, 1)

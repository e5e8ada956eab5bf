"""Per-choice STAR QA (``--qaArrangeType add_sep|no_sep``) in the port
against the JAX package at tiny_test_config size in f32: the item source's
arrays for both arrangements (equal); ``ShgVqaModel`` per choice for tasks
'hgqa', 'hgvqa', 'vhga', 'vqa' and 'q' (1e-4); ``compute_losses`` and the
eval step's answers and matched class accuracy on the (B, 4) logits
(1e-5); the optimizer mask name for name
against the JAX driver's and the reach rule (the parameters the loss's
backward reaches are exactly the mask's), with and without
``--afterCrossAttnFeats``; the choice heads through the converter and the
reference importer.  ``tests/test_torch_per_choice_train_step.py`` holds
three train steps to the JAX ``make_train_step``.

One jitted JAX apply per task on seeded random weights (their tree from
``jax.eval_shape``), shared by the module."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data.star import STARData as JaxSTARData
from shgvqa_tpu.data.star import STARItemSource as JaxSTARItemSource
from shgvqa_tpu.data.tokenization import BertTokenizer as JaxBertTokenizer
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.data.pipeline import Batcher
from shgvqa_tpu_torch.data.star import STARData, STARItemSource
from shgvqa_tpu_torch.data.tokenization import (
    BertTokenizer,
    build_vocab_from_corpus,
)
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.train import step
from test_torch_common import close, load_port, perturb, t
from test_torch_model import _batch

TOL, LOSS_TOL = 1e-4, 1e-5
NCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def per_choice_cfgs(task="hgqa", arrange="add_sep", **more):
    """(JAX cfg, port cfg) of a STAR per-choice run: 4 answers, the hg
    mask on, the given arrangement."""
    def build(tiny):
        cfg = tiny(task=task, num_answers=NCH, use_hg_mask=True, **more)
        return cfg.replace(data=dataclasses.replace(
            cfg.data, dataset="star", qa_arrange_type=arrange))
    return build(jax_tiny), build(tiny_test_config)


def per_choice_batch(cfg, seed=0):
    """A labelled featurized batch of two clips with four (question,
    choice) encodings each, the hg mask of its labels and 4-way targets."""
    d, e = cfg.data, cfg.encoder
    batch = _batch(cfg, seed=seed)
    rng = np.random.RandomState(seed + 1)
    s = d.num_situations
    batch.update(
        rel_labels=rng.randint(1, cfg.num_rel_classes + 1,
                               (2, s, d.num_rel)).astype(np.int32),
        rel_lengths=rng.randint(1, d.num_rel + 1, (2, s)).astype(np.int32),
        act_labels=rng.randint(1, cfg.num_act_classes + 1,
                               (2, s, d.num_act)).astype(np.int32),
        act_lengths=rng.randint(1, d.num_act + 1, (2, s)).astype(np.int32))
    lt = d.max_seq_length
    mask = np.ones((2, NCH, lt), np.int32)
    mask[1, :, lt // 2:] = 0
    mask[0, 2, lt - 2:] = 0
    batch["choice_input_ids"] = rng.randint(
        1, e.vocab_size, (2, NCH, lt)).astype(np.int32)
    batch["choice_input_mask"] = mask
    batch["choice_segment_ids"] = np.zeros((2, NCH, lt), np.int32)
    batch["target"] = np.eye(NCH, dtype=np.float32)[[1, 3]]
    batch["answer_idx"] = np.array([1, 3], np.int32)
    slots = np.arange(d.num_act + d.num_rel)
    lengths = np.concatenate([batch["act_lengths"][..., None]
                              > slots[None, None, :d.num_act],
                              batch["rel_lengths"][..., None]
                              > slots[None, None, :d.num_rel]], axis=-1)
    batch["hg_mask"] = lengths.astype(np.int32)
    if cfg.task == "q":
        for key in ("visual_feats", "visual_mask"):
            batch.pop(key)
    return batch


def random_variables(jmodel, batch, seed=0):
    """Seeded random variables of the flax model's tree (its shapes from
    ``jax.eval_shape``, no init compiled): LayerNorm scales 1 + 0.05 N,
    every other leaf 0.05 N."""
    shapes = jax.eval_shape(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, deterministic=True), batch)
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, x in tree.items():
            if isinstance(x, dict):
                out[key] = fill(x)
                continue
            noise = 0.05 * rng.randn(*x.shape).astype(np.float32)
            out[key] = jnp.asarray(noise + (key == "scale"))
        return out
    return fill(jax.tree_util.tree_map(lambda x: x, shapes,
                                       is_leaf=lambda x: not isinstance(
                                           x, dict)))


@functools.lru_cache(maxsize=None)
def jax_run(task, arrange="add_sep", after=False):
    """(JAX cfg, port cfg, variables, batch, JAX outputs): one jitted
    apply per configuration."""
    jcfg, cfg = per_choice_cfgs(task, arrange,
                                after_cross_attn_feats=after)
    jmodel = JaxShgVqaModel(jcfg)
    batch = per_choice_batch(jcfg)
    v = random_variables(jmodel, batch)
    out = jax.device_get(jax.jit(
        lambda v, b: jmodel.apply(v, b, deterministic=True))(v, batch))
    return jcfg, cfg, v, batch, out


# -- the item source ---------------------------------------------------


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    _, cfg = per_choice_cfgs()
    data = STARData.synthetic(cfg, "train", n=24, seed=0)
    corpus = [x["question"] for x in data.datums]
    for x in data.datums:
        corpus += list(STARItemSource._choices(x).values())
    path = os.path.join(str(tmp_path_factory.mktemp("vocab")), "vocab.txt")
    build_vocab_from_corpus(corpus + ["0 1 2 3 :"], path)
    return path


@pytest.mark.parametrize("task", ["hgqa", "q"])
@pytest.mark.parametrize("arrange", ["add_sep", "no_sep"])
def test_item_source_matches_jax(vocab, arrange, task):
    """Every item's arrays (the question-only primary text and the four
    (question, choice) encodings) equal JAX's; four distinct rows."""
    jcfg, cfg = per_choice_cfgs(task, arrange)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               qtype="Interaction"))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data,
                                                 qtype="Interaction"))
    want_src = JaxSTARItemSource(JaxSTARData.synthetic(jcfg, "train", n=24),
                                 JaxBertTokenizer(vocab), jcfg)
    got_src = STARItemSource(STARData.synthetic(cfg, "train", n=24),
                             BertTokenizer(vocab), cfg)
    assert got_src.per_choice and len(got_src) == len(want_src) > 0
    for i in range(len(got_src)):
        got, want = got_src[i], want_src[i]
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), key)
    item = got_src[0]
    assert item["choice_input_ids"].shape == (NCH, cfg.data.max_seq_length)
    assert len({tuple(r) for r in item["choice_input_ids"]}) == NCH
    batch = next(Batcher(got_src, batch_size=3, shuffle=False).epoch(0))
    assert batch["choice_input_mask"].shape == (3, NCH,
                                                cfg.data.max_seq_length)


# -- the model, the losses, the eval step ------------------------------


@pytest.mark.parametrize("task", ["hgqa", "hgvqa", "vhga", "vqa", "q"])
def test_per_choice_model_matches_jax(task):
    jcfg, cfg, v, batch, want = jax_run(task)
    port = load_port(ShgVqaModel(cfg), v)
    with torch.inference_mode():
        got = port({k: t(x) for k, x in batch.items()})
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        close(got[key], want[key], TOL)
    if task != "q":
        assert got["logit"].shape == (2, NCH)
        assert ("choice_score_fc2" in dict(port.named_children())) == (
            task == "hgvqa")
    else:
        assert "choice_score_fc" not in dict(port.named_children())


@pytest.mark.parametrize("task", ["hgqa", "hgvqa", "vqa"])
def test_compute_losses_and_eval_step_match_jax(task):
    """Both packages' compute_losses on the JAX model's (B, 4) outputs
    (1e-5), and the eval step's argmaxes and matched class accuracy."""
    jcfg, cfg, v, batch, outputs = jax_run(task)
    _, want = jax_step.compute_losses(jcfg, outputs, batch)
    tb = {k: t(x) for k, x in batch.items()}
    _, got = step.compute_losses(cfg, {k: t(x) for k, x in outputs.items()},
                                 tb)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], LOSS_TOL)
    preds = step.make_eval_step(cfg, load_port(ShgVqaModel(cfg), v),
                                with_hg_metrics=True)(tb)
    np.testing.assert_array_equal(preds["answer"],
                                  outputs["logit"].argmax(-1))
    if task == "vqa":
        assert set(preds) == {"answer"}
        return
    np.testing.assert_array_equal(preds["hg_answer"],
                                  outputs["hg_logit"].argmax(-1))
    for kind in ("rel", "act"):
        close(preds[f"{kind}_class_acc"], 100.0 - want[f"{kind}_class_error"],
              LOSS_TOL)


# -- the optimizer mask --------------------------------------------------

MASK_CASES = [("hgqa", False), ("vhga", False), ("hgvqa", False),
              ("vqa", False), ("hgqa", True), ("vhga", True),
              ("hgvqa", True), ("q", False)]


def _jax_mask(jcfg, model):
    tree = {"params": to_jax_variables(model.state_dict())["params"]}
    mask = jax_step.connected_param_mask(tree, jcfg)
    full = jax.tree_util.tree_map(
        lambda m, x: np.full(np.shape(x), float(m), np.float32), mask, tree)
    return {k: bool(x.all()) for k, x in from_jax_variables(full).items()}


@pytest.mark.parametrize("task,after", MASK_CASES)
def test_mask_is_the_backward_reach_and_matches_jax(task, after):
    """The parameters a training backward reaches (dropout at the
    flagship's rates) are exactly ``connected_param_mask``'s, and that mask
    equals the JAX one name for name, but for the LXRT pooler under
    'hgqa' / 'vhga' with ``--afterCrossAttnFeats`` (the departure
    recorded, ROADMAP C)."""
    jcfg, cfg = per_choice_cfgs(task, after_cross_attn_feats=after)
    model = init_weights(ShgVqaModel(cfg), 0).train()
    batch = {k: t(x) for k, x in per_choice_batch(jcfg).items()}
    loss, metrics = step.compute_losses(
        cfg, model(batch, torch.Generator().manual_seed(0)), batch)
    loss.backward()
    assert torch.isfinite(metrics["total_loss"])
    got = step.connected_param_mask(model, cfg)
    for n, p in model.named_parameters():
        assert (p.grad is not None) == got[n], n
    want = _jax_mask(jcfg, model)
    assert got.keys() == want.keys()
    departs = {n for n in got if got[n] != want[n]}
    pooler = {n for n in got if n.startswith("lxrt.pooler.")}
    assert departs == (pooler if after and task in ("hgqa", "vhga")
                       else set())
    if task != "q":
        assert not any(n.startswith("logit_fc") for n in got)
        assert got["choice_score_fc.fc1.weight"] == (task != "hgvqa")
    if task == "hgvqa":
        assert got["choice_score_fc2.fc1.weight"]


# -- the weights ---------------------------------------------------------


def test_choice_heads_cross_the_converter_and_the_reference_import():
    """The choice heads map both ways through ``convert``; a reference
    checkpoint (which has none: the reference never wired them) goes onto
    a per-choice model's weights as the JAX importer takes it: the same
    tree and report, every other tensor from the file, the choice heads
    left as they were."""
    from shgvqa_tpu.utils import ref_import as jax_ref_import
    from shgvqa_tpu_torch.utils import ref_import
    from test_torch_reference_writer import reference_state_dict

    jcfg, cfg, v, _, _ = jax_run("hgvqa")
    port = load_port(ShgVqaModel(cfg), v)
    state = port.state_dict()
    back = from_jax_variables(to_jax_variables(state), port)
    assert back.keys() == state.keys()
    for name in state:
        torch.testing.assert_close(back[name], state[name], rtol=0, atol=0)
    tree = to_jax_variables(state)
    sd = reference_state_dict(tree, cfg, seed=2)
    assert not any(k.startswith("choice_score") for k in sd)
    start = perturb(tree, np.random.RandomState(4))
    want, jax_report = jax_ref_import.reference_to_variables(sd, start, jcfg)
    got, report = ref_import.reference_to_variables(sd, start, cfg)
    assert report == jax_report and not report["skipped"]
    got_state = from_jax_variables(got)
    want_state = from_jax_variables(jax.device_get(want))
    start_state = from_jax_variables(start)
    assert got_state.keys() == want_state.keys() == state.keys()
    for name in state:
        torch.testing.assert_close(got_state[name], want_state[name],
                                   rtol=0, atol=0)
        kept = name.startswith("choice_score")
        torch.testing.assert_close(
            got_state[name], start_state[name] if kept else state[name],
            rtol=0, atol=0)


# -- the k-step chunks ---------------------------------------------------


def test_step_chunks_stage_the_choice_keys_and_refuse_a_missing_one():
    """``--stepsPerLoop 2`` on per-choice batches: the chunk's static slots
    hold the (B, 4, Lt) keys, a later chunk's keys are copied into them,
    and a batch without one fails the check instead of replaying stale
    text; the chunk's losses equal two single steps'."""
    from shgvqa_tpu_torch.train.graph import StepChunks
    from shgvqa_tpu_torch.train.optimizer import make_optimizer

    jcfg, cfg = per_choice_cfgs("hgvqa")
    batches = [{k: t(x) for k, x in per_choice_batch(jcfg, seed=s).items()}
               for s in (0, 2)]
    losses = []
    for chunked in (False, True):
        model = init_weights(ShgVqaModel(cfg), 0)
        opt = make_optimizer(model, 1e-3, 10,
                             trainable_mask=step.trainable_mask(model, cfg))
        train_step = step.make_train_step(cfg, model, opt)
        g = torch.Generator().manual_seed(0)
        if not chunked:
            losses.append([float(train_step(b, g, opt.lr_at(i) * torch.ones(
                ()))["total_loss"].detach()) for i, b in enumerate(batches)])
            continue
        chunks = StepChunks(model, train_step, opt, g, 2)
        metrics = chunks.run(batches)
        losses.append([float(x) for x in metrics["total_loss"]])
        slot = chunks.slots[1]["choice_input_ids"]
        assert slot.shape == (2, NCH, cfg.data.max_seq_length)
        assert torch.equal(slot, batches[1]["choice_input_ids"])
        swapped = [batches[1], batches[0]]
        chunks.run(swapped)
        assert torch.equal(chunks.slots[0]["choice_input_ids"],
                           batches[1]["choice_input_ids"])
        missing = [{k: x for k, x in b.items()
                    if k != "choice_segment_ids"} for b in batches]
        with pytest.raises(ValueError, match="batch fields"):
            chunks.run(missing)
    assert losses[0] == losses[1]

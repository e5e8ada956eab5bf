"""The capsule encoder (the path without ``--noCaps``, STAR's README
command) in the port against the JAX package at tiny_test_config size in
f32:

- ``PrimaryCaps``, ``EMRouting`` ('hinton' and 'reference'),
  ``CapsuleVisualTokenizer`` and ``LanguageCapsuleMask`` (with and without
  the skip connection) forward within 1e-5, EM routing's gradients against
  ``jax.grad`` within 1e-4, and EM routing in bf16 (f32 inside);
- three train steps of the capsule model against the JAX
  ``make_train_step`` by ``tests/test_torch_train_step.py``'s rule;
- the optimizer mask against the JAX ``connected_param_mask`` name for
  name, and the reach rule (the loss's backward reaches exactly the mask),
  for capsules without and with ``--crossAttn`` and for
  ``--sharedWeights``; under ``--GTHG`` the capsule modules join the
  visual stream the port leaves out (a JAX fault, ROADMAP C);
- ``cli.star.main(..., device="cpu")`` at ``README.md``'s STAR flags as
  printed (no ``--noCaps``) with ``--stepsPerLoop 2``, to LAST and
  ``--test``.

One jitted JAX init of the small modules, and one JAX init and jitted
train step of the capsule model (the bulk of the file's time)."""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models import capsules as jax_caps
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu.train import step as jax_step
from shgvqa_tpu_torch.cli import common, star
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables
from shgvqa_tpu_torch.models import capsules, shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.train import step
from test_torch_common import TOY, close, load_port, perturb, t
from test_torch_train_step import (
    _labelled_batch,
    _mask_by_port_name,
    check_steps_match,
    port_for,
    run_jax_steps,
)

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# the modules' shapes: 6 positions, 4 primary capsules of 3 x 3 poses
# routed to 5, 16 features
N, C_IN, C_OUT, P, D = 6, 4, 5, 3, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(module, *args, seed=0):
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    return jax.tree_util.tree_map(jnp.asarray, perturb(
        jax.device_get(v), np.random.RandomState(seed + 1)))


@pytest.fixture(scope="module")
def routing_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(N, C_IN, P * P).astype(np.float32),
            rng.rand(N, C_IN).astype(np.float32))


def test_primary_caps_matches_jax():
    x = np.random.RandomState(1).randn(2, 3, D).astype(np.float32)
    jmod = jax_caps.PrimaryCaps(num_caps=C_IN, pose_dim=P)
    v = _perturbed(jmod, x)
    want = jmod.apply(v, x)
    port = load_port(capsules.PrimaryCaps(D, C_IN, P), v)
    with torch.inference_mode():
        got = port(t(x))
    assert got[0].shape == (2, 3, C_IN, P * P)
    for g, w in zip(got, want):
        close(g, w, FWD_TOL)


def _cotangents(seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, C_OUT, P * P).astype(np.float32),
            rng.randn(N, C_OUT).astype(np.float32))


def test_em_routing_matches_jax(routing_inputs):
    """The default ('hinton') routing: mu and the output activations
    within 1e-5; the gradients of a random projection of both, with
    respect to the poses, the input activations and every parameter,
    within 1e-4 of ``jax.grad``."""
    poses, acts = routing_inputs
    jmod = jax_caps.EMRouting(C_OUT, P)
    v = _perturbed(jmod, poses, acts)
    port = load_port(capsules.EMRouting(C_IN, C_OUT, P), v)
    want = jax.jit(jmod.apply)(v, poses, acts)
    with torch.inference_mode():
        got = port(t(poses), t(acts))
    for g, w in zip(got, want):
        close(g, w, FWD_TOL)

    cot = _cotangents()

    def jax_loss(params, x, a):
        mu, a_out = jmod.apply({"params": params}, x, a)
        return jnp.sum(mu * cot[0]) + jnp.sum(a_out * cot[1])

    gp, gx, ga = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        v["params"], poses, acts)
    x, a = t(poses).requires_grad_(), t(acts).requires_grad_()
    mu, a_out = port.train()(x, a)
    loss = (mu * t(cot[0])).sum() + (a_out * t(cot[1])).sum()
    loss.backward()
    close(x.grad, gx, GRAD_TOL)
    close(a.grad, ga, GRAD_TOL)
    want_grads = from_jax_variables({"params": jax.device_get(gp)})
    for name, p in port.named_parameters():
        close(p.grad, want_grads[name], GRAD_TOL)


@pytest.fixture(scope="module")
def reference_routing(routing_inputs):
    """(port module, its votes, the JAX module's perturbed params) of the
    'reference' routing."""
    poses, acts = routing_inputs
    jmod = jax_caps.EMRouting(C_OUT, P, variant="reference")
    v = _perturbed(jmod, poses, acts)
    port = load_port(capsules.EMRouting(C_IN, C_OUT, P,
                                        variant="reference"), v)
    return port, port.votes(t(poses)).detach(), v["params"]


def test_em_routing_reference_matches_jax_in_f64(routing_inputs,
                                                 reference_routing):
    """The reference's routing (``_em_routing_reference``, quirks kept) on
    the same votes in float64 on both sides: forward within 1e-5, the
    gradients with respect to the votes, the input activations, beta_u
    and beta_a within 1e-4.  In float64 its cost 'stdv', a sum that is 0
    in exact arithmetic, sits at sqrt(eps) on both sides."""
    _, votes, params = reference_routing
    acts = routing_inputs[1]
    args64 = [np.asarray(x, np.float64) for x in
              (votes.numpy(), acts, params["beta_u"], params["beta_a"])]
    cot = [np.asarray(c, np.float64) for c in _cotangents()]

    def jax_loss(*xs):
        mu, a_out = jax_caps._em_routing_reference(*xs)
        return jnp.sum(mu * cot[0]) + jnp.sum(a_out * cot[1])

    with jax.enable_x64(True):
        want = jax.device_get(jax.jit(jax_caps._em_routing_reference)(
            *args64))
        want_grads = jax.device_get(jax.jit(jax.grad(
            jax_loss, argnums=(0, 1, 2, 3)))(*args64))
    xs = [torch.from_numpy(x).requires_grad_() for x in args64]
    got = capsules._em_routing_reference(*xs)
    assert got[0].dtype == torch.float64
    for g, w in zip(got, want):
        close(g, w, FWD_TOL)
    ((got[0] * torch.from_numpy(cot[0])).sum()
     + (got[1] * torch.from_numpy(cot[1])).sum()).backward()
    for x, w in zip(xs, want_grads):
        close(x.grad, w, GRAD_TOL)


def test_em_routing_reference_in_f32_is_as_near_f64_as_jax(
        routing_inputs, reference_routing):
    """In float32 the reference's cost 'stdv' is the rounding of that zero
    sum (its square over C reaches eps), and the activations divide by it:
    each package's float32 activations carry ~4e-4 of its own rounding,
    and through the e-steps so does mu (jitted and eager JAX differ by
    ~2e-5 there).  The module's float32 mu and activations are held to
    the float64 values no further than twice the JAX module's float32
    ones."""
    port, votes, params = reference_routing
    poses, acts = routing_inputs
    jmod = jax_caps.EMRouting(C_OUT, P, variant="reference")
    jax32 = jax.device_get(jax.jit(jmod.apply)({"params": params}, poses,
                                                acts))
    with torch.inference_mode():
        port32 = port(t(poses), t(acts))
    exact = capsules._em_routing_reference(
        votes.double(), t(acts).double(),
        *(t(params[k]).double() for k in ("beta_u", "beta_a")))
    for got, want, ref in zip(port32, jax32, exact):
        ref = ref.detach().numpy()
        assert (np.abs(got.numpy() - ref).max()
                <= 2 * np.abs(np.asarray(want) - ref).max() + 1e-6)


def test_em_routing_in_bf16_routes_in_f32(routing_inputs):
    """bf16 poses and activations: the votes and every routing step in f32
    on both sides, the outputs cast to bf16 at the end (within a bf16
    unit, 1e-2 relative)."""
    poses, acts = routing_inputs
    jmod = jax_caps.EMRouting(C_OUT, P, dtype=jnp.bfloat16)
    v = _perturbed(jmod, poses, acts)
    want = jmod.apply(v, jnp.asarray(poses, jnp.bfloat16),
                      jnp.asarray(acts, jnp.bfloat16))
    port = load_port(capsules.EMRouting(C_IN, C_OUT, P,
                                        dtype=torch.bfloat16), v)
    with torch.inference_mode():
        got = port(t(poses, torch.bfloat16), t(acts, torch.bfloat16))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        close(g, np.asarray(w, np.float32), 1e-2)


def test_capsule_tokenizer_matches_jax():
    """(B, T, H, W, C) features -> 1 + T*H*W tokens of C_OUT * (P*P + 1),
    CLS first, positions added."""
    feats = np.random.RandomState(3).randn(2, 2, 2, 3, 8).astype(np.float32)
    jmod = jax_caps.CapsuleVisualTokenizer(
        hidden_size=D, num_prim_caps=C_IN, num_vis_caps=C_OUT, pose_dim=P)
    v = _perturbed(jmod, feats)
    want = jax.jit(jmod.apply)(v, feats)
    port = load_port(capsules.CapsuleVisualTokenizer(
        8, D, 1 + 2 * 2 * 3, C_IN, C_OUT, P), v)
    with torch.inference_mode():
        got = port(t(feats))
    assert got.shape == (2, 13, C_OUT * (P * P + 1))
    close(got, want, FWD_TOL)


@pytest.mark.parametrize("skip", [False, True], ids=["no_skip", "skip"])
def test_language_capsule_mask_matches_jax(skip):
    rng = np.random.RandomState(4)
    tokens = rng.randn(2, 7, C_OUT * (P * P + 1)).astype(np.float32)
    cls = rng.randn(2, D).astype(np.float32)
    jmod = jax_caps.LanguageCapsuleMask(num_vis_caps=C_OUT, pose_dim=P,
                                        skip_connection=skip)
    v = _perturbed(jmod, tokens, cls)
    want = jmod.apply(v, tokens, cls)
    port = load_port(capsules.LanguageCapsuleMask(D, C_OUT, skip), v)
    with torch.inference_mode():
        got = port(t(tokens), t(cls))
    close(got, want, FWD_TOL)
    np.testing.assert_array_equal(got[:, 0].numpy(), tokens[:, 0])


# -- the capsule model -----------------------------------------------------------

def caps_cfg(cfg, **enc):
    return cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, no_caps=False, **enc))


def caps_batch(cfg, seed=0):
    """``_labelled_batch`` with the features of ``cfg``'s tokenizer: on
    the capsule path every trunk frame is a token (``visual_t`` frames),
    the conv tokenizer takes 8 more."""
    batch = _labelled_batch(cfg, seed)
    e = cfg.encoder
    batch["visual_feats"] = np.random.RandomState(seed + 7).randn(
        2, e.visual_t + (8 if e.no_caps else 0), e.visual_hw, e.visual_hw,
        e.visual_feat_dim
    ).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def caps_run():
    cfg = caps_cfg(jax_tiny(task="hgqa"))
    return run_jax_steps(cfg, caps_batch(cfg))


def test_capsule_train_steps_match_jax(caps_run):
    """Three train steps of the capsule 'hgqa' model (no x-layers) at
    dropout 0: the mask, every metric at each step and each parameter's
    change."""
    cfg, model, opt, batch = port_for(caps_run,
                                      caps_cfg(tiny_test_config(task="hgqa")))
    assert not any(n.startswith("lxrt.encoder.x_")
                   for n, _ in model.named_parameters())
    check_steps_match(caps_run, cfg, model, opt, batch)


# (name, encoder overrides, config overrides)
MASK_CASES = {
    "capsules": (dict(no_caps=False), {}),
    "capsules_crossAttn": (dict(no_caps=False, caps_cross_attn=True), {}),
    "sharedWeights": (dict(shared_weights=True), {}),
    "capsules_GTHG": (dict(no_caps=False), dict(gt_hg=True)),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_matches_jax_and_the_backward(case):
    """The port's mask name for name against the JAX
    ``connected_param_mask`` (its tree from ``jax.eval_shape``), and the
    parameters a training forward's loss reaches (dropout 0.1) exactly the
    mask's.  Capsules without --crossAttn: no x-layers, the LXRT pooler
    unreached; with it the x-layers unreached too; --sharedWeights: the
    l-layers carry both streams.  Under --GTHG the JAX mask also keeps the
    visual stream, here the capsule tokenizer, mask and projection and the
    r-layers, which no gradient reaches."""
    enc, over = MASK_CASES[case]

    def build(tiny):
        cfg = tiny(task="hgqa", **over)
        return cfg.replace(encoder=dataclasses.replace(cfg.encoder, **enc))
    jcfg, cfg = build(jax_tiny), build(tiny_test_config)
    batch = caps_batch(cfg)
    jmodel = JaxShgVqaModel(jcfg)
    # flax creates the GT-HG decoders' parameters on a batch without ids
    shapes = jax.eval_shape(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, deterministic=True), batch)
    if cfg.gt_hg:
        batch["rel_tgt_ids"] = batch["rel_labels"].reshape(2, -1)
        batch["act_tgt_ids"] = batch["act_labels"].reshape(2, -1)
    jax_mask = _mask_by_port_name(
        jax_step.connected_param_mask(shapes, jcfg),
        jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                               shapes))
    model = init_weights(ShgVqaModel(cfg), 0).train()
    mask = step.connected_param_mask(model, cfg)
    visual = ("lxrt.encoder.caps_", "lxrt.encoder.r_")
    differ = {n for n in mask if mask[n] != jax_mask[n]}
    assert differ == ({n for n in mask if n.startswith(visual)}
                      if cfg.gt_hg else set())
    loss, metrics = step.compute_losses(
        cfg, model({k: t(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(0)), {k: t(v) for k, v in
                                                       batch.items()})
    loss.backward()
    assert torch.isfinite(metrics["total_loss"])
    for name, p in model.named_parameters():
        assert (p.grad is not None) == mask[name], name
    assert not mask["lxrt.pooler.dense2.weight"]
    if case == "capsules_crossAttn":
        assert not mask["lxrt.encoder.x_tied.lang_ffn.output.bias"]
    if case == "sharedWeights":
        assert mask["lxrt.encoder.l_1.ffn.output.bias"]
        assert not any(".r_" in n for n in mask)
    if case == "capsules":
        assert mask["lxrt.encoder.caps_tokenizer.conv_caps.beta_u"]
        assert mask["lxrt.encoder.caps_mask.mask_capsules.weight"]


# -- the STAR driver at README.md's flags ------------------------------------------

# README.md's STAR command as printed (the capsule encoder)
README_STAR = ["--taskHGQA", "--useHGMask", "--qType", "Interaction",
               "--qaArrangeType", "add_sep_all", "--batchSize", "8"]
SMALL = ["--numSituations", "4", "--numRel", "4", "--numAct", "2",
         "--imageSize", "32", "--computeDtype", "float32", "--lr", "1e-3",
         "--logFreq", "1"]


def _shrink(monkeypatch):
    parse = common.parse_reference_flags_with_extras

    def narrow(argv, dataset=None):
        cfg, extras = parse(argv, dataset)
        return cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, hidden_size=32,
                                        num_heads=4, intermediate_size=64),
            decoder=dataclasses.replace(cfg.decoder, num_heads=4,
                                        ffn_dim=64)), extras

    monkeypatch.setattr(common, "parse_reference_flags_with_extras", narrow)
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = star.main(argv, device="cpu")
    return result, out.getvalue()


def test_star_readme_command_runs_the_capsule_encoder(tmp_path,
                                                      monkeypatch):
    """The STAR line of README.md as printed parses to the capsule encoder
    (16 frames, 1 + 16 * 7 * 7 = 785 visual tokens, 32 capsules of 4 x 4,
    no x-layers) and, at narrow widths and 32 x 32 frames, trains one epoch
    of two 2-step chunks at ``--stepsPerLoop 2`` on 32 synthetic questions
    (8 Interaction) with validation, writes LAST, and ``--test`` from it
    scores the oracle 1.0."""
    cfg, _ = common.parse_reference_flags_with_extras(README_STAR, "star")
    e = cfg.encoder
    assert not e.no_caps and not e.caps_cross_attn
    assert (e.visual_t, e.visual_seq_length, e.num_vis_caps, e.pose_dim) == (
        16, 785, 32, 4)
    _shrink(monkeypatch)
    out = tmp_path / "train"
    base = README_STAR + SMALL + ["--dataDir", str(tmp_path),
                                  "--syntheticData", "32",
                                  "--syntheticValid", "8", "--batchSize", "2"]
    result, stdout = _main(base + ["--epochs", "1", "--stepsPerLoop", "2",
                                   "--output", str(out)])
    assert "star driver: task=hgqa device=cpu" in stdout
    assert result["steps"] == 4 and len(result["history"]) == 1
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 4
    assert all(np.isfinite(r["total_loss"]) for r in records)
    last = torch.load(out / "LAST", weights_only=True)["params"]
    assert last["head.lxrt.encoder.caps_tokenizer.pos_embedding"].shape == (
        1 + 16, 544)
    _, stdout = _main(base + ["--test", "test", "--load", str(out / "LAST"),
                              "--output", str(tmp_path / "test")])
    assert "Oracle score: 1.0000" in stdout

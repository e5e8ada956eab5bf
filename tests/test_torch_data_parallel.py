"""Data-parallel runs of the port on the CPU: gloo process groups on
localhost, the tiny configuration in f32.  A run on N ranks must be the
one-process run on the global batch with its rows split.

Two spawns, started together when the module starts (each rank one
process, one intra-op thread), while this process computes the
references:

- world 2: three train steps of the video model (toy-width trunk trained,
  RandAugment, every dropout at 0.1, the FFN train path) and three steps of
  the head model at dropout 0 on a batch whose ranks hold different counts
  of weighted targets, once with the global normalizers and once with
  ``distributed.global_sum`` patched to the identity (a per-rank
  normalizer); then the ``agqa_hgqa`` driver under the ``SHGVQA_*``
  variables, two ranks on a new port;
- world 4: the video model's three steps;

and the driver's own ``--multiGPU`` spawner (``cli/common.spawn_ranks``)
with two ranks of the question-only driver.

Held: losses within 1e-5 relative of one port process on the global batch
(the JAX tests' 1e-4 against JAX's jitted step on a dp=2 mesh of the
conftest's 8 CPU devices, at dropout 0), parameter updates by
``test_torch_train_step.py``'s rule, parameters bit-equal across ranks; the
per-rank normalizer misses the one-process step by more than that; the
driver's per-epoch scores within 1e-9 of one process, its checkpoints
written once, LAST loadable."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS, LR, T_TOTAL, BATCH = 3, 1e-3, 10, 4
LOSS_RTOL, JAX_TOL = 1e-5, 1e-4
# test_torch_train_step.py's rule for parameter updates: |d - d_ref| <=
# UPDATE_TOL * |d_ref| over elements whose first moment is above NOISE x
# its RMS; the others within Adam's largest move
UPDATE_TOL, NOISE = 1e-4, 1e-5
# the slow_r50 trunk at toy widths (tests/test_torch_common.TOY)
TOY = dict(stem_width=8, mids=(8, 8, 8, 8), outs=(16, 16, 16, 16),
           depths=(1, 1, 1, 1))
# the driver's flags at CPU size (tests/test_torch_driver.py): the flagship
# topology, narrow widths, a toy trunk, two epochs of 12 steps
DRIVER_FLAGS = [
    "--taskHGQA", "--noCaps", "--crossAttnType", "cross", "--llayers", "5",
    "--xlayers", "2", "--rlayers", "5", "--dlayers", "5", "--backbone",
    "slow_r50", "--pallasFFNTrain", "--LossHGPerFrame", "--freezeBackbone",
    "--numSituations", "4", "--numRel", "4", "--numAct", "2",
    "--imageSize", "32", "--computeDtype", "float32", "--lr", "1e-3",
    "--logFreq", "4", "--tiny", "--syntheticData", "24", "--batchSize",
    "2", "--epochs", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the runs (this process and the ranks) -----------------------------------

def _cfg(case, module=None):
    """The port's tiny config of ``case`` (or ``module``'s, the JAX
    package's): 'video' with the trunk trained, RandAugment and the FFN
    train path; 'head' one layer a stack (one JAX compile is most of this
    module's time)."""
    if module is None:
        from shgvqa_tpu_torch.configs import config as module

    cfg = module.tiny_test_config(task="hgqa")
    if case == "video":
        cfg = cfg.replace(freeze_backbone=False, use_pallas_ffn_train=True)
        return cfg.replace(data=dataclasses.replace(
            cfg.data, augment_type="rand_aug"))
    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, l_layers=1, x_layers=1,
                                    r_layers=1),
        decoder=dataclasses.replace(cfg.decoder, num_layers=1))


def make_batch(case):
    """The global batch of 4 clips: rows 0-1 with every relation and
    action slot labelled, rows 2-3 with one of each, so the ranks of a
    dp=2 run hold different counts of weighted targets."""
    cfg = _cfg(case)
    d, e = cfg.data, cfg.encoder
    rng = np.random.RandomState(3)
    s = d.num_situations
    mask = np.ones((BATCH, d.max_seq_length), np.int32)
    mask[1, d.max_seq_length // 2:] = 0
    batch = {
        "input_ids": rng.randint(1, e.vocab_size, (BATCH, d.max_seq_length)
                                 ).astype(np.int32),
        "input_mask": mask,
        "segment_ids": np.zeros((BATCH, d.max_seq_length), np.int32),
        "rel_labels": rng.randint(1, cfg.num_rel_classes + 1,
                                  (BATCH, s, d.num_rel)).astype(np.int32),
        "act_labels": rng.randint(1, cfg.num_act_classes + 1,
                                  (BATCH, s, d.num_act)).astype(np.int32),
        "rel_lengths": np.array([d.num_rel] * 2 * s + [1] * 2 * s,
                                np.int32).reshape(BATCH, s),
        "act_lengths": np.array([d.num_act] * 2 * s + [1] * 2 * s,
                                np.int32).reshape(BATCH, s),
        "target": np.eye(cfg.num_answers, dtype=np.float32)[[1, 4, 2, 7]],
    }
    if case == "video":
        batch["frames"] = rng.randint(
            0, 255, (BATCH, e.visual_t + 8, d.image_size, d.image_size, 3)
        ).astype(np.uint8)
    else:
        batch["visual_feats"] = rng.randn(
            BATCH, e.visual_t + 8, e.visual_hw, e.visual_hw,
            e.visual_feat_dim).astype(np.float32)
        batch["visual_mask"] = np.ones((BATCH, e.visual_seq_length),
                                       np.int32)
    return batch


def _model(case):
    from shgvqa_tpu_torch.models import layers, shgvqa
    from shgvqa_tpu_torch.models.backbone import SlowR50
    from shgvqa_tpu_torch.models.layers import init_weights
    from shgvqa_tpu_torch.train import step
    from shgvqa_tpu_torch.train.optimizer import make_optimizer

    cfg = _cfg(case)
    if case == "video":
        saved = shgvqa.make_backbone
        shgvqa.make_backbone = lambda name, dtype: SlowR50(dtype, **TOY)
        try:
            model = shgvqa.VideoShgVqaModel(cfg)
        finally:
            shgvqa.make_backbone = saved
    else:
        model = shgvqa.ShgVqaModel(cfg)
    model = init_weights(model, seed=0).train()
    layers.set_dropout_rate(model, 0.1 if case == "video" else 0.0)
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    return cfg, model, opt


def run_steps(case):
    """Three train steps of ``case`` on this rank's rows of
    ``make_batch(case)`` (all of them in one process): the metrics of each
    step, the parameters before and after, the moments by name."""
    from shgvqa_tpu_torch.parallel.mesh import shard_batch
    from shgvqa_tpu_torch.train import step

    cfg, model, opt = _model(case)
    batch = {k: torch.from_numpy(v)
             for k, v in shard_batch(make_batch(case)).items()}
    names = {id(p): n for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step = step.make_train_step(cfg, model, opt)
    g = torch.Generator().manual_seed(5)
    metrics = [{k: float(v.detach()) for k, v in
                train_step(batch, g).items()}
               for _ in range(STEPS)]
    return {"metrics": metrics, "before": before,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "moments": {names[id(p)]: m.clone()
                        for p, m in zip(opt.params, opt.m)},
            "max_move": sum(opt.lr_at(i) for i in range(STEPS)) * 0.1
            / 0.999 ** 0.5 * STEPS ** 0.5}


def _shrink_driver():
    """Narrow widths and the toy trunk under the driver's real flags (as
    tests/test_torch_driver.py's ``_shrink``)."""
    from shgvqa_tpu_torch.cli import common
    from shgvqa_tpu_torch.models import shgvqa
    from shgvqa_tpu_torch.models.backbone import SlowR50

    parse = common.parse_reference_flags_with_extras

    def narrow(argv, dataset=None):
        cfg, extras = parse(argv, dataset)
        return cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, hidden_size=32,
                                        num_heads=4, intermediate_size=64),
            decoder=dataclasses.replace(cfg.decoder, num_heads=4,
                                        ffn_dim=64)), extras

    common.parse_reference_flags_with_extras = narrow
    shgvqa.make_backbone = lambda name, dtype: SlowR50(dtype, **TOY)
    return narrow


def run_driver(out, *extra):
    from shgvqa_tpu_torch.cli import agqa_hgqa

    result = agqa_hgqa.main(DRIVER_FLAGS + ["--output", str(out), "--dataDir",
                                            str(out), *extra], device="cpu")
    return {k: result[k] for k in ("steps", "history", "best")}


def rank_main(world, rank, port, driver_port, out):
    """One rank: the step runs under a gloo group, then (world 2) the
    driver under the SHGVQA_* variables; results into ``out``."""
    torch.set_num_threads(1)
    from shgvqa_tpu_torch.parallel import distributed

    assert distributed.maybe_initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device="cpu")
    results = {"video": run_steps("video")}
    results["all_reduces"] = distributed.all_reduce_sum_.launches
    if world == 2:
        results["head"] = run_steps("head")
        saved = distributed.global_sum
        distributed.global_sum = lambda t: t
        from shgvqa_tpu_torch.losses import set_prediction, vqa

        set_prediction.global_sum = vqa.global_sum = distributed.global_sum
        try:
            results["head_per_rank_norm"] = run_steps("head")
        finally:
            set_prediction.global_sum = vqa.global_sum = saved
            distributed.global_sum = saved
    torch.save(results, os.path.join(out, f"steps{rank}.pt"))
    distributed.shutdown()
    if world == 2:
        os.environ.update({distributed.ENV_COORDINATOR:
                           f"127.0.0.1:{driver_port}",
                           distributed.ENV_NUM_PROCESSES: "2",
                           distributed.ENV_PROCESS_ID: str(rank)})
        _shrink_driver()
        result = run_driver(os.path.join(out, "driver"), "--multiGPU")
        with open(os.path.join(out, f"driver{rank}.json"), "w") as f:
            json.dump(result, f)


class Spawn:
    """``world`` ranks of ``rank_main`` started as processes now; ``join``
    waits for them and asserts every one exited 0."""

    def __init__(self, world, out):
        self.world, self.out = world, str(out)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, TESTS]))
        for var in ("SHGVQA_COORDINATOR", "SHGVQA_NUM_PROCESSES",
                    "SHGVQA_PROCESS_ID"):
            env.pop(var, None)
        port, driver_port = _free_port(), _free_port()
        code = ("import sys, test_torch_data_parallel as m; "
                "m.rank_main(*map(int, sys.argv[1:5]), sys.argv[5])")
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(world), str(r), str(port),
             str(driver_port), self.out], env=env, cwd=self.out,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._done = None

    def join(self):
        if self._done is None:
            outs = [p.communicate(timeout=600)[0] for p in self.procs]
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
            self._done = outs
        return self._done

    def steps(self, rank):
        self.join()
        return torch.load(os.path.join(self.out, f"steps{rank}.pt"),
                          weights_only=False)


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    started = {w: Spawn(w, tmp_path_factory.mktemp(f"world{w}"))
               for w in (2, 4)}
    yield started
    for s in started.values():
        for p in s.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_process(spawns):
    """The references, in this process while the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {case: run_steps(case) for case in ("video", "head")}
    finally:
        torch.set_num_threads(threads)


# -- checks ------------------------------------------------------------------

def check_updates(got, ref, tol=UPDATE_TOL):
    """test_torch_train_step.py's rule: each parameter's change against
    the reference's change."""
    rms_m = torch.cat([m.flatten() for m in ref["moments"].values()]
                      ).square().mean().sqrt()
    for name, before in ref["before"].items():
        d_got = got["params"][name] - before
        d_ref = ref["params"][name] - before
        if name not in ref["moments"]:       # frozen or disconnected
            assert not d_got.any() and not d_ref.any(), name
            continue
        noise = ref["moments"][name].abs() < NOISE * rms_m
        err = (d_got - d_ref)[~noise].norm().item()
        assert err <= tol * d_ref[~noise].norm().item() + 1e-12, (name, err)
        assert ((d_got - d_ref)[noise].abs() <= 2 * ref["max_move"]).all(), \
            name


def check_losses(got, ref, rtol=LOSS_RTOL):
    for g, w in zip(got["metrics"], ref["metrics"]):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=1e-7,
                                       err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_steps_with_dropout_and_augmentation_match_one_process(
        spawns, one_process, world):
    """Video model, trunk trained, RandAugment, dropout 0.1: every rank's
    losses and parameters are the one-process run's on the global batch;
    the ranks' parameters are bit-equal."""
    ref = one_process["video"]
    ranks = [spawns[world].steps(r) for r in range(world)]
    for r in ranks:
        check_losses(r["video"], ref)
        check_updates(r["video"], ref)
        for name, p in r["video"]["params"].items():
            assert torch.equal(p, ranks[0]["video"]["params"][name]), name
    # a step: the set losses' normalizers and accuracies (2 x 2 per-frame
    # set losses) and one flat buffer of gradients and metrics
    assert ranks[0]["all_reduces"] == STEPS * 5


def test_global_normalizers_match_one_process_and_per_rank_ones_do_not(
        spawns, one_process):
    """The head model at dropout 0 on a batch whose two ranks hold
    different counts of weighted targets: with the global normalizers a
    dp=2 step is the one-process step; with a per-rank normalizer the
    losses and the updates miss it by more than the tolerance."""
    ref = one_process["head"]
    for r in range(2):
        got = spawns[2].steps(r)
        check_losses(got["head"], ref)
        check_updates(got["head"], ref)
    bad = spawns[2].steps(0)["head_per_rank_norm"]
    with pytest.raises(AssertionError):
        check_losses(bad, ref)
    with pytest.raises(AssertionError):
        check_updates(bad, ref)
    misses = [abs(g["rel_loss"] - w["rel_loss"]) / abs(w["rel_loss"])
              for g, w in zip(bad["metrics"], ref["metrics"])]
    assert max(misses) > 100 * LOSS_RTOL, misses


def test_dp2_steps_match_jax_on_a_dp2_mesh(spawns, one_process):
    """Port dp=2 (gloo) against JAX's jitted train step on a dp=2 mesh of
    the conftest's CPU devices, the batch sharded over it, from the same
    weights, dropout 0: losses 1e-4, updates by the rule."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from shgvqa_tpu.configs import config as jax_config
    from shgvqa_tpu.configs.config import MeshConfig
    from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
    from shgvqa_tpu.parallel.mesh import (
        make_mesh,
        replicated_sharding,
        shard_batch,
    )
    from shgvqa_tpu.train import step as jax_step
    from shgvqa_tpu.train.optimizer import make_optimizer
    from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables

    ref = one_process["head"]
    cfg = _cfg("head", jax_config)
    model = JaxShgVqaModel(cfg)
    mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=1),
                     jax.devices()[:2])
    variables = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, to_jax_variables(ref["before"])),
        replicated_sharding(mesh))
    tx = make_optimizer(LR, T_TOTAL, trainable_mask=jax_step
                        .connected_param_mask(variables, cfg))
    batch = shard_batch(make_batch("head"), mesh)
    mp = pytest.MonkeyPatch()
    mp.setattr(nn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        train_step = jax.jit(jax_step.make_train_step(cfg, model, tx))
        params, opt_state, metrics = variables, tx.init(variables), []
        for i in range(STEPS):
            params, opt_state, m = train_step(params, opt_state, batch,
                                              jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in
                            jax.device_get(m).items()})
    finally:
        mp.undo()
    want = {"metrics": metrics, "before": ref["before"],
            "params": from_jax_variables(jax.device_get(params)),
            "moments": ref["moments"], "max_move": ref["max_move"]}
    got = spawns[2].steps(0)["head"]
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=key)
    check_updates(got, want)


def test_two_process_driver_reproduces_one_process(spawns, tmp_path):
    """The agqa_hgqa driver as two ranks under the SHGVQA_* variables
    (``--multiGPU``; each rank builds its rows of every batch) against one
    process: the same steps, per-epoch valid and hg scores within 1e-9;
    CURRENT and LAST written once, by rank 0, into the shared output,
    rank 1's log in ``proc1``; LAST loads."""
    from shgvqa_tpu_torch.cli import common
    from shgvqa_tpu_torch.models import shgvqa

    saved = (common.parse_reference_flags_with_extras, shgvqa.make_backbone)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _shrink_driver()
        ref = run_driver(tmp_path / "one")
        spawns[2].join()
        out = os.path.join(spawns[2].out, "driver")
        results = []
        for r in range(2):
            with open(os.path.join(spawns[2].out, f"driver{r}.json")) as f:
                results.append(json.load(f))
        assert results[0] == results[1]
        assert results[0]["steps"] == ref["steps"] == 24
        assert len(results[0]["history"]) == len(ref["history"]) == 2
        for h, w in zip(results[0]["history"], ref["history"]):
            assert h["valid"] == pytest.approx(w["valid"], abs=1e-9)
            assert h["hg"] == pytest.approx(w["hg"], abs=1e-9)
        names = set(os.listdir(out))
        assert {"CURRENT", "LAST", "log.log", "proc1"} <= names
        proc1 = set(os.listdir(os.path.join(out, "proc1")))
        assert "log.log" in proc1 and not proc1 & {"CURRENT", "LAST", "BEST"}
        assert not [n for n in names if ".tmp." in n]
        last = torch.load(os.path.join(out, "LAST"), weights_only=True)
        one = torch.load(tmp_path / "one" / "LAST", weights_only=True)
        assert last["step"] == one["step"] == 24
        assert {k: v.shape for k, v in last["params"].items()} == {
            k: v.shape for k, v in one["params"].items()}
    finally:
        (common.parse_reference_flags_with_extras,
         shgvqa.make_backbone) = saved
        torch.set_num_threads(threads)


def test_multigpu_spawner_runs_one_rank_a_device(tmp_path, monkeypatch):
    """``cli/common.spawn_ranks``, what ``--multiGPU`` runs on a host of N
    GPUs: N processes on a local rendezvous, each a rank under the
    SHGVQA_* variables, rank 0's result handed back.  Two ranks of the
    question-only driver (no trunk, one layer) on the CPU: the result
    names a gloo world of 2 and the steps of one process, and rank 1
    logged into ``proc1``."""
    from shgvqa_tpu_torch.cli import common

    argv = ["--taskQ", "--noCaps", "--llayers", "1", "--tiny",
            "--syntheticData", "8", "--batchSize", "2", "--epochs", "1",
            "--computeDtype", "float32", "--fromScratch", "--multiGPU",
            "--output", str(tmp_path), "--dataDir", str(tmp_path)]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the ranks inherit it
    result = common.spawn_ranks("agqa", argv, "cpu", 2)
    assert result["process_group"] == {"backend": "gloo", "world": 2,
                                       "rank": 0}
    assert result["steps"] == 4
    assert (tmp_path / "LAST").exists()
    assert (tmp_path / "proc1" / "log.log").exists()

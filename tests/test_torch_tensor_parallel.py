"""Tensor parallelism of the port on the CPU (``--modelParallel``, JAX's
``_TP_RULES``): gloo process groups on localhost, the tiny configuration in
f32.  A run on dp x mp ranks must be the one-process run on the global
batch.

In this process (no group): the split plan against JAX's
``partition_params`` on the tiny hgqa and ``--vitInit`` models (their trees
from ``jax.eval_shape``), the port's extra shards enumerated, the
indivisible and head-misaligned cases kept whole; the draws of a rank (the
dropout module, the attention kernel's CPU path, ``keep_mask_reference``
with ``Hl``, ``Hg``, ``head0``) the one-process draw's rows and heads; the
split FFN chain through its plain versions against
``ffn_train_reference`` and its backward; the card paths of the split FFN
chain and of the attention kernels' counter through stand-in C entries.

Two spawns, started when the module starts (each rank one process, one
intra-op thread), while this process computes the references:

- world 2 (dp1 x mp2): three train steps of the video model (toy-width
  trunk trained, RandAugment, every dropout at 0.1, the FFN train path
  split at its all-reduce) and of the head model at dropout 0 on a batch
  whose rows hold different counts of weighted targets, with the
  normalizers over the data group, over the whole world, and with the
  clip's norm of the rank's shards only; one step with and without
  ``--remat``; one STAR step (the global matcher, the hg mask); the
  weights in and out (a checkpoint saved at mp2, a one-process checkpoint
  and a ``--loadLXMERTQA`` snapshot loaded at mp2);
- world 4 (dp2 x mp2): the video model's three steps, then the
  ``agqa_hgqa`` driver under the ``SHGVQA_*`` variables with
  ``--dataParallel 2 --modelParallel 2``, two epochs, then ``--test`` from
  its LAST.

Held by the data-parallel file's rules (``test_torch_data_parallel.py``):
losses within 1e-5 relative of one process, parameter updates by
``test_torch_train_step.py``'s rule, the gathered parameters bit-equal
across ranks; the driver's scores within 1e-9 of one process."""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_data_parallel as dpt
from test_torch_data_parallel import STEPS, check_losses, check_updates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
MP = 2
LR, T_TOTAL = dpt.LR, dpt.T_TOTAL
# the driver at CPU size (the data-parallel file's flags on 12 synthetic
# items: 6 steps an epoch), dp2 x mp2
SMALL = ["--syntheticData", "12"]
TP_FLAGS = SMALL + ["--dataParallel", "2", "--modelParallel", "2"]
# the split FFN chain against the one-call plain version
FFN_TOL = 1e-5


# -- the runs (this process and the ranks) -----------------------------------

def _model(case, seed=0):
    """``test_torch_data_parallel._model``'s model of ``case``, split over
    the model group (when one runs) before its optimizer is made."""
    from shgvqa_tpu_torch.models import layers, shgvqa
    from shgvqa_tpu_torch.models.backbone import SlowR50
    from shgvqa_tpu_torch.parallel.mesh import shard_model_
    from shgvqa_tpu_torch.train import step
    from shgvqa_tpu_torch.train.optimizer import make_optimizer

    cfg = dpt._cfg(case)
    if case == "video":
        saved = shgvqa.make_backbone
        shgvqa.make_backbone = lambda name, dtype: SlowR50(dtype, **dpt.TOY)
        try:
            model = shgvqa.VideoShgVqaModel(cfg)
        finally:
            shgvqa.make_backbone = saved
    else:
        model = shgvqa.ShgVqaModel(cfg)
    model = layers.init_weights(model, seed=seed).train()
    layers.set_dropout_rate(model, 0.1 if case == "video" else 0.0)
    shard_model_(model)
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    return cfg, model, opt


def whole_state(model, opt):
    """(parameters, moments by name) as one-process tensors."""
    from shgvqa_tpu_torch.parallel.mesh import gather_state_dict, whole_of

    names = {id(p): n for n, p in model.named_parameters()}
    state = gather_state_dict(model)
    params = {n: state[n] for n, _ in model.named_parameters()}
    moments = {names[id(p)]: (m if getattr(p, "tp_split", None) is None
                              else whole_of(m, p.tp_split)).clone()
               for p, m in zip(opt.params, opt.m)}
    return params, moments


def run_steps(case, steps=STEPS):
    """``steps`` train steps of ``case`` on this rank's rows of the global
    batch: the metrics, the parameters before and after and the moments,
    gathered; and the model collectives of each step."""
    from shgvqa_tpu_torch.parallel import distributed
    from shgvqa_tpu_torch.parallel.mesh import shard_batch
    from shgvqa_tpu_torch.train import step

    cfg, model, opt = _model(case)
    batch = {k: torch.from_numpy(v)
             for k, v in shard_batch(dpt.make_batch(case)).items()}
    before, _ = whole_state(model, opt)
    train_step = step.make_train_step(cfg, model, opt)
    g = torch.Generator().manual_seed(5)
    metrics, collectives = [], []
    for _ in range(steps):
        start = distributed.model_collectives()
        metrics.append({k: float(v.detach()) for k, v in
                        train_step(batch, g).items()})
        collectives.append({k: v - start[k] for k, v in
                            distributed.model_collectives().items()})
    params, moments = whole_state(model, opt)
    return {"metrics": metrics, "before": before, "params": params,
            "moments": moments, "collectives": collectives,
            "state": SimpleNamespace(model=model, optimizer=opt, step=steps),
            "max_move": sum(opt.lr_at(i) for i in range(steps)) * 0.1
            / 0.999 ** 0.5 * steps ** 0.5}


def remat_grads():
    """One head-model train forward and backward at dropout 0.1, without
    and with ``--remat`` (policy ''), from one generator state: the
    gathered gradients of each."""
    from shgvqa_tpu_torch.models import layers
    from shgvqa_tpu_torch.models.remat import set_remat
    from shgvqa_tpu_torch.parallel.mesh import shard_batch, whole_of
    from shgvqa_tpu_torch.train import step

    cfg, model, _ = _model("head")
    layers.set_dropout_rate(model, 0.1)
    batch = {k: torch.from_numpy(v)
             for k, v in shard_batch(dpt.make_batch("head")).items()}
    out = []
    for policy in (None, ""):
        set_remat(model, policy)
        model.zero_grad()
        loss, _ = step.compute_losses(
            cfg, model(batch, torch.Generator().manual_seed(3)), batch)
        loss.backward()
        out.append({n: (p.grad if getattr(p, "tp_split", None) is None
                        else whole_of(p.grad, p.tp_split)).clone()
                    for n, p in model.named_parameters()
                    if p.grad is not None})
    return out


def star_cfg():
    """The tiny config on STAR's shapes under the hg mask and the global
    matcher (``tests/test_torch_star.py``'s)."""
    from shgvqa_tpu_torch.configs.config import tiny_test_config

    cfg = tiny_test_config(task="hgqa", use_hg_mask=True,
                           loss_hg_per_frame=False)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, dataset="star", num_rel=4, clip_len=4))


def star_batch(cfg):
    """Four featurized STAR clips with labels, and an hg mask of the
    labelled slots."""
    d, e = cfg.data, cfg.encoder
    rng = np.random.RandomState(7)
    b, s = dpt.BATCH, d.num_situations
    batch = {
        "input_ids": rng.randint(1, e.vocab_size, (b, d.max_seq_length)
                                 ).astype(np.int32),
        "input_mask": np.ones((b, d.max_seq_length), np.int32),
        "segment_ids": np.zeros((b, d.max_seq_length), np.int32),
        "visual_feats": rng.randn(b, e.visual_t + 8, e.visual_hw,
                                  e.visual_hw, e.visual_feat_dim
                                  ).astype(np.float32),
        "visual_mask": np.ones((b, e.visual_seq_length), np.int32),
        "target": np.eye(cfg.num_answers, dtype=np.float32)[[1, 3, 0, 2]],
    }
    labelled = []
    for kind, slots, classes in (("rel", d.num_rel, cfg.num_rel_classes),
                                 ("act", d.num_act, cfg.num_act_classes)):
        lengths = rng.randint(1, slots + 1, (b, s)).astype(np.int32)
        labels = rng.randint(1, classes + 1, (b, s, slots)).astype(np.int32)
        labels[np.arange(slots)[None, None] >= lengths[..., None]] = 0
        batch[f"{kind}_labels"], batch[f"{kind}_lengths"] = labels, lengths
        labelled.append(labels > 0)
    batch["hg_mask"] = np.concatenate(labelled[::-1], -1).astype(np.int32)
    return batch


def star_step():
    """One STAR train step at dropout 0.1 on this rank's rows: its
    metrics."""
    from shgvqa_tpu_torch.models import layers
    from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
    from shgvqa_tpu_torch.parallel.mesh import shard_batch, shard_model_
    from shgvqa_tpu_torch.train import step
    from shgvqa_tpu_torch.train.optimizer import make_optimizer

    cfg = star_cfg()
    model = layers.init_weights(ShgVqaModel(cfg), seed=2).train()
    layers.set_dropout_rate(model, 0.1)
    shard_model_(model)
    opt = make_optimizer(model, LR, T_TOTAL,
                         trainable_mask=step.trainable_mask(model, cfg))
    batch = {k: torch.from_numpy(v)
             for k, v in shard_batch(star_batch(cfg)).items()}
    metrics = step.make_train_step(cfg, model, opt)(
        batch, torch.Generator().manual_seed(4))
    return {k: float(v.detach()) for k, v in metrics.items()}


def dumps_forward():
    """The head model's ``--outputAttn`` forward (eval, seed 0) on this
    rank's rows: every probability map of the attentions tree, flat, and
    hg_logit."""
    from shgvqa_tpu_torch.cli.common import _flatten_attentions
    from shgvqa_tpu_torch.parallel.mesh import shard_batch

    _, model, _ = _model("head")
    batch = {k: torch.from_numpy(v)
             for k, v in shard_batch(dpt.make_batch("head")).items()}
    with torch.inference_mode():
        out = model.eval()(batch, output_attentions=True)
    flat = _flatten_attentions(out["attentions"])
    flat["hg_logit"] = out["hg_logit"].numpy()
    return flat


LABELS = {i: f"a{i}" for i in range(13)}


def load_files(files, out=None):
    """The head model (seed 0) under a Trainer: the one-process checkpoint
    ``files['ckpt']`` loaded, its state taken again; then the
    ``--loadLXMERTQA`` snapshot ``files['snap']`` loaded into a fresh one.
    Both states as one-process tensors."""
    from shgvqa_tpu_torch.train.loop import Trainer

    from shgvqa_tpu_torch.parallel import distributed

    got = {}
    for what in ("ckpt", "snap"):
        cfg, model, _ = _model("head")
        cfg = cfg.replace(output=os.path.join(
            out or files["dir"], f"out_{what}_{distributed.rank()}"))
        trainer = Trainer(cfg, 5, model, checkpoint_dir=cfg.output)
        if what == "ckpt":
            trainer.load(files["ckpt"])
            got[what] = trainer.state_dict()
        else:
            got["qa"] = trainer.load_lxmert_qa(files["snap"], LABELS)
            got[what] = trainer.state_dict()["params"]
    return got


def write_files(out):
    """A one-process checkpoint of the head model (seed 7, moments drawn)
    and an LXMERT snapshot with its QA head (seed 9) under ``out``."""
    from shgvqa_tpu_torch.train.loop import Trainer, save_encoder_snapshot

    _, model, _ = _model("head", seed=7)
    cfg = dpt._cfg("head").replace(output=str(out))
    trainer = Trainer(cfg, 5, model, checkpoint_dir=str(out))
    g = torch.Generator().manual_seed(8)
    for t in trainer.optimizer.m + trainer.optimizer.v:
        t.copy_(torch.rand(t.shape, generator=g))
    trainer.step = 3
    trainer.ckpt.save("ONE", trainer.state_dict())
    _, snap, _ = _model("head", seed=9)
    save_encoder_snapshot(os.path.join(out, "snap_LXRT"), "lxrt",
                          snap.lxrt)
    w = snap.logit_fc.fc2.weight.detach().numpy()
    np.savez(os.path.join(out, "snap_qa_head.npz"), weight=w[:6],
             bias=np.arange(6, dtype=np.float32),
             answers=np.array(["a1", "a3", "zz", "a4", "a9", "q"]))
    return {"dir": str(out), "ckpt": os.path.join(out, "ONE"),
            "snap": os.path.join(out, "snap_LXRT")}


def rank_main(world, rank, port, ports, out, files):
    """One rank: the runs under a gloo group of dp x mp2, results into
    ``out``; then (world 4) the driver, trained and tested."""
    torch.set_num_threads(1)
    from shgvqa_tpu_torch.parallel import distributed

    files = json.loads(files)
    assert distributed.maybe_initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device="cpu")
    distributed.set_model_parallel(MP)
    results = {"video": run_steps("video")}
    results["video"].pop("state")
    if world == 2:
        head = run_steps("head")
        from shgvqa_tpu_torch.train.loop import Trainer

        state = Trainer.state_dict(head.pop("state"))
        if rank == 0:
            torch.save(state, os.path.join(out, "tp_ckpt"))
        results["head"] = head
        saved = distributed.global_sum
        from shgvqa_tpu_torch.losses import set_prediction, vqa

        def world_sum(t):
            t = t.detach().clone()
            torch.distributed.all_reduce(t)
            return t

        set_prediction.global_sum = vqa.global_sum = world_sum
        vqa.data_size = distributed.world_size
        try:
            results["head_world_norm"] = run_steps("head", 1)
        finally:
            set_prediction.global_sum = vqa.global_sum = saved
            vqa.data_size = distributed.data_size
        results["head_world_norm"].pop("state")
        model_sum = distributed.model_sum_
        distributed.model_sum_ = lambda t: t
        try:
            results["head_rank_clip"] = run_steps("head", 1)
        finally:
            distributed.model_sum_ = model_sum
        results["head_rank_clip"].pop("state")
        results["remat"] = remat_grads()
        results["star"] = star_step()
        results["dumps"] = dumps_forward()
        results["loads"] = load_files(files, out)
    torch.save(results, os.path.join(out, f"steps{rank}.pt"))
    distributed.shutdown()
    if world == 4:
        dpt._shrink_driver()
        for i, extra in enumerate((TP_FLAGS, TP_FLAGS + [
                "--test", "test", "--load",
                os.path.join(out, "driver", "LAST")])):
            os.environ.update({distributed.ENV_COORDINATOR:
                               f"127.0.0.1:{ports[i]}",
                               distributed.ENV_NUM_PROCESSES: str(world),
                               distributed.ENV_PROCESS_ID: str(rank)})
            result = (dpt.run_driver(os.path.join(out, "driver"), *extra)
                      if i == 0 else run_test(os.path.join(out, "test"),
                                              os.path.join(out, "driver"),
                                              extra))
            with open(os.path.join(out, f"driver{i}_{rank}.json"), "w") as f:
                json.dump(result, f)


def run_test(out, data_dir, extra):
    """``agqa_hgqa --test`` at the driver's flags (the vocab of the run in
    ``data_dir``): its scores."""
    from shgvqa_tpu_torch.cli import agqa_hgqa

    result = agqa_hgqa.main(dpt.DRIVER_FLAGS + [
        "--output", str(out), "--dataDir", str(data_dir), *extra],
        device="cpu")
    return {k: v for k, v in result.items()
            if k in ("all_qtypes", "hg_all_qtypes")}


class Spawn:
    """``world`` ranks of ``rank_main`` started as processes now."""

    def __init__(self, world, out, files):
        self.world, self.out = world, str(out)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, TESTS]))
        for var in ("SHGVQA_COORDINATOR", "SHGVQA_NUM_PROCESSES",
                    "SHGVQA_PROCESS_ID"):
            env.pop(var, None)
        ports = [dpt._free_port() for _ in range(3)]
        code = ("import sys, json, test_torch_tensor_parallel as m; "
                "m.rank_main(int(sys.argv[1]), int(sys.argv[2]), "
                "int(sys.argv[3]), json.loads(sys.argv[4]), sys.argv[5], "
                "sys.argv[6])")
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(world), str(r), str(ports[0]),
             json.dumps(ports[1:]), self.out, json.dumps(files)], env=env,
            cwd=self.out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
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

    def json(self, name):
        self.join()
        with open(os.path.join(self.out, name)) as f:
            return json.load(f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return write_files(tmp_path_factory.mktemp("files"))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawns(tmp_path_factory, files):
    started = {w: Spawn(w, tmp_path_factory.mktemp(f"tp_world{w}"), files)
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
        return {case: dpt.run_steps(case) for case in ("video", "head")}
    finally:
        torch.set_num_threads(threads)


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- in this process: the plan, the draws, the split chain -------------------

def _jax_plan(cfg):
    """{JAX path: spec} of JAX's ``partition_params`` at dp4 x mp2 over the
    conftest's CPU devices, on the tree of ``cfg``'s JAX model."""
    import jax

    from shgvqa_tpu.configs.config import MeshConfig
    from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxModel
    from shgvqa_tpu.parallel.mesh import _key_str, make_mesh, partition_params

    batch = {k: v for k, v in dpt.make_batch("head").items()}
    shapes = jax.eval_shape(lambda b: JaxModel(cfg).init(
        jax.random.PRNGKey(0), b, deterministic=True), batch)["params"]
    mesh = make_mesh(MeshConfig(data_parallel=4, model_parallel=MP))
    flat = jax.tree_util.tree_flatten_with_path(
        partition_params(shapes, mesh))[0]
    return {"/".join(_key_str(k) for k in kp): tuple(s.spec)
            for kp, s in flat}


def _port_paths(model):
    """Port parameter name -> (JAX path, the JAX dim of each torch dim)."""
    from shgvqa_tpu_torch.convert import _jax_leaf

    ranks = {n[:-len(".weight")]: p.dim()
             for n, p in model.named_parameters() if n.endswith(".weight")}
    out = {}
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        path, _, perm = _jax_leaf(module, leaf, ranks.get(module))
        out[name] = "/".join(path), perm
    return out


@pytest.mark.parametrize("vit_init", [False, True], ids=["hgqa", "vitInit"])
def test_split_plan_is_jaxs_partition_params(vit_init):
    """On the tiny hgqa model (and with ``--vitInit``'s ViT r-layers), leaf
    by leaf through ``convert.py``'s names: the port's plan splits exactly
    the kernels JAX's ``partition_params`` splits, on the same dim; the
    split model holds those and exactly the port's extra shards (the
    biases of column-split products, the ``MLPHead`` LayerNorms' affine);
    the attention output, poolers, embeddings and every other LayerNorm
    stay whole."""
    from jax.sharding import PartitionSpec as P

    from shgvqa_tpu.configs import config as jax_config
    from shgvqa_tpu_torch.configs import config as port_config
    from shgvqa_tpu_torch.models import layers
    from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
    from shgvqa_tpu_torch.parallel import mesh

    def cfg_of(module):
        cfg = module.tiny_test_config(task="hgqa")
        return cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, vit_init=vit_init))

    jax_plan = _jax_plan(cfg_of(jax_config))
    model = ShgVqaModel(cfg_of(port_config))
    paths = _port_paths(model)
    assert sorted(p for p, _ in paths.values()) == sorted(jax_plan)
    plan = mesh.split_plan(model, MP)
    for name, (path, perm) in paths.items():
        spec = jax_plan[path]
        want = [i for i, a in enumerate(spec) if a == "model"]
        assert (plan.get(name) is None) == (not want), name
        if want:
            assert plan[name] == perm[want[0]], name
    assert any("attention.output.dense" in n for n in paths)
    assert not any("output.dense" in n or "pooler" in n for n in plan)
    assert any(".r_0.fc1." in n for n in plan) == vit_init

    layers.init_weights(model, seed=0)
    whole = {n: p.shape for n, p in model.named_parameters()}
    assert mesh.shard_model_(model, 1, MP) == []
    split = {n for n, _ in mesh.sharded_parameters(model)}
    heads = {n.rpartition(".ln.")[0] for n in split if ".ln." in n}
    extras = {n[:-len("weight")] + "bias" for n, d in plan.items()
              if d == 0} | {f"{h}.ln.{leaf}" for h in heads
                            for leaf in ("weight", "bias")}
    assert heads == {"logit_fc", "class_embed", "action_embed"}
    assert split == set(plan) | extras
    assert not split & set(plan) - set(plan)
    for n, p in model.named_parameters():
        if n in split:
            dim = p.tp_split[0]
            assert p.shape[dim] * MP == whole[n][dim], n
        else:
            assert p.shape == whole[n], n
    assert P() in [P(*s) for s in jax_plan.values()]


def test_indivisible_and_misaligned_modules_stay_whole():
    """At mp3 JAX's fallback leaves every width-32 and width-64 kernel
    whole (32 % 3, 64 % 3) and splits only the decoders' packed (32, 96)
    ``in_proj`` by contiguous columns; the port's head-aligned split needs
    32 % 3, so it keeps those attentions whole too and names them, and
    splits nothing.  At mp4 on two heads JAX splits q, k, v by columns
    across a head and the port keeps those attentions whole (replicated)
    while their FFNs split.  A kind the port cannot split (MViT's MLP)
    stays whole and is named."""
    from shgvqa_tpu_torch.configs.config import tiny_test_config
    from shgvqa_tpu_torch.models import layers
    from shgvqa_tpu_torch.models.decoder import TorchMHA
    from shgvqa_tpu_torch.models.mvit import MViTB
    from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
    from shgvqa_tpu_torch.parallel import mesh

    model = layers.init_weights(ShgVqaModel(tiny_test_config(task="hgqa")))
    plan = mesh.split_plan(model, 3)
    assert plan and all(n.endswith("in_proj.weight") for n in plan)
    mha = sorted(n for n, m in model.named_modules()
                 if isinstance(m, TorchMHA))
    assert sorted(mesh.shard_model_(model, 0, 3, log=lambda line: None)) == mha
    assert not mesh.sharded_parameters(model)

    cfg = tiny_test_config(task="hgqa")
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, num_heads=2),
                      decoder=dataclasses.replace(cfg.decoder, num_heads=2))
    model = layers.init_weights(ShgVqaModel(cfg))
    lines = []
    whole = mesh.shard_model_(model, 3, 4, log=lines.append)
    attn = sorted(n for n, m in model.named_modules()
                  if isinstance(m, layers.Attention))
    assert set(attn) <= set(whole)
    assert all(getattr(model.get_submodule(n), "tp") is None for n in whole)
    assert model.lxrt.encoder.l_0.ffn.tp == (3, 4)
    assert len(lines) == 1 and "kept whole" in lines[0]

    trunk = layers.init_weights(MViTB(frames=8, image_size=32, embed_dim=8,
                                      depth=4, num_heads=1,
                                      stage_blocks=(1, 3),
                                      kv_stride=(1, 4, 4)))
    plan = mesh.split_plan(trunk, MP)
    assert plan and all(".mlp_fc" in n for n in plan)
    whole = mesh.shard_model_(trunk, 0, MP, log=lines.append)
    assert whole == sorted({n.rpartition(".")[0] for n in plan})
    assert not mesh.sharded_parameters(trunk)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_a_ranks_draws_are_the_one_process_draws_rows_and_heads(rate,
                                                                monkeypatch):
    """The dropout module with a split, the attention kernel's CPU path at
    a rank's heads and ``keep_mask_reference`` at ``Hl``, ``Hg``,
    ``head0``: the one-process draw's rows (data index 1 of 2) and heads
    (model index 1 of 2), and ``keep_mask_reference`` at mp1 is its
    default."""
    from shgvqa_tpu_torch.kernels import attention
    from shgvqa_tpu_torch.models import layers
    from shgvqa_tpu_torch.parallel import distributed

    b, h, lq, lk = 3, 4, 9, 7
    hl = h // MP
    seed = [0x1234, 0xABCD]
    whole = attention.keep_mask_reference(seed, 2 * b * h, lq, lk, 0.3)
    part = attention.keep_mask_reference(seed, b * hl, lq, lk, 0.3,
                                         group0=b * h, heads=hl,
                                         heads_global=h, head0=hl)
    want = whole.view(2 * b, h, lq, lk)[b:, hl:].reshape(b * hl, lq, lk)
    assert torch.equal(part, want)
    assert torch.equal(attention.keep_mask_reference(
        seed, b * h, lq, lk, 0.3, group0=8, heads=h, heads_global=h),
        attention.keep_mask_reference(seed, b * h, lq, lk, 0.3, group0=8))

    q, k, v = (torch.randn(2 * b, h, n, 64) for n in (lq, lk, lk))
    drop = layers.Dropout(rate).train()
    x = torch.randn(2 * b, h, lq, lk)
    full_drop = drop(x, torch.Generator().manual_seed(1))
    full_attn = attention.fused_attention(q, k, v, None, rate,
                                          torch.Generator().manual_seed(2))
    y = torch.randn(2 * b, 5, 8)
    full_cols = drop(y, torch.Generator().manual_seed(3))
    monkeypatch.setattr(distributed, "data_rank", lambda: 1)
    monkeypatch.setattr(distributed, "data_size", lambda: 2)
    got = drop(x[b:, hl:], torch.Generator().manual_seed(1), (1, hl, h))
    assert torch.equal(got, full_drop[b:, hl:])
    got = attention.fused_attention(q[b:, hl:], k[b:, hl:], v[b:, hl:], None,
                                     rate, torch.Generator().manual_seed(2),
                                     heads=(hl, h))
    torch.testing.assert_close(got, full_attn[b:, hl:], rtol=0, atol=1e-6)
    got = drop(y[b:, :, 4:], torch.Generator().manual_seed(3), (-1, 4, 8))
    assert torch.equal(got, full_cols[b:, :, 4:])


def _ffn_operands(m=10, d=64, f=256, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, d, generator=g)
    w1t, w2t = (0.1 * torch.randn(f, d, generator=g),
                0.1 * torch.randn(d, f, generator=g))
    b1 = 0.1 * torch.randn(f, generator=g)
    b2 = 0.1 * torch.randn(d, generator=g)
    gamma, beta = 1 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(
        d, generator=g)
    return x, w1t, b1, w2t, b2, gamma, beta


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_split_ffn_chain_is_the_one_call_chain(rate):
    """``--pallasFFNTrain`` at mp2 through the plain versions: the two
    ranks' partial products summed, + b2 once, then the row pass, equal
    ``ffn_train_reference``; backward, the row pass on the replicated dy
    (dr, do, dgamma, dbeta), the products on do per rank (dx without dr,
    du, h), dx = dr + the ranks' partials, the weight gradients the ranks'
    slices, equal ``ffn_train_backward_reference``, all within 1e-5."""
    from shgvqa_tpu_torch.kernels import ffn

    x, w1t, b1, w2t, b2, gamma, beta = _ffn_operands()
    keep = torch.rand(x.shape,
                      generator=torch.Generator().manual_seed(4)) >= rate
    f = w1t.shape[0] // MP
    shards = [(w1t[i * f:(i + 1) * f], b1[i * f:(i + 1) * f],
               w2t[:, i * f:(i + 1) * f]) for i in range(MP)]
    o = sum(ffn.ffn_partial_reference(x, *s) for s in shards)
    y = ffn.ffn_rows_reference(o, x, b2, gamma, beta, rate, keep)
    want = ffn.ffn_train_reference(x, w1t, b1, w2t, b2, gamma, beta, rate,
                                   keep)
    torch.testing.assert_close(y, want, rtol=FFN_TOL, atol=FFN_TOL)

    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    dr, do, dgamma, dbeta = ffn.ffn_rows_backward_reference(
        o + b2, x, gamma, rate, keep, dy)
    parts = [ffn.ffn_products_backward_reference(x, *s, do) for s in shards]
    dx = dr + sum(p[0] for p in parts)
    ref = ffn.ffn_train_backward_reference(x, w1t, b1, w2t, b2, gamma, rate,
                                           keep, dy)
    grads = [ffn._weight_grads(x, du, do, h) for _, du, h in parts]
    got = (dx, torch.cat([g[0] for g in grads]),
           torch.cat([g[1] for g in grads]),
           torch.cat([g[2] for g in grads], 1), grads[0][3], dgamma, dbeta)
    for name, a, w in zip(("dx", "dw1t", "db1", "dw2t", "db2", "dgamma",
                           "dbeta"), got, ref):
        torch.testing.assert_close(a, w, rtol=FFN_TOL, atol=FFN_TOL,
                                   msg=name)
    assert all(torch.equal(g[3], grads[0][3]) for g in grads)


def test_split_ffn_card_path_through_stand_in_entries(monkeypatch):
    """``fused_ffn_split``'s card path on CPU tensors with its four C
    entries replaced by the plain versions (``tensor_at`` on the
    pointers), a model group of two emulated by hand: the forward and the
    autograd backward equal autograd through ``ffn_train_reference``
    (1e-5; bf16 operands widened to f32 stand for the card's dtype here),
    each wrapper counts one forward and one backward a call, and the C
    entries get the row offset, the zero b2 and zero dr."""
    from shgvqa_tpu_torch.kernels import ffn
    from shgvqa_tpu_torch.parallel import distributed
    from test_torch_common import tensor_at

    x, w1t, b1, w2t, b2, gamma, beta = (
        t.to(torch.bfloat16) if i in (0, 1, 3) else t
        for i, t in enumerate(_ffn_operands()))
    m, d = x.shape
    f = w1t.shape[0] // MP
    seen = []
    bf, f32 = torch.bfloat16, torch.float32

    def fwd_products(xp, w1p, b1p, w2p, b2p, hp, op, m_, d_, f_, stream):
        xs, w1s, b1s, w2s = (tensor_at(xp, (m_, d_), bf),
                             tensor_at(w1p, (f_, d_), bf),
                             tensor_at(b1p, (f_,), f32),
                             tensor_at(w2p, (d_, f_), bf))
        seen.append(("b2", tensor_at(b2p, (d_,), f32).abs().max().item()))
        tensor_at(op, (m_, d_), f32).copy_(
            ffn.ffn_partial_reference(xs, w1s, b1s, w2s))
        return 0

    def fwd_rows(xp, op, gp, bp, seed, yp, m_, d_, eps, thr, inv, drop,
                 row0, stream):
        seen.append(("row0", row0, drop))
        tensor_at(yp, (m_, d_), bf).copy_(ffn.ffn_rows_reference(
            tensor_at(op, (m_, d_), f32), tensor_at(xp, (m_, d_), bf),
            torch.zeros(d_), tensor_at(gp, (d_,), f32),
            tensor_at(bp, (d_,), f32)))
        return 0

    def bwd_rows(xp, gp, seed, dyp, dop, drp, part, dgb, m_, d_, eps, thr,
                 inv, drop, row0, stream):
        dr_buf = tensor_at(drp, (m_, d_), f32)
        dr, do, dg, db = ffn.ffn_rows_backward_reference(
            dr_buf.clone(), tensor_at(xp, (m_, d_), bf),
            tensor_at(gp, (d_,), f32), 0.0, None,
            tensor_at(dyp, (m_, d_), bf))
        dr_buf.copy_(dr)
        tensor_at(dop, (m_, d_), bf).copy_(do)
        tensor_at(dgb, (2 * d_,), f32).copy_(torch.cat([dg, db]))
        return 0

    def bwd_products(xp, w1p, b1p, w2p, dop, drp, dxp, dup, hp, gdp, m_, d_,
                     f_, stream):
        seen.append(("dr", tensor_at(drp, (m_, d_), f32).abs().max().item()))
        dx, du, h = ffn.ffn_products_backward_reference(
            tensor_at(xp, (m_, d_), bf), tensor_at(w1p, (f_, d_), bf),
            tensor_at(b1p, (f_,), f32), tensor_at(w2p, (d_, f_), bf),
            tensor_at(dop, (m_, d_), bf))
        tensor_at(dxp, (m_, d_), bf).copy_(dx)
        tensor_at(dup, (m_, f_), bf).copy_(du)
        tensor_at(hp, (m_, f_), bf).copy_(h)
        return 0

    monkeypatch.setattr(ffn, "_train_lib", lambda: SimpleNamespace(
        shgvqa_ffn_train_fwd_products_bf16=fwd_products,
        shgvqa_ffn_train_fwd_rows_bf16=fwd_rows,
        shgvqa_ffn_train_bwd_rows_bf16=bwd_rows,
        shgvqa_ffn_train_bwd_products_bf16=bwd_products,
        shgvqa_ffn_train_max_d=lambda: 768,
        shgvqa_ffn_train_bwd_rows=lambda: 16))
    monkeypatch.setattr(ffn, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    # the model group of two, by hand: rank i's partial is kept, and the
    # reduce adds the other rank's, whose products run here too
    others = []

    def reduce(o):
        return o + others.pop()

    monkeypatch.setattr(distributed, "reduce_from_model", reduce)
    params = [t.clone().requires_grad_() for t in
              (x, w1t, b1, w2t, b2, gamma, beta)]
    xg, w1g, b1g, w2g, b2g, gg, bg = params
    launches = (ffn.fused_ffn_train.launches,
                ffn.fused_ffn_train.bwd_launches)
    with torch.no_grad():
        others.append(ffn._FFNProducts.apply(
            x, w1t[f:].contiguous(), b1[f:].contiguous(),
            w2t[:, f:].contiguous(), "fused_ffn_train"))
    y = ffn._card_ffn_split(xg, xg, w1g[:f], b1g[:f], w2g[:, :f], b2g, gg,
                            bg, 0.0, None, 1e-12, 6, "fused_ffn_train")
    want_params = [t.detach().float().clone().requires_grad_()
                   for t in (x, w1t, b1, w2t, b2, gamma, beta)]
    want = ffn.ffn_train_reference(*want_params)
    torch.testing.assert_close(y.float(), want.float(), rtol=2e-2, atol=2e-2)
    dy = torch.randn(m, d).to(bf)
    y.backward(dy)
    want.backward(dy.float())
    # rank 0's gradients: its slices of W1, b1, W2; dr plus its partial dx
    for got, ref, sl in ((w1g.grad[:f], want_params[1].grad[:f], None),
                         (b2g.grad, want_params[4].grad, None),
                         (gg.grad, want_params[5].grad, None)):
        torch.testing.assert_close(got.float(), ref, rtol=3e-2, atol=3e-2)
    assert not w1g.grad[f:].any()
    assert (ffn.fused_ffn_train.launches - launches[0],
            ffn.fused_ffn_train.bwd_launches - launches[1]) == (1, 1)
    assert ("b2", 0.0) in seen and ("dr", 0.0) in seen
    assert ("row0", 6, 0) in seen


def test_attention_card_path_passes_the_ranks_heads(monkeypatch):
    """``fused_attention``'s card path at a rank's heads hands the C
    entries ``group0`` = its first row x Hg, ``Hg`` and ``head0``; one
    process hands (first row x H, H, 0), the counter of before."""
    from shgvqa_tpu_torch.kernels import attention
    from test_torch_common import tensor_at

    calls = []

    def fwd(q, k, v, key, pane, seed, o, lse, strides, b, h, lq, lk, scale,
            thr, inv, drop, group0, hg, head0, stream):
        calls.append(("fwd", group0, hg, head0))
        tensor_at(o, (b, lq, h, 64), torch.bfloat16).zero_()
        tensor_at(lse, (b * h, lq), torch.float32).zero_()
        return 0

    def bwd(q, k, v, key, pane, seed, o, lse, do, delta, dq_acc, dq, dk, dv,
            strides, b, h, lq, lk, scale, thr, inv, drop, group0, hg, head0,
            stream):
        calls.append(("bwd", group0, hg, head0))
        for ptr, n in ((dq, lq), (dk, lk), (dv, lk)):
            tensor_at(ptr, (b, n, h, 64), torch.bfloat16).zero_()
        return 0

    monkeypatch.setattr(attention, "_lib", lambda: SimpleNamespace(
        shgvqa_attention_fwd_bf16=fwd, shgvqa_attention_bwd_bf16=bwd))
    monkeypatch.setattr(attention, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(attention, "draw_seed",
                        lambda g, dev: torch.zeros(2, dtype=torch.int64))
    q, k, v = (torch.randn(2, 6, 5, 64, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    for heads, first, want in (((6, 12), 4, (48, 12, 6)),
                               (None, 4, (24, 6, 0))):
        calls.clear()
        out = attention._card_attention(q, k, v, None, None, 0.1, None,
                                        first, heads)
        out.float().sum().backward()
        assert calls == [("fwd", *want), ("bwd", *want)]


# -- the spawned worlds against one process ----------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_tp_steps_with_dropout_and_augmentation_match_one_process(
        spawns, one_process, world):
    """Video model, trunk trained, RandAugment, dropout 0.1, the FFN train
    path split at its all-reduce, at dp1 x mp2 and dp2 x mp2: every rank's
    losses and gathered parameters are the one-process run's on the global
    batch (the masks are the one-process masks' rows and heads); the
    gathered parameters are bit-equal across ranks; every step issues the
    same model collectives on every rank."""
    ref = one_process["video"]
    ranks = [spawns[world].steps(r) for r in range(world)]
    for r in ranks:
        check_losses(r["video"], ref)
        check_updates(r["video"], ref)
        for name, p in r["video"]["params"].items():
            assert torch.equal(p, ranks[0]["video"]["params"][name]), name
        assert r["video"]["collectives"] == ranks[0]["video"]["collectives"]
    steps = ranks[0]["video"]["collectives"]
    assert all(s == steps[0] for s in steps)
    assert all(n > 0 for n in steps[0].values()), steps[0]


def test_tp_normalizers_and_clip_match_one_process_and_world_ones_do_not(
        spawns, one_process):
    """The head model at dropout 0 on a batch whose rows hold different
    counts of weighted targets, at mp2: with the normalizers over the data
    group and the clip's norm over the whole model, the steps (losses, the
    gradient norm, the updates) are one process's; normalizers summed over
    the whole world are off by the factor mp at the first step, and a clip
    norm of the rank's shards only falls short of the gradient norm."""
    ref = one_process["head"]
    for r in range(2):
        got = spawns[2].steps(r)
        check_losses(got["head"], ref)
        check_updates(got["head"], ref)
    world = spawns[2].steps(0)["head_world_norm"]
    first, want = world["metrics"][0], ref["metrics"][0]
    for key in ("rel_loss", "act_loss", "hgqa_loss"):
        np.testing.assert_allclose(first[key] * MP, want[key], rtol=1e-5,
                                   err_msg=key)
    with pytest.raises(AssertionError):
        check_losses(world, ref)
    for r in range(2):
        own = spawns[2].steps(r)["head_rank_clip"]["metrics"][0]
        assert own["grad_norm"] < want["grad_norm"] - 1e-2, r


def test_tp_remat_step_gives_the_gradients_without_it(spawns):
    """One head-model step at dropout 0.1 at mp2 under ``--remat`` (the
    recompute issues the forward's collectives again): the gathered
    gradients of the step without it."""
    for r in range(2):
        plain, remat = spawns[2].steps(r)["remat"]
        assert plain.keys() == remat.keys() and plain
        for name in plain:
            torch.testing.assert_close(remat[name], plain[name], rtol=1e-6,
                                       atol=1e-7, msg=name)


def test_tp_star_step_matches_one_process(spawns):
    """One STAR step (the global matcher, the hg mask, dropout 0.1) at mp2:
    every metric within 1e-5 of one process's."""
    with one_thread():
        want = star_step()
    for r in range(2):
        got = spawns[2].steps(r)["star"]
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)


def test_tp_attention_dumps_are_one_process_maps(spawns):
    """``--outputAttn``'s forward at mp2: every probability map (the
    heads gathered) and hg_logit one process's, within 1e-6."""
    with one_thread():
        want = dumps_forward()
    assert len(want) >= 5
    for r in range(2):
        got = spawns[2].steps(r)["dumps"]
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_tp_checkpoints_load_in_one_process_and_back(spawns, one_process,
                                                     files):
    """Weights in and out at mp2: the checkpoint saved after the head
    steps loads strictly into a one-process model, its parameters and
    moments the gathered ones (and one process's by the update rule); a
    one-process checkpoint loads at mp2 and gathers back bit-equal; a
    ``--loadLXMERTQA`` snapshot loads at mp2 as in one process, bit for
    bit, with the same answers initialized and zeroed."""
    from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel

    head = spawns[2].steps(0)["head"]
    saved = torch.load(os.path.join(spawns[2].out, "tp_ckpt"),
                       weights_only=True)
    model = ShgVqaModel(dpt._cfg("head"))
    model.load_state_dict(saved["params"], strict=True)
    for name, p in head["params"].items():
        assert torch.equal(saved["params"][name], p), name
    assert saved["step"] == STEPS
    moments = dict(zip(head["moments"], saved["opt_state"]["m"]))
    for name, m in head["moments"].items():
        assert torch.equal(moments[name], m), name
    check_updates({"params": saved["params"]}, one_process["head"])

    one = torch.load(files["ckpt"], weights_only=True)
    with one_thread():
        want = load_files(files)
    for r in range(2):
        loads = spawns[2].steps(r)["loads"]
        got = loads["ckpt"]
        assert got["step"] == one["step"] == 3
        for k, v in one["params"].items():
            assert torch.equal(got["params"][k], v), k
        for k in ("m", "v"):
            assert len(got["opt_state"][k]) == len(one["opt_state"][k])
            for a, b in zip(got["opt_state"][k], one["opt_state"][k]):
                assert torch.equal(a, b)
        assert loads["qa"] == want["qa"] and want["qa"][0] > 0
        for k, v in want["snap"].items():
            assert torch.equal(loads["snap"][k], v), k


def test_tp_driver_reproduces_one_process(spawns, tmp_path):
    """``agqa_hgqa --dataParallel 2 --modelParallel 2`` as four ranks under
    the SHGVQA_* variables against one process: the same steps, per-epoch
    valid and hg scores within 1e-9, then ``--test`` from its LAST the
    same scores as ``--test`` from the one-process LAST, the predict files
    written by model index 0 of each data index; LAST, written once by
    rank 0, loads into a one-process model."""
    from shgvqa_tpu_torch.cli import common
    from shgvqa_tpu_torch.models import shgvqa

    saved = (common.parse_reference_flags_with_extras, shgvqa.make_backbone)
    try:
        with one_thread():
            dpt._shrink_driver()
            ref = dpt.run_driver(tmp_path / "one", *SMALL)
            ref_test = run_test(tmp_path / "one_test", tmp_path / "one", SMALL
                                + ["--test", "test", "--load",
                                   str(tmp_path / "one" / "LAST")])
        got = [spawns[4].json(f"driver0_{r}.json") for r in range(4)]
        tests = [spawns[4].json(f"driver1_{r}.json") for r in range(4)]
        assert all(g == got[0] for g in got)
        assert all(t == tests[0] for t in tests)
        assert got[0]["steps"] == ref["steps"] == 12
        assert len(got[0]["history"]) == len(ref["history"]) == 2
        for h, w in zip(got[0]["history"], ref["history"]):
            assert h["valid"] == pytest.approx(w["valid"], abs=1e-9)
            assert h["hg"] == pytest.approx(w["hg"], abs=1e-9)
        assert tests[0].keys() == ref_test.keys() == {"all_qtypes",
                                                      "hg_all_qtypes"}
        for key, scores in ref_test.items():
            assert tests[0][key] == pytest.approx(scores, abs=1e-9), key
        test_out = os.path.join(spawns[4].out, "test")
        # the predict files from model index 0 of each data index
        for sub, written in (("", True), ("proc1", False), ("proc2", True),
                             ("proc3", False)):
            assert os.path.exists(os.path.join(test_out, sub,
                                               "predict.json")) == written
        last = torch.load(os.path.join(spawns[4].out, "driver", "LAST"),
                          weights_only=True)
        one = torch.load(tmp_path / "one" / "LAST", weights_only=True)
        assert last["step"] == one["step"] == 12
        assert {k: v.shape for k, v in last["params"].items()} == {
            k: v.shape for k, v in one["params"].items()}
    finally:
        (common.parse_reference_flags_with_extras,
         shgvqa.make_backbone) = saved

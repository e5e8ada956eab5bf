"""``--stepsPerLoop k`` in the port (``train/graph.py``, ``Trainer.train``)
on the CPU, where every chunk runs the graph's body eagerly through the
same staging: k=2 against k=1 (3 steps an epoch: one chunk and a trailing
single step; 2 epochs) bit-equal in parameters, moments, step count and
per-step losses with the trunk trained, RandAugment and dropout on, the
augmentation's fixed-capacity path (at B=2 its select tree) giving the
sub-batch path's bits; the same run
at dropout 0 without augmentation against the JAX ``Trainer`` at k=2 in
flat mode; ``BertAdam.step(lr=<tensor>)`` against the host's learning
rate and the JAX optimizer; the chunk body making no host read; ``--optim
adam`` running single steps; and the parameters' and moments' addresses
kept by every weight load (a captured graph holds them)."""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data.pipeline import Batcher as JaxBatcher
from shgvqa_tpu.kernels import attention as pallas_attn
from shgvqa_tpu.kernels import ffn as pallas_ffn
from shgvqa_tpu.train import optimizer as jax_opt
from shgvqa_tpu.train.loop import Trainer as JaxTrainer
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.entry import build_model, example_batch
from shgvqa_tpu_torch.models import layers, shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.train import graph, optimizer
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.step import trainable_mask
from shgvqa_tpu_torch.utils import convert_slow_r50
from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize
from test_torch_common import TOY, close, t
from test_torch_optimizer import MASK, SHAPES, _Params
from test_torch_reference_writer import (
    R50_TOY,
    bert_state_dict,
    pytorchvideo_state_dict,
    reference_state_dict,
    save_torch,
)

STEPS_PER_EPOCH = 3
# the JAX test of the same run (tests/test_flat_state.py:315-347)
RTOL, ATOL = 2e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _video_trainer(tmp_path, monkeypatch, k, published=True, trunk=TOY,
                   **optim):
    """A Trainer of the tiny video model at --stepsPerLoop ``k``: the
    published recipe (the trunk trained, RandAugment) or the trunk frozen
    without augmentation; losses logged every step."""
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **trunk))
    cfg = tiny_test_config(task="hgqa", output=str(tmp_path), log_freq=1,
                           steps_per_loop=k, freeze_backbone=not published)
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, augment_type="rand_aug" if published else "no_aug"),
        optim=dataclasses.replace(cfg.optim, **optim))
    model = build_model(cfg, "cpu", seed=0)
    return Trainer(cfg, STEPS_PER_EPOCH, model, trainable_mask(model, cfg))


def _frames_batches(cfg, n=STEPS_PER_EPOCH):
    out = []
    for seed in range(n):
        batch = example_batch(cfg, 2, seed, with_labels=True)
        batch.pop("visual_mask")
        d = cfg.data
        batch["frames"] = np.random.RandomState(10 + seed).randint(
            0, 255, (2, cfg.encoder.visual_t + 8, d.image_size,
                     d.image_size, 3)).astype(np.uint8)
        batch = {key: torch.as_tensor(v) for key, v in batch.items()}
        batch.update(ques_id=["a", "b"], n_valid=2)
        out.append(batch)
    return out


def _losses(out_dir):
    return [json.loads(line)["total_loss"]
            for line in (out_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def published_runs(tmp_path_factory):
    """The published recipe at k=1 and k=2, 2 epochs of 3 steps each, with
    the trunk's input of every step and the augmentation's path it took."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in (1, 2):
            out = tmp_path_factory.mktemp(f"k{k}")
            trainer = _video_trainer(out, mp, k)
            inputs, paths = [], []

            def record(_m, args, model=trainer.model):
                inputs.append(args[0].detach().clone())
                paths.append(model.aug_path)

            trainer.model.backbone.register_forward_pre_hook(record)
            batches = _frames_batches(trainer.model.cfg)
            summary = trainer.train(lambda epoch: iter(batches))
            runs[k] = dict(trainer=trainer, summary=summary, inputs=inputs,
                           paths=paths, losses=_losses(out),
                           log=(out / "log.log").read_text())
    return runs


def test_two_steps_a_launch_are_bit_equal_to_single_steps(published_runs):
    one, two = published_runs[1], published_runs[2]
    assert one["summary"]["steps"] == two["summary"]["steps"] == 6
    assert two["trainer"].chunks is not None
    assert one["trainer"].chunks is None
    assert len(two["losses"]) == 6 and two["losses"] == one["losses"]
    opt1, opt2 = one["trainer"].optimizer, two["trainer"].optimizer
    assert opt1.step_count == opt2.step_count == 6
    for kind in ("params", "m", "v"):
        for a, b in zip(getattr(opt1, kind), getattr(opt2, kind)):
            assert torch.equal(a, b), kind
    assert not any(torch.equal(a, b) for a, b in zip(
        opt2.params, build_model(two["trainer"].model.cfg, "cpu",
                                 seed=0).parameters()))


def test_the_select_tree_gives_the_sub_batch_bits_in_the_chunk(
        published_runs):
    """k=2 runs a chunk's steps on the augmentation's fixed-capacity path
    (no host read, static shapes; at B=2 every capacity is the batch, so it
    is the full-batch select tree) and the trailing single step on the
    sub-batch path, as k=1 runs every step.  The trunk gets the same bits
    and the same (contiguous) layout at every step."""
    one, two = published_runs[1], published_runs[2]
    assert one["trainer"].model.cfg.data.aug_subbatch
    assert two["trainer"].model.cfg.data.aug_subbatch
    assert one["paths"] == ["subbatch"] * 6
    # each epoch: one chunk of two steps, then a trailing single step
    assert two["paths"] == ["capacity", "capacity", "subbatch"] * 2
    assert two["trainer"].model.aug_path == "subbatch"
    assert len(one["inputs"]) == len(two["inputs"]) == 6
    for a, b in zip(one["inputs"], two["inputs"]):
        assert torch.equal(a, b) and a.stride() == b.stride()


# -- against the JAX Trainer ------------------------------------------------

@contextlib.contextmanager
def _jax_trainer_without_dropout(cfg):
    """A JAX Trainer (flat mode) with flax's Dropout the identity while it
    traces (the relation queries' HGEmbeddings drops at a fixed 0.1 that no
    config field reaches); the Pallas switches it sets are put back."""
    flags = (pallas_attn._ENABLED, pallas_attn._TRAIN_ENABLED,
             pallas_ffn._ENABLED, pallas_ffn._TRAIN_ENABLED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHGVQA_FLAT_STATE", "1")
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        try:
            yield JaxTrainer(cfg, steps_per_epoch=STEPS_PER_EPOCH)
        finally:
            (pallas_attn._ENABLED, pallas_attn._TRAIN_ENABLED,
             pallas_ffn._ENABLED, pallas_ffn._TRAIN_ENABLED) = flags


def test_two_steps_a_launch_match_the_jax_trainer(tmp_path):
    """Dropout 0, visual features in: the port's Trainer at k=2 from the
    JAX Trainer's initial weights (through ``convert.py``) against the JAX
    Trainer at k=2 in flat mode, within the JAX k=2 test's own tolerance:
    every per-step loss, and every parameter tensor after 2 epochs in norm
    (``||port - jax|| <= RTOL ||jax|| + ATOL sqrt(n)``).  Elementwise, two
    of the 215k values (an embedding row and a bias, whose gradients are
    sums in another order in each package) exceed it by up to 1.4x after
    six BertAdam steps: f32 rounding that Adam's m / sqrt(v) carries."""
    from tests.test_train_loop import _make_items

    jcfg = jax_tiny(task="hgqa", steps_per_loop=2, log_freq=1,
                    output=str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    items = _make_items(jcfg, n=2 * STEPS_PER_EPOCH)
    batcher = JaxBatcher(items, batch_size=2, shuffle=False, seed=0)
    with _jax_trainer_without_dropout(jcfg) as jtr:
        first = {k: v for k, v in next(batcher.epoch(0)).items()
                 if k not in ("ques_id", "n_valid")}
        jtr.init_params(first)
        assert jtr.flat_mode
        init = jax.device_get(jtr.params)
        jtr.train(lambda epoch: batcher.epoch(epoch))
        jtr._sync_params_from_flat()
        want = from_jax_variables(jax.device_get(jtr.params))

    pcfg = tiny_test_config(task="hgqa", steps_per_loop=2, log_freq=1,
                            output=str(tmp_path / "port"))
    model = ShgVqaModel(pcfg)
    model.load_state_dict(from_jax_variables(init, model), strict=True)
    layers.set_dropout_rate(model, 0.0)
    trainer = Trainer(pcfg, STEPS_PER_EPOCH, model)

    def batches(epoch):
        for batch in batcher.epoch(epoch):
            yield {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in batch.items()}

    trainer.train(batches)
    assert trainer.chunks is not None and trainer.step == 6
    np.testing.assert_allclose(_losses(tmp_path / "port"),
                               _losses(tmp_path / "jax"), rtol=RTOL)
    got = dict(model.named_parameters())
    assert got.keys() <= want.keys()
    for name, p in got.items():
        err = (p.detach() - want[name]).norm().item()
        bound = RTOL * want[name].norm().item() + ATOL * p.numel() ** 0.5
        assert err <= bound, (name, err, bound)


# -- the optimizer's learning rate as a device tensor -----------------------

def test_bert_adam_with_an_lr_tensor_is_the_host_lr_path():
    """``step(lr=<f32 tensor>)``, the graph's form, against ``step()``, the
    host's ``lr_at``: bit-equal over three steps (warmup, clip idle and
    active), and within the JAX optimizer parity test's 1e-6."""
    rng = np.random.RandomState(0)
    values = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for scale in (0.3, 10.0, 0.8)]
    kw = dict(lr=1e-2, t_total=10, warmup=0.1, schedule="warmup_linear",
              weight_decay=0.01, grad_clip=5.0)
    tx = jax_opt.make_optimizer(trainable_mask=MASK, **kw)
    jparams = {k: jnp.asarray(v) for k, v in values.items()}
    state = tx.init(jparams)
    models = [_Params(values), _Params(values)]
    host, device = (optimizer.make_optimizer(m, trainable_mask=MASK, **kw)
                    for m in models)
    lrs = torch.tensor([host.lr_at(i) for i in range(3)],
                       dtype=torch.float32)
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for model in models:
            for name, p in model.named_parameters():
                p.grad = t(g[name])
        host.step()
        device.step(lrs[i])
        for kind in ("params", "m", "v"):
            for a, b in zip(getattr(host, kind), getattr(device, kind)):
                assert torch.equal(a, b), (i, kind)
        for name, p in models[1].named_parameters():
            close(p, jparams[name], 1e-6)
    assert host.step_count == device.step_count == 3


# -- capture safety ------------------------------------------------------------

def _refuse(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"the chunk body called {name}")
    return refuse


@contextlib.contextmanager
def _no_host_reads():
    """Every way a step could read a device value on the host, or make a
    tensor from host values, raises."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                     "__float__"):
            mp.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
        mp.setattr(torch, "tensor", _refuse("torch.tensor"))
        yield


def test_the_chunk_body_makes_no_host_read(tmp_path, monkeypatch):
    """The published recipe (a trained toy trunk, RandAugment through the
    fixed-capacity path, dropout on): after the first chunk, which on a card is the
    warm-up before capture, the chunk body runs with every host read
    refused."""
    trainer = _video_trainer(tmp_path, monkeypatch, 2, epochs=1)
    body, guarded, paths = graph.StepChunks._body, [], []

    def checked(self):
        paths.append(self.model.aug_path)
        if not guarded:
            guarded.append(False)
            return body(self)
        guarded.append(True)
        with _no_host_reads():
            return body(self)

    monkeypatch.setattr(graph.StepChunks, "_body", checked)
    batches = _frames_batches(trainer.model.cfg, 4)
    trainer.train(lambda epoch: iter(batches))
    assert guarded == [False, True] and trainer.step == 4
    assert paths == ["capacity", "capacity"]


def test_optimizers_other_than_bert_adam_train_single_steps(tmp_path,
                                                            monkeypatch):
    """``--optim adam`` with k=2: as in JAX, where the chunks need the flat
    state only BertAdam has, the flag has no effect; one line says so."""
    trainer = _video_trainer(tmp_path, monkeypatch, 2, optim="adam",
                             epochs=1)
    batches = _frames_batches(trainer.model.cfg)
    trainer.train(lambda epoch: iter(batches))
    assert trainer.chunks is None and trainer.step == 3
    assert trainer.model.aug_path == "subbatch"
    assert ("--stepsPerLoop 2 has no effect with --optim adam"
            in (tmp_path / "log.log").read_text())


# -- the graph's addresses ------------------------------------------------------

def test_weight_loads_keep_the_addresses_a_graph_holds(tmp_path,
                                                      monkeypatch):
    """A captured graph reads the parameters and moments at the addresses
    it was captured with: ``_reset_opt``, ``load`` of a checkpoint and the
    three imports (trunk, BERT, reference ``.pth``) all copy in place."""
    trainer = _video_trainer(tmp_path, monkeypatch, 2, trunk=R50_TOY)
    opt = trainer.optimizer

    def addresses():
        return [p.data_ptr() for p in opt.params + opt.m + opt.v]

    before = addresses()
    model = trainer.model
    tree = to_jax_variables(model.backbone.state_dict())
    trunk = tmp_path / "slow_r50_flax.msgpack"
    trunk.write_bytes(msgpack_serialize(convert_slow_r50.convert(
        pytorchvideo_state_dict(tree["params"], tree["batch_stats"]))))
    bert = tmp_path / "pytorch_model.bin"
    save_torch(bert_state_dict(
        to_jax_variables(model.head.lxrt.state_dict())["params"]), bert)
    reference = tmp_path / "BEST.pth"
    save_torch(reference_state_dict(to_jax_variables(model.state_dict()),
                                    model.cfg), reference)
    trainer.ckpt.save("LAST", trainer.state_dict())
    loads = {"_reset_opt": trainer._reset_opt,
             "load": lambda: trainer.load("LAST"),
             "load_backbone": lambda: trainer.load_backbone(str(trunk)),
             "load_bert_pretrained":
                 lambda: trainer.load_bert_pretrained(str(bert)),
             "load_reference": lambda: trainer.load_reference(str(reference))}
    for name, load in loads.items():
        load()
        assert addresses() == before, name

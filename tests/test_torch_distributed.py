"""The port's data-parallel pieces in one process, against the JAX package
where it has them (``shgvqa_tpu/parallel/distributed.py``,
``shgvqa_tpu/data/pipeline.py``, ``shgvqa_tpu/cli/common.py``):

- ``process_batch_slice`` and ``pad_to_multiple``: the same slices, sizes
  and errors;
- the driver's layout policy (``cli/common.build_driver_mesh``): the JAX
  function's decisions for the same flags over the conftest's 8 devices
  (``tests/test_cli_mesh.py::test_build_driver_mesh_policies`` is the
  oracle), data-parallel and dp x mp layouts alike;
- ``Batcher(host_shard=...)``: every rank's rows and ``n_valid`` equal to
  the JAX batcher's, a padded trailing batch included;
- the random draws of a rank: the dropout module, the CPU paths of both
  dropout kernels and both kernels' plain keep masks at an offset are the
  global draw's rows;
- the refusal of ``--stepsPerLoop`` > 1 under a gloo group on a CUDA
  device (the guard, on a stand-in optimizer).

The multi-process runs are in ``tests/test_torch_data_parallel.py``."""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from shgvqa_tpu.cli.common import build_driver_mesh as jax_build_driver_mesh
from shgvqa_tpu.configs import config as jax_config
from shgvqa_tpu.data.pipeline import Batcher as JaxBatcher
from shgvqa_tpu.parallel import distributed as jax_dist
from shgvqa_tpu_torch.cli import common
from shgvqa_tpu_torch.configs import config as port_config
from shgvqa_tpu_torch.data.pipeline import Batcher
from shgvqa_tpu_torch.kernels import attention, ffn
from shgvqa_tpu_torch.models import layers
from shgvqa_tpu_torch.parallel import distributed, mesh
from shgvqa_tpu_torch.train import graph


@pytest.mark.parametrize("size,index,count", [
    (32, 2, 4), (32, 0, 4), (8, 1, 2), (6, 5, 6), (12, 0, 1)])
def test_process_batch_slice_matches_jax(size, index, count):
    assert (distributed.process_batch_slice(size, index, count)
            == jax_dist.process_batch_slice(size, index, count))


def test_batch_slice_refusal_and_padding_match_jax():
    for fn in (distributed.process_batch_slice,
               jax_dist.process_batch_slice):
        with pytest.raises(ValueError, match="not divisible"):
            fn(32, 1, 3)
    for size, n in ((32, 3), (33, 3), (7, 4), (8, 8), (1, 2)):
        assert (distributed.pad_to_multiple(size, n)
                == jax_dist.pad_to_multiple(size, n))


def _cfgs(module, mesh_kw, batch_size, eval_batch_size):
    cfg = module.tiny_test_config(mesh=module.MeshConfig(**mesh_kw))
    return cfg.replace(optim=dataclasses.replace(
        cfg.optim, batch_size=batch_size, eval_batch_size=eval_batch_size))


@pytest.mark.parametrize("mesh_kw,extras,batch,eval_batch", [
    ({}, {}, 8, 2),                                   # no flag: no mesh
    ({}, {"multi_gpu": True}, 8, 2),                  # every device
    ({}, {"multi_gpu": True}, 16, 8),
    ({"data_parallel": 4}, {}, 8, 6),                 # eval batch rounded up
    ({"data_parallel": 2}, {}, 4, 4),
    ({"data_parallel": 16}, {}, 16, 2),               # too large: one device
    ({"data_parallel": 1}, {"multi_gpu": True}, 8, 2),
    ({"data_parallel": 3}, {}, 8, 2),                 # batch not divisible
], ids=["none", "multiGPU", "multiGPU_b16", "dp4_eval6", "dp2", "dp16",
        "dp1_multiGPU", "dp3_indivisible"])
def test_build_driver_mesh_decides_as_jax(mesh_kw, extras, batch,
                                          eval_batch):
    """The port's policy over 8 devices against the JAX function over the
    conftest's 8 CPU devices: the layout (or none), the mesh config and
    the eval batch it leaves, or the same SystemExit."""
    assert jax.device_count() == 8
    jcfg = _cfgs(jax_config, mesh_kw, batch, eval_batch)
    pcfg = _cfgs(port_config, mesh_kw, batch, eval_batch)
    try:
        jmesh, jcfg2 = jax_build_driver_mesh(jcfg, dict(extras))
    except SystemExit as e:
        with pytest.raises(SystemExit, match="not divisible"):
            common.build_driver_mesh(pcfg, dict(extras), 8)
        assert "not divisible" in str(e)
        return
    pmesh, pcfg2 = common.build_driver_mesh(pcfg, dict(extras), 8)
    assert (pmesh is None) == (jmesh is None)
    if jmesh is not None:
        assert pmesh.shape == dict(jmesh.shape)
    assert dataclasses.asdict(pcfg2.mesh) == dataclasses.asdict(jcfg2.mesh)
    assert pcfg2.optim.eval_batch_size == jcfg2.optim.eval_batch_size
    assert pcfg2.optim.batch_size == jcfg2.optim.batch_size


# dp x mp layouts: (mesh config, batch, eval batch)
TP_LAYOUTS = (
    ({"data_parallel": 2, "model_parallel": 2}, 4, 4),
    ({"data_parallel": 4, "model_parallel": 2}, 8, 6),   # eval rounded to 4
    ({"data_parallel": -1, "model_parallel": 2}, 8, 2),  # dp = 8 / 2
    ({"data_parallel": 16, "model_parallel": 2}, 16, 2),  # too large
    ({"data_parallel": 1, "model_parallel": 8}, 8, 2),
    ({"data_parallel": 3, "model_parallel": 2}, 8, 2),   # batch indivisible
)


def test_tensor_parallelism_is_refused_with_its_roadmap_position():
    """(The name is kept from when the port refused ``--modelParallel``.)
    Tensor-parallel layouts are no longer refused: ``make_mesh`` and the
    driver's ``build_driver_mesh`` take dp x mp as JAX's do
    (``tests/test_cli_mesh.py::test_build_driver_mesh_policies``): for each
    of ``TP_LAYOUTS`` the layout, the mesh config and the eval batch it
    leaves over 8 devices, or the same SystemExit; ``make_mesh`` covers the
    devices or raises."""
    assert jax.device_count() == 8
    for mesh_kw, batch, eval_batch in TP_LAYOUTS:
        jcfg = _cfgs(jax_config, mesh_kw, batch, eval_batch)
        pcfg = _cfgs(port_config, mesh_kw, batch, eval_batch)
        try:
            jmesh, jcfg2 = jax_build_driver_mesh(jcfg, {})
        except SystemExit as e:
            with pytest.raises(SystemExit, match="not divisible"):
                common.build_driver_mesh(pcfg, {}, 8)
            assert "not divisible" in str(e)
            continue
        pmesh, pcfg2 = common.build_driver_mesh(pcfg, {}, 8)
        assert (pmesh is None) == (jmesh is None), mesh_kw
        if jmesh is not None:
            assert pmesh.shape == dict(jmesh.shape)
            assert mesh.make_mesh(pcfg2.mesh,
                                  pmesh.data * pmesh.model) == pmesh
        assert dataclasses.asdict(pcfg2.mesh) == dataclasses.asdict(
            jcfg2.mesh), mesh_kw
        assert pcfg2.optim.eval_batch_size == jcfg2.optim.eval_batch_size
    assert mesh.make_mesh(port_config.MeshConfig(), 4) == mesh.Mesh(4, 1)
    assert mesh.make_mesh(port_config.MeshConfig(model_parallel=2),
                          4) == mesh.Mesh(2, 2)
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_mesh(port_config.MeshConfig(data_parallel=3,
                                              model_parallel=2), 4)


def _items(n):
    rng = np.random.RandomState(n)
    return [{"x": rng.randn(3).astype(np.float32),
             "label": np.int32(i), "ques_id": f"q{i}"} for i in range(n)]


@pytest.mark.parametrize("n_items,batch,count,shuffle", [
    (10, 4, 2, True), (10, 4, 4, False), (9, 6, 3, True), (8, 4, 2, True)])
def test_host_shard_batcher_rows_match_jax(n_items, batch, count, shuffle):
    """Every rank's batches (a trailing one padded globally, then sliced)
    and their n_valid, against the JAX batcher, epochs 0 and 1; the ranks'
    rows together are the one-process batches."""
    items = _items(n_items)
    whole = Batcher(items, batch_size=batch, shuffle=shuffle, seed=5)
    for epoch in (0, 1):
        ranks = []
        for index in range(count):
            kw = dict(batch_size=batch, shuffle=shuffle, seed=5,
                      host_shard=(index, count))
            got = list(Batcher(items, **kw).epoch(epoch))
            want = list(JaxBatcher(items, **kw).epoch(epoch))
            assert len(got) == len(want) == len(whole)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    if isinstance(g[k], np.ndarray):
                        np.testing.assert_array_equal(g[k], w[k])
                    else:
                        assert g[k] == w[k], k
            ranks.append(got)
        for i, one in enumerate(whole.epoch(epoch)):
            parts = [r[i] for r in ranks]
            np.testing.assert_array_equal(
                np.concatenate([p["x"] for p in parts]), one["x"])
            assert sum(p["n_valid"] for p in parts) == one["n_valid"]
            assert sum((p["ques_id"] for p in parts), []) == one["ques_id"]
        # the global view of a sharded batcher is the one-process batcher
        first = next(Batcher(items, batch_size=batch, shuffle=shuffle,
                             seed=5, host_shard=(1, count)).epoch(
                                 epoch, sharded=False))
        np.testing.assert_array_equal(first["x"],
                                      next(whole.epoch(epoch))["x"])


def test_shard_batch_takes_the_ranks_rows():
    batch = {"x": np.arange(12).reshape(6, 2), "ids": list("abcdef"),
             "t": torch.arange(6), "n_valid": 6}
    got = mesh.shard_batch(batch, 1, 3)
    np.testing.assert_array_equal(got["x"], [[4, 5], [6, 7]])
    assert got["ids"] == ["c", "d"] and got["t"].tolist() == [2, 3]
    assert got["n_valid"] == 6


@pytest.fixture
def rank_1_of_3(monkeypatch):
    """This process seen as rank 1 of 3 (no process group needed for the
    draws)."""
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    monkeypatch.setattr(distributed, "world_size", lambda: 3)


def test_dropout_draws_the_global_mask_and_keeps_its_rows(rank_1_of_3):
    drop = layers.Dropout(0.3).train()
    x = torch.ones(2, 5, 4)
    got = drop(x, torch.Generator().manual_seed(4))
    keep = torch.rand((6, 5, 4), generator=torch.Generator().manual_seed(4))
    want = torch.where(keep[2:4] >= 0.3, 1.0 / 0.7, 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _rows_of_global(fn, make, rows, first, total, monkeypatch):
    """fn on this rank's rows (rank 1 of 3) against fn on the global
    tensors (one process) at the same generator seed, sliced."""
    whole = fn(*make(total), torch.Generator().manual_seed(9))
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    part = fn(*[a[first:first + rows] for a in make(total)],
              torch.Generator().manual_seed(9))
    torch.testing.assert_close(part, whole[first:first + rows], rtol=0,
                               atol=0)


def test_cpu_attention_dropout_is_the_global_masks_rows(monkeypatch):
    rng = np.random.RandomState(0)
    qkv = [torch.from_numpy(rng.randn(6, 2, 5, 8).astype(np.float32))
           for _ in range(3)]
    _rows_of_global(
        lambda q, k, v, g: attention.fused_attention(q, k, v, None, 0.3, g),
        lambda b: [t[:b] for t in qkv], 2, 2, 6, monkeypatch)


def test_cpu_ffn_train_dropout_is_the_global_masks_rows(monkeypatch):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(6, 3, 16).astype(np.float32))
    w = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.2)
         for s in ((32, 16), (32,), (16, 32), (16,), (16,), (16,))]
    _rows_of_global(
        lambda xs, g: ffn.fused_ffn_train(xs, *w, 0.3, g),
        lambda b: [x[:b]], 2, 2, 6, monkeypatch)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kernel_keep_masks_at_an_offset_are_the_global_masks_rows(rate):
    """Both kernels' plain keep masks (Philox4x32-10 under the kernels'
    counters): groups g0.. (attention) and rows r0.. (FFN) of a call at
    that offset are those rows of the call from 0."""
    seed = [0x12345678, 0x9ABCDEF0]
    whole = attention.keep_mask_reference(seed, 12, 40, 33, rate)
    part = attention.keep_mask_reference(seed, 4, 40, 33, rate, group0=8)
    assert torch.equal(part, whole[8:12])
    assert 0.0 < 1.0 - whole.float().mean().item() < 2 * rate
    whole = ffn.keep_mask_reference(seed, 96, 64, rate)
    part = ffn.keep_mask_reference(seed, 40, 64, rate, row0=56)
    assert torch.equal(part, whole[56:96])
    # the FFN counter: word col % 4 of Philox at (col / 4, row, 0, 0)
    row, col = 77, 13
    words = attention.philox4x32(tuple(torch.tensor([v]) for v in (
        col // 4, row, 0, 0)), seed)
    assert bool(whole[row, col]) == bool(
        words[col % 4].item() >= attention._threshold(rate))


def test_steps_per_loop_refuses_a_gloo_group_on_a_cuda_device(monkeypatch):
    """The guard of ``StepChunks``: a gloo group cannot be captured in a
    CUDA graph, so a chunked trainer on a CUDA device raises before it
    builds anything; NCCL, or the CPU, passes."""
    monkeypatch.setattr(distributed, "is_active", lambda: True)
    monkeypatch.setattr(distributed, "backend", lambda: "gloo")
    stand_in = SimpleNamespace(params=[SimpleNamespace(
        device=torch.device("cuda", 0))])
    with pytest.raises(RuntimeError, match="gloo"):
        graph.StepChunks(None, None, stand_in, None, 2)
    graph.check_capturable(torch.device("cpu"))
    monkeypatch.setattr(distributed, "backend", lambda: "nccl")
    graph.check_capturable(torch.device("cuda", 0))


def test_without_a_process_group_every_collective_is_the_identity(
        monkeypatch):
    for var in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert not distributed.is_active()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    t = torch.arange(3.0)
    assert distributed.global_sum(t) is t
    before = distributed.all_reduce_sum_.launches
    distributed.all_reduce_sum_(t)
    distributed.broadcast_([t])
    assert distributed.all_reduce_sum_.launches == before
    assert distributed.allgather_object({"a": 1}) == [{"a": 1}]
    assert mesh.global_rows(5) == (0, 5)
    assert distributed.maybe_initialize_distributed() is False

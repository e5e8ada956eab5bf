"""The port's fused bottleneck (shgvqa_tpu_torch/kernels/bottleneck.py)
against the JAX Pallas prototype it replaces (tools/proto_block_kernel.py,
interpret mode on the CPU, and its XLA reference), and the switched slow_r50
trunk against the JAX trunk.  The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against ``bottleneck_reference`` there); on the CPU
the wrapper takes the plain version, which is what these tests hold.

Tolerances: f32 1e-5 against the XLA reference (the prototype's kernel
rounds its intermediates to bf16 whatever its input, so it is compared in
bf16); bf16 2e-2 of max |ref| (the prototype's own check,
proto_block_kernel.py:218, :228); the trunk 1e-4 (as
tests/test_torch_backbone.py)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.models.backbone import SlowR50 as JaxSlowR50
from shgvqa_tpu_torch.kernels import bottleneck
from shgvqa_tpu_torch.models import backbone
from shgvqa_tpu_torch.models.backbone import SlowR50, set_block_kernel
from shgvqa_tpu_torch.models.layers import init_weights
from test_torch_common import close, jax_variables, load_port, t

REPO = Path(__file__).resolve().parent.parent
# the flagship trunk's topology (depths, temporal kernels) at toy widths
TOY_DEEP = dict(stem_width=8, mids=(8, 8, 8, 8), outs=(16, 16, 16, 16),
                depths=(3, 4, 6, 3))


def _proto():
    spec = importlib.util.spec_from_file_location(
        "proto_block_kernel", REPO / "tools" / "proto_block_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(ci, cm, co, proj, seed):
    """numpy f32 operands in the prototype's layouts: x (N, 8, 8, Ci), wa
    (Ci, Cm), wb (3, 3, Cm, Cm), wc (Cm, Co), wp (Ci, Co); BN vectors."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=0.1):
        return rng.randn(*shape).astype(np.float32) * scale

    args = [np.abs(f(4, 8, 8, ci, scale=1.0)), f(ci, cm, scale=0.3),
            1.0 + f(cm), f(cm), f(3, 3, cm, cm, scale=0.2), 1.0 + f(cm),
            f(cm), f(cm, co, scale=0.3), 1.0 + f(co), f(co)]
    pr = (f(ci, co, scale=0.3), 1.0 + f(co), f(co)) if proj else None
    return args, pr


def _port_args(args, pr, dtype):
    """The prototype's operands in the port's layouts, as torch ``dtype``."""
    x, wa, sa, ba, wb, sb, bb, wc, sc, bc = args
    ours = [x, wa.T, sa, ba, wb.transpose(3, 2, 0, 1), sb, bb, wc.T, sc, bc]
    ours = [t(np.ascontiguousarray(a), dtype) for a in ours]
    if pr is not None:
        pr = (t(np.ascontiguousarray(pr[0].T), dtype), t(pr[1], dtype),
              t(pr[2], dtype))
    return ours, pr


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("proj", [False, True])
def test_plain_version_matches_xla_reference_f32(proj):
    proto = _proto()
    args, pr = _data(16 if proj else 32, 16, 32, proj, seed=proj)
    want = proto._xla_reference(
        *map(jnp.asarray, args),
        proj=None if pr is None else tuple(map(jnp.asarray, pr)))
    ours, opr = _port_args(args, pr, torch.float32)
    got = bottleneck.bottleneck_reference(*ours, opr)
    assert got.shape == (4, 8, 8, 32) and got.dtype == torch.float32
    close(got, want, 1e-5)


@pytest.mark.parametrize("proj", [False, True])
def test_plain_version_matches_prototype_bf16(proj):
    proto = _proto()
    args, pr = _data(16 if proj else 32, 16, 32, proj, seed=2 + proj)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jpr = None if pr is None else tuple(jnp.asarray(a, jnp.bfloat16)
                                        for a in pr)
    ours, opr = _port_args(args, pr, torch.bfloat16)
    got = bottleneck.bottleneck_reference(*ours, opr)
    assert got.dtype == torch.bfloat16
    want = proto.fused_bottleneck(*jargs, proj=jpr, interpret=True)
    assert _rel_err(got.float(), want) <= 2e-2
    assert _rel_err(got.float(),
                    proto._xla_reference(*jargs, proj=jpr)) <= 2e-2
    # on the CPU the wrapper takes the plain version
    close(bottleneck.fused_bottleneck(*ours, opr), got.float(), 0.0)


@pytest.mark.parametrize("t_len,hw", [(4, 32), (2, 40)])
def test_trunk_with_the_block_switch_matches_jax(t_len, hw):
    x = np.random.RandomState(5).randn(2, t_len, hw, hw, 3).astype(np.float32)
    mod = JaxSlowR50(dtype=jnp.float32, **TOY_DEEP)
    v = jax_variables(mod, x)
    port = load_port(SlowR50(torch.float32, **TOY_DEEP), v)
    set_block_kernel(port, True)
    with torch.no_grad():
        got = port(t(x))
    want = np.asarray(mod.apply(v, x))
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-4


def test_switch_reaches_exactly_the_six_eligible_blocks(monkeypatch):
    """res_2 blocks 0-2 and res_3 blocks 1-3 take the kernel route; res_3
    block_0 (stride 2) and res_4/res_5 (temporal kernel 3) do not.  In bf16
    the route gives the unfused blocks' output exactly: the plain version
    rounds where the convs and the frozen BN do."""
    calls = []

    def counted(x, *args):
        calls.append(tuple(x.shape))
        return bottleneck.fused_bottleneck(x, *args)

    monkeypatch.setattr(backbone, "fused_bottleneck", counted)
    trunk = init_weights(SlowR50(torch.bfloat16, **TOY_DEEP)).eval()
    x = torch.randn(2, 4, 32, 32, 3)
    with torch.no_grad():
        want = trunk(x)
        assert calls == []
        set_block_kernel(trunk, True)
        got = trunk(x)
    eligible = [f"res_{s}.block_{i}" for s, i in
                ((2, 0), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3))]
    assert sorted(name for name, m in trunk.named_modules()
                  if isinstance(m, backbone.Bottleneck3D)
                  and m.temporal_kernel == 1 and m.spatial_stride == 1
                  ) == eligible
    assert calls == [(8, 8, 8, 8)] + [(8, 8, 8, 16)] * 2 + [(8, 4, 4, 16)] * 3
    assert sum(isinstance(m, backbone.Bottleneck3D)
               for m in trunk.modules()) == 16
    close(got.float(), want.float(), 0.0)


def test_wrapper_raises_on_bad_shapes_dtypes_and_grad():
    args, pr = _data(32, 16, 32, False, seed=7)
    ours, _ = _port_args(args, pr, torch.float32)
    with pytest.raises(ValueError, match="wb must have shape"):
        bottleneck.fused_bottleneck(*ours[:4], ours[4][:, :8], *ours[5:])
    with pytest.raises(ValueError, match="without a projection"):
        bottleneck.fused_bottleneck(ours[0][..., :16], *ours[1:])
    with pytest.raises(ValueError, match=r"sc must have shape \(32,\)"):
        bottleneck.fused_bottleneck(*ours[:8], ours[8][:16], ours[9])
    with pytest.raises(RuntimeError, match="forward only"):
        bottleneck.fused_bottleneck(ours[0].requires_grad_(True), *ours[1:])
    ours[0].requires_grad_(False)

    # the card's checks, reached before any launch on a device that is not
    # the CPU
    def meta(args, dtype):
        return [a.to(device="meta", dtype=dtype) for a in args]

    with pytest.raises(NotImplementedError, match="bfloat16"):
        bottleneck.fused_bottleneck(*meta(ours, torch.float32))
    with pytest.raises(ValueError, match="Cm=16 must be 64 or 128"):
        bottleneck.fused_bottleneck(*meta(ours, torch.bfloat16))
    wide, _ = _port_args(*_data(128, 64, 128, False, seed=8), torch.float32)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        bottleneck.fused_bottleneck(*meta(wide, torch.bfloat16))

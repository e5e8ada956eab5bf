"""The port's cross-modal layer variants (``--crossAttnType self /
cross_self / old``, ``--untieXLayers``) and the deaf encoder (task 'vhga')
against the JAX package's, f32 at 1e-4, with the same (perturbed) weights
carried by shgvqa_tpu_torch.convert: ``SelfCrossLayer`` and
``CrossAndSelfLayer`` at the first and a later x-layer step, ``_cat_masks``,
``LXRTModel`` and ``HGQCrossEncoder`` for every type, tied and untied, and
the pooler each type takes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.models import cross as jcross
from shgvqa_tpu.models import encoder as jenc
from shgvqa_tpu.models import hg as jhg
from shgvqa_tpu.models import layers as jl
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.models import cross, encoder, hg, layers
from test_torch_common import close, jax_variables, load_port, t

TOL = 1e-4
F32 = torch.float32
D, HEADS, HD, FF = 32, 4, 8, 64
TYPES = ("cross", "self", "cross_self", "old")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ext(b, length, valid):
    m = np.zeros((b, length), np.int32)
    for i, n in enumerate(valid):
        m[i, :n] = 1
    return np.asarray(jl.extend_mask(jnp.asarray(m), jnp.float32))


def _opt(x):
    return None if x is None else t(x)


@pytest.mark.parametrize("visn_masked", [False, True])
@pytest.mark.parametrize("name", ["SelfCrossLayer", "CrossAndSelfLayer"])
def test_joint_layer_matches_jax_at_the_first_and_a_later_step(name,
                                                               visn_masked):
    """Step 0 joins [visn; lang] (the visual side's missing mask as zeros);
    a later step takes the joint stream and its concatenated mask."""
    lang, visn = _x(2, 7, D, seed=1), _x(2, 11, D, seed=2)
    lmask = _ext(2, 7, [7, 4])
    vmask = _ext(2, 11, [11, 8]) if visn_masked else None
    mod = getattr(jcross, name)(HEADS, HD, FF)
    v = jax_variables(mod, lang, lmask, visn, vmask)
    port = load_port(getattr(cross, name)(D, HEADS, HD, FF, F32), v)
    want = mod.apply(v, lang, lmask, visn, vmask, step=0)
    got = port(t(lang), t(lmask), t(visn), _opt(vmask), None, 0)
    for g, w in zip(got, want[:2]):
        close(g, w, TOL)
    joint_mask = np.asarray(jcross._cat_masks(vmask, lmask, 11, 7))
    want = mod.apply(v, np.asarray(want[0]), lmask, np.asarray(want[1]),
                     joint_mask if name == "SelfCrossLayer" else vmask,
                     step=1)
    nxt = cross._cat_masks(_opt(vmask), t(lmask), 11, 7) \
        if name == "SelfCrossLayer" else _opt(vmask)
    got = port(got[0], t(lmask), got[1], nxt, None, 1)
    for g, w in zip(got, want[:2]):
        close(g, w, TOL)


@pytest.mark.parametrize("sides", ["none", "visn", "lang", "both"])
def test_cat_masks_matches_jax(sides):
    vmask = _ext(2, 5, [5, 2]) if sides in ("visn", "both") else None
    lmask = _ext(2, 3, [1, 3]) if sides in ("lang", "both") else None
    want = jcross._cat_masks(vmask, lmask, 5, 3)
    got = cross._cat_masks(_opt(vmask), _opt(lmask), 5, 3)
    if want is None:
        assert got is None
    else:
        assert tuple(got.shape) == (2, 1, 1, 8)
        close(got, want, 0.0)


def _enc_cfgs(cat, tie):
    def enc(cfg):
        return cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, cross_attn_type=cat, tie_x_layers=tie))
    return enc(jax_tiny()), enc(tiny_test_config())


def _lxrt_inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    d, e = cfg.data, cfg.encoder
    mask = np.ones((2, d.max_seq_length), np.int32)
    mask[1, d.max_seq_length // 2:] = 0
    return (rng.randint(1, e.vocab_size, (2, d.max_seq_length)
                        ).astype(np.int32),
            mask, np.zeros((2, d.max_seq_length), np.int32),
            rng.randn(2, e.visual_t + 8, e.visual_hw, e.visual_hw,
                      e.visual_feat_dim).astype(np.float32),
            np.ones((2, e.visual_seq_length), np.int32))


@pytest.mark.parametrize("cat,tie,deaf", [
    (c, tie, False) for c in TYPES for tie in (True, False)
] + [("cross", True, True), ("self", False, True)],
    ids=lambda x: str(x))
def test_lxrt_model_matches_jax(cat, tie, deaf):
    """Every output of ``LXRTModel``: the pooled output, both post-cross
    streams, both snapshots and the language mask (all -10000 when deaf);
    ``x_tied`` or ``x_{i}``, and ``Pooler2`` only under 'cross'."""
    jcfg, cfg = _enc_cfgs(cat, tie)
    inputs = _lxrt_inputs(jcfg, seed=3)
    mod = jenc.LXRTModel(jcfg.encoder, deaf=deaf)
    v = jax_variables(mod, *inputs)
    port = load_port(encoder.LXRTModel(cfg.encoder, F32, deaf=deaf), v)
    names = set(dict(port.encoder.named_children()))
    assert (("x_tied" in names) == tie
            and ("x_1" in names) == (not tie))
    assert isinstance(port.pooler, layers.Pooler2) == (cat == "cross")
    assert isinstance(port.pooler, layers.Pooler) == (cat != "cross")
    want = mod.apply(v, *inputs)
    with torch.inference_mode():
        got = port(*(t(x) for x in inputs))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, TOL)
    if deaf:
        assert (got[5] == layers.NEG_MASK).all()


@pytest.mark.parametrize("hg_mask", [False, True])
@pytest.mark.parametrize("cat", TYPES)
def test_hgq_cross_encoder_matches_jax(cat, hg_mask):
    """The HG<->question encoder of every type, with and without the
    ``--useHGMask`` key mask; 'self' concatenates its mask after step 0."""
    jcfg, cfg = _enc_cfgs(cat, True)
    d = jcfg.data
    total = d.num_situations * (d.num_act + d.num_rel)
    lang, hgf = _x(2, 9, D, seed=4), _x(2, total, D, seed=5)
    lmask = _ext(2, 9, [9, 5])
    mask = None
    if hg_mask:
        mask = (np.random.RandomState(6).rand(2, total) > 0.4).astype(
            np.int32)
    mod = jhg.HGQCrossEncoder(jcfg.encoder, d.num_act, d.num_rel)
    v = jax_variables(mod, lang, lmask, hgf, mask)
    port = load_port(hg.HGQCrossEncoder(cfg.encoder, d.num_act, d.num_rel,
                                        F32), v)
    assert isinstance(port.pooler, layers.Pooler2) == (cat == "cross")
    with torch.inference_mode():
        got = port(t(lang), t(lmask), t(hgf), None, _opt(mask))
    close(got, mod.apply(v, lang, lmask, hgf, mask), TOL)


def test_old_is_the_cross_layer_with_the_single_cls_pooler():
    """'old' builds the same x-layer as 'cross' (``CrossLayer``) but pools
    one CLS (``Pooler``, the reference's pooler_dict['old'])."""
    for cat, pooler in (("cross", layers.Pooler2), ("old", layers.Pooler)):
        _, cfg = _enc_cfgs(cat, True)
        model = encoder.LXRTModel(cfg.encoder, F32)
        assert type(model.encoder.x_tied) is cross.CrossLayer
        assert type(model.pooler) is pooler
        assert type(hg.HGQCrossEncoder(cfg.encoder).pooler) is pooler
    assert cross.CROSS_LAYER_TYPES.keys() == jcross.CROSS_LAYER_TYPES.keys()
    for name, cls in cross.CROSS_LAYER_TYPES.items():
        assert cls.__name__ == jcross.CROSS_LAYER_TYPES[name].__name__

"""The port's building blocks against the JAX package's, f32 at 1e-4, with
the same (perturbed) weights carried by shgvqa_tpu_torch.convert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data.featurize import situation_causal_mask
from shgvqa_tpu.models import cross as jcross
from shgvqa_tpu.models import decoder as jdec
from shgvqa_tpu.models import hg as jhg
from shgvqa_tpu.models import layers as jl
from shgvqa_tpu.models import visual as jvis
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.models import cross, decoder, hg, layers, visual
from test_torch_common import close, jax_variables, load_port, t

TOL = 1e-4
F32 = torch.float32
D, HEADS, HD, FF = 32, 4, 8, 64


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _padded_mask(b, length, valid):
    m = np.zeros((b, length), np.int32)
    for i, n in enumerate(valid):
        m[i, :n] = 1
    return m


def test_extend_mask_with_padding():
    m = _padded_mask(2, 6, [6, 3])
    close(layers.extend_mask(t(m), F32), jl.extend_mask(jnp.asarray(m),
                                                        jnp.float32), 0.0)


def test_gelu_matches_jax():
    x = _x(4, 33) * 3
    close(layers.gelu(t(x)), jl.gelu(jnp.asarray(x)), 1e-6)


def test_bert_layer_with_padded_mask():
    x = _x(2, 9, D)
    ext = np.asarray(jl.extend_mask(jnp.asarray(_padded_mask(2, 9, [9, 5])),
                                    jnp.float32))
    mod = jl.BertLayer(HEADS, HD, FF)
    v = jax_variables(mod, x, ext)
    want, _ = mod.apply(v, x, ext)
    port = load_port(layers.BertLayer(D, HEADS, HD, FF, F32), v)
    close(port(t(x), t(ext)), want, TOL)


def test_cross_layer_shares_one_attention_block():
    lang, visn = _x(2, 7, D, seed=1), _x(2, 11, D, seed=2)
    lmask = np.asarray(jl.extend_mask(
        jnp.asarray(_padded_mask(2, 7, [7, 4])), jnp.float32))
    mod = jcross.CrossLayer(HEADS, HD, FF)
    v = jax_variables(mod, lang, lmask, visn, None)
    want_l, want_v, _ = mod.apply(v, lang, lmask, visn, None)
    port = load_port(cross.CrossLayer(D, HEADS, HD, FF, F32), v)
    assert sum(1 for k in port.state_dict() if ".att.query.weight" in k) == 1
    got_l, got_v = port(t(lang), t(lmask), t(visn), None)
    close(got_l, want_l, TOL)
    close(got_v, want_v, TOL)


def test_decoder_layer_with_causal_mask():
    s, slots = 4, 3
    tgt, mem, pos = _x(2, s * slots, D, seed=3), _x(2, 9, D, seed=4), \
        _x(2, s * slots, D, seed=5)
    mask = situation_causal_mask(s, slots)
    assert np.isinf(mask).any()
    mod = jdec.DecoderLayer(HEADS, FF)
    v = jax_variables(mod, tgt, mem, pos, mask)
    want = mod.apply(v, tgt, mem, pos, mask)
    port = load_port(decoder.DecoderLayer(D, HEADS, FF, F32), v)
    close(port(t(tgt), t(mem), t(pos), t(mask)), want, TOL)


def test_hg_decoder_stack():
    pos, mem = _x(2, 8, D, seed=6), _x(2, 5, D, seed=7)
    mask = situation_causal_mask(4, 2)
    mod = jdec.HGDecoder(num_layers=2, num_heads=HEADS, ffn_dim=FF)
    v = jax_variables(mod, pos, mem, mask)
    port = load_port(decoder.HGDecoder(2, D, HEADS, FF, F32), v)
    close(port(t(pos), t(mem), t(mask)), mod.apply(v, pos, mem, mask), TOL)


def test_hgq_cross_encoder():
    jcfg, cfg = jax_tiny(), tiny_test_config()
    lang, hgf = _x(2, 6, D, seed=8), _x(2, 4 * 5, D, seed=9)
    lmask = np.asarray(jl.extend_mask(
        jnp.asarray(_padded_mask(2, 6, [6, 2])), jnp.float32))
    mod = jhg.HGQCrossEncoder(jcfg.encoder, num_max_act=2, num_max_rel=3)
    v = jax_variables(mod, lang, lmask, hgf)
    port = load_port(hg.HGQCrossEncoder(cfg.encoder, 2, 3, F32), v)
    close(port(t(lang), t(lmask), t(hgf)), mod.apply(v, lang, lmask, hgf),
          TOL)


def test_hg_embeddings_full_table_as_queries():
    seg = np.repeat(np.arange(4, dtype=np.int32), 3)[None].repeat(2, 0)
    mod = jhg.HGEmbeddings(num_queries=12, hidden_size=D, type_vocab_size=4)
    v = jax_variables(mod, seg)
    port = load_port(hg.HGEmbeddings(12, D, 4, F32), v)
    close(port(t(seg)), mod.apply(v, seg), TOL)


def test_visual_tokenizer():
    feats = _x(2, 10, 3, 3, 16, seed=10)
    mod = jvis.VisualTokenizer(hidden_size=D)
    v = jax_variables(mod, feats)
    port = load_port(visual.VisualTokenizer(16, D, 2 * 9 + 1, F32), v)
    got = port(t(feats))
    assert got.shape == (2, 19, D)
    close(got, mod.apply(v, feats), TOL)


def test_bert_embeddings():
    ids = np.random.RandomState(11).randint(0, 50, (2, 7)).astype(np.int32)
    seg = (np.arange(7)[None] % 2).repeat(2, 0).astype(np.int32)
    mod = jl.BertEmbeddings(vocab_size=50, hidden_size=D,
                            max_position_embeddings=16)
    v = jax_variables(mod, ids, seg)
    port = load_port(layers.BertEmbeddings(50, D, 16, 2, F32), v)
    close(port(t(ids), t(seg)), mod.apply(v, ids, seg), TOL)


@pytest.mark.parametrize("name", ["pooler", "pooler2", "mlp_head"])
def test_heads(name):
    a, b = _x(3, 5, D, seed=12), _x(3, 4, D, seed=13)
    if name == "pooler":
        mod, port, args = jl.Pooler(D), layers.Pooler(D, F32), (a,)
    elif name == "pooler2":
        mod, port, args = jl.Pooler2(D), layers.Pooler2(D, F32), (a, b)
    else:
        mod, port, args = jl.MLPHead(13), layers.MLPHead(D, 13, dtype=F32), (a,)
    v = jax_variables(mod, *args)
    close(load_port(port, v)(*map(t, args)), mod.apply(v, *args), TOL)

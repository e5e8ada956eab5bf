"""The port's attention dumps (``--outputAttn``) against the JAX package at
tiny_test_config size in f32: the probabilities of ``Attention``, of each
cross-layer variant and of ``TriStreamEncoder`` under 'self' (its joint
mask step), with the same keys and list lengths (1e-5); the npz maps of a
whole forward (``LXRTModel`` and ``HGQCrossEncoder``, 1e-5);
``matched_target_grid`` per frame and global (exact); ``_dump_attentions``'
files on the same weights and batches (JSON equal, floats within 1e-4; the
npz keys and shapes equal); the label-free split; the per-choice rows
(JAX's row i, the port's row i x 4 + the answered choice: a fault of the
JAX driver, ROADMAP C); and a dumps forward with every attention kernel
switch on calls no attention kernel and the FFN kernel as often as a plain
eval forward.

The JAX side runs ``_dump_attentions`` itself (one jitted forward per
configuration) on seeded random weights."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgvqa_tpu.cli import common as jax_common
from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data.pipeline import Batcher as JaxBatcher
from shgvqa_tpu.losses import set_prediction as jax_loss
from shgvqa_tpu.models import cross as jax_cross
from shgvqa_tpu.models import encoder as jax_encoder
from shgvqa_tpu.models import layers as jax_layers
from shgvqa_tpu.models.shgvqa import ShgVqaModel as JaxShgVqaModel
from shgvqa_tpu_torch.cli import common
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.data.pipeline import Batcher
from shgvqa_tpu_torch.losses.set_prediction import matched_target_grid
from shgvqa_tpu_torch.models import cross, encoder, layers
from shgvqa_tpu_torch.models.layers import extend_mask
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from test_torch_common import close, jax_variables, load_port, t
from test_torch_per_choice import (
    NCH,
    per_choice_batch,
    per_choice_cfgs,
    random_variables,
)

TOL, JSON_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the probabilities, layer by layer ---------------------------------------


def _states(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _ext(mask):
    return np.asarray(extend_mask(t(mask), torch.float32))


def test_attention_probabilities_match_jax():
    x, ctx = _states(0, (2, 5, 32), (2, 7, 32))
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    jmod = jax_layers.Attention(num_heads=4, head_dim=8)
    v = jax_variables(jmod, x, ctx, _ext(mask))
    want_out, want_p = jmod.apply(v, x, ctx, _ext(mask), True, True)
    port = load_port(layers.Attention(32, 4, 8), v)
    port.kernel_eval = port.headsliced = True       # ignored for the probs
    with torch.inference_mode():
        out, probs = port(t(x), t(ctx), t(_ext(mask)), None, True)
    assert probs.shape == (2, 4, 5, 7)
    close(out, want_out, TOL)
    close(probs, want_p, TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("cat", ["cross", "old", "self", "cross_self"])
def test_cross_layer_probabilities_match_jax(cat):
    lang, visn = _states(1, (2, 6, 32), (2, 9, 32))
    lmask = np.ones((2, 6), np.int32)
    lmask[0, 4:] = 0
    lext, vext = _ext(lmask), _ext(np.ones((2, 9), np.int32))
    jcls = jax_cross.CROSS_LAYER_TYPES[cat]
    jmod = jcls(num_heads=4, head_dim=8, intermediate_size=64)
    v = jax_variables(jmod, lang, lext, visn, vext, step=0)
    want = jmod.apply(v, lang, lext, visn, vext, step=0, deterministic=True,
                      return_probs=True)
    port = load_port(cross.CROSS_LAYER_TYPES[cat](32, 4, 8, 64), v)
    with torch.inference_mode():
        got = port(t(lang), t(lext), t(visn), t(vext), None, 0, True)
        plain = port(t(lang), t(lext), t(visn), t(vext), None, 0)
    assert set(got[2]) == set(want[2]) == ({"xl", "xv"} if cat in
                                           ("cross", "old") else {"vl"})
    for i in range(2):
        close(got[i], want[i], TOL)
        torch.testing.assert_close(got[i], plain[i], rtol=0, atol=0)
    for key in want[2]:
        close(got[2][key], want[2][key], TOL)


def test_tri_stream_encoder_probabilities_under_self_match_jax():
    """The 'self' joint stream: the x-steps' maps over [visn; lang] with
    the concatenated mask from step 1 on; every list as long as JAX's."""
    jcfg = jax_tiny(task="hgqa")
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, cross_attn_type="self"))
    cfg = tiny_test_config(task="hgqa")
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, cross_attn_type="self"))
    e, d = cfg.encoder, cfg.data
    lang, feats = _states(2, (2, d.max_seq_length, 32),
                          (2, e.visual_t + 8, 2, 2, e.visual_feat_dim))
    lmask = np.ones((2, d.max_seq_length), np.int32)
    lmask[1, 5:] = 0
    jmod = jax_encoder.TriStreamEncoder(jcfg.encoder)
    v = jax_variables(jmod, lang, _ext(lmask), feats, None)
    want = jmod.apply(v, lang, _ext(lmask), feats, None, True, True)
    port = load_port(encoder.TriStreamEncoder(cfg.encoder), v)
    with torch.inference_mode():
        got = port(t(lang), t(_ext(lmask)), t(feats), None, None, True)
    for i in range(4):
        close(got[i], want[i], TOL)
    assert {k: len(x) for k, x in got[4].items()} == {
        k: len(x) for k, x in want[4].items()} == {"lang": 2, "visn": 2,
                                                   "cross": 2}
    for kind in ("lang", "visn"):
        for a, b in zip(got[4][kind], want[4][kind]):
            close(a, b, TOL)
    lv = e.visual_seq_length
    for a, b in zip(got[4]["cross"], want[4]["cross"]):
        assert a.keys() == b.keys() == {"vl"}
        assert a["vl"].shape[-1] == lv + d.max_seq_length
        close(a["vl"], b["vl"], TOL)
    # step 1 sees the masked language keys
    assert float(got[4]["cross"][1]["vl"][1, :, :, lv + 5:].max()) < 1e-3


# -- the matched grids ---------------------------------------------------------


@pytest.mark.parametrize("per_frame", [True, False], ids=["per_frame",
                                                          "global"])
def test_matched_target_grid_matches_jax(per_frame):
    rng = np.random.RandomState(3)
    b, s, slots, c = 3, 4, 3, 12
    logits = rng.randn(b, s * slots, c).astype(np.float32)
    labels = rng.randint(1, c, (b, s, slots)).astype(np.int32)
    lengths = rng.randint(0, slots + 1, (b, s)).astype(np.int32)
    want = jax_loss.matched_target_grid(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lengths),
        per_frame=per_frame, num_situations=s)
    got = matched_target_grid(t(logits), t(labels), t(lengths), per_frame,
                              s)
    assert got.shape == (b, s, slots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the dump files --------------------------------------------------------------


def _items(cfg, n, per_choice=False, labels=True):
    """n featurized items with question ids (a per-choice config's carry
    their four encodings and 4-way targets)."""
    items = []
    for k in range(0, n, 2):
        batch = per_choice_batch(cfg, seed=k)
        for i in range(2):
            item = {key: v[i] for key, v in batch.items()}
            if not per_choice:
                for key in ("choice_input_ids", "choice_input_mask",
                            "choice_segment_ids"):
                    item.pop(key)
            if not labels:
                for key in ("rel_labels", "rel_lengths", "act_labels",
                            "act_lengths"):
                    item.pop(key)
            item["ques_id"] = f"Q{k + i:04d}"
            items.append(item)
    return items[:n]


def _dump_both(tmp_path, jcfg, cfg, items, max_batches):
    """Both packages' ``_dump_attentions`` on the same weights and batches:
    (JAX dir, port dir, port model)."""
    jmodel = JaxShgVqaModel(jcfg)
    first = {k: v for k, v in next(JaxBatcher(
        items, batch_size=2, shuffle=False).epoch(0)).items()
        if k not in ("ques_id", "n_valid")}
    v = random_variables(jmodel, first)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_common._dump_attentions(
        jcfg.replace(output=str(jdir)), SimpleNamespace(model=jmodel,
                                                        params=v),
        JaxBatcher(items, batch_size=2, shuffle=False), max_batches)
    port = load_port(ShgVqaModel(cfg), v)
    summary = common._dump_attentions(
        cfg.replace(output=str(pdir)), SimpleNamespace(model=port),
        Batcher(items, batch_size=2, shuffle=False), "cpu", max_batches)
    return jdir, pdir, port, summary


def _json(path):
    return json.loads(path.read_text())


def _assert_entries_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key == "attention":
                np.testing.assert_allclose(np.asarray(g[key]),
                                           np.asarray(w[key]), atol=JSON_TOL,
                                           rtol=JSON_TOL)
            else:
                assert g[key] == w[key], key


def _assert_npz_equal(gdir, wdir, names, tol=TOL):
    for name in names:
        g = np.load(gdir / "attentions" / name)
        w = np.load(wdir / "attentions" / name)
        assert set(g.files) == set(w.files)
        for key in w.files:
            assert g[key].shape == w[key].shape, key
            if key == "ques_ids":
                np.testing.assert_array_equal(g[key], w[key])
            else:
                np.testing.assert_allclose(g[key], w[key], atol=tol,
                                           rtol=tol, err_msg=key)


def test_dump_files_match_jax(tmp_path):
    """'hgqa' per-frame, 5 valid questions in batches of 2, 2 batches
    dumped: both JSON files equal JAX's (floats 1e-4), each entry's
    attention a (heads, 1 + S x (A + R)) row, the grids (S, Q / S); the
    npz maps (every layer of the LXRT and the HG encoder) within 1e-5."""
    jcfg, cfg = jax_tiny(task="hgqa"), tiny_test_config(task="hgqa")
    items = _items(cfg, 5)
    jdir, pdir, _, summary = _dump_both(tmp_path, jcfg, cfg, items, 2)
    assert summary["questions"] == 4 and summary["batches"] == 2
    for name in ("val_attentions_cross_2.json",
                 "hg_val_attentions_cross_2.json"):
        _assert_entries_equal(_json(pdir / name), _json(jdir / name))
    res = _json(pdir / "val_attentions_cross_2.json")
    d = cfg.data
    assert [r["questionId"] for r in res] == [it["ques_id"]
                                              for it in items[:4]]
    for r in res:
        assert np.asarray(r["attention"]).shape == (
            4, 1 + d.num_situations * (d.num_act + d.num_rel))
        assert np.asarray(r["rel_pred"]).shape == (d.num_situations,
                                                   d.num_rel_queries
                                                   // d.num_situations)
    _assert_npz_equal(pdir, jdir, ["batch000.npz", "batch001.npz"])
    keys = set(np.load(pdir / "attentions" / "batch000.npz").files)
    assert {"attn.encoder.lang.1", "attn.encoder.visn.1",
            "attn.encoder.cross.1.xl", "attn.encoder.cross.1.xv",
            "attn.hgq.1.xl", "ques_ids"} <= keys


def test_label_free_split_matches_jax(tmp_path):
    jcfg, cfg = jax_tiny(task="hgqa"), tiny_test_config(task="hgqa")
    items = _items(cfg, 2, labels=False)
    jdir, pdir, _, _ = _dump_both(tmp_path, jcfg, cfg, items, 1)
    res = _json(pdir / "val_attentions_cross_2.json")
    assert len(res) == 2 and "rel_pred" not in res[0] and res[0]["attention"]
    _assert_entries_equal(res, _json(jdir / "val_attentions_cross_2.json"))


def test_per_choice_rows_are_the_answered_choice(tmp_path):
    """Per-choice 'hgqa' with global matching: the HG encoder's maps have
    B x 4 rows.  JAX dumps row i for question i (clip 0's choice 1 for
    question 1); the port dumps row i x 4 + c, c the choice its file's
    head answered.  Everything else, the global grids and the npz maps
    (raw B x 4 rows), equals JAX's."""
    jcfg, cfg = per_choice_cfgs("hgqa", loss_hg_per_frame=False)
    items = _items(cfg, 4, per_choice=True)
    jdir, pdir, port, _ = _dump_both(tmp_path, jcfg, cfg, items, 2)
    _assert_npz_equal(pdir, jdir, ["batch000.npz", "batch001.npz"])
    maps = np.load(pdir / "attentions" / "batch000.npz")
    assert maps["attn.hgq.1.xl"].shape[0] == 2 * NCH
    for name in ("val_attentions_cross_2.json",
                 "hg_val_attentions_cross_2.json"):
        got, want = _json(pdir / name), _json(jdir / name)
        for q, (g, w) in enumerate(zip(got, want)):
            rows = np.load(pdir / "attentions" /
                           f"batch{q // 2:03d}.npz")["attn.hgq.1.xl"]
            cls = rows[:, :, 0, :]
            i = q % 2
            np.testing.assert_allclose(w["attention"], cls[i], atol=JSON_TOL)
            np.testing.assert_allclose(g["attention"],
                                       cls[i * NCH + g["prediction"]],
                                       atol=JSON_TOL)
            rest = {k: x for k, x in g.items() if k != "attention"}
            assert rest == {k: x for k, x in w.items() if k != "attention"}
        assert any(g["prediction"] != q % 2 for q, g in enumerate(got))
    assert "rel_pred" in _json(pdir / "val_attentions_cross_2.json")[0]


def test_dumps_forward_calls_no_attention_kernel(tmp_path, monkeypatch):
    """With ``--pallasAttention``, the head-sliced switch and the FFN
    kernel on, a dumps forward calls no attention kernel wrapper (the
    decoders' included) and the FFN kernel as often as a plain eval
    forward, which calls the attention kernel at every site."""
    cfg = tiny_test_config(task="hgqa", use_pallas_attention=True)
    items = _items(cfg, 2)
    calls = {"attn": 0, "headsliced": 0, "ffn": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    from shgvqa_tpu_torch.models import decoder
    for mod in (layers, decoder):
        if hasattr(mod, "fused_attention"):
            monkeypatch.setattr(mod, "fused_attention",
                                spy("attn", mod.fused_attention))
        monkeypatch.setattr(mod, "headsliced_attention",
                            spy("headsliced", mod.headsliced_attention))
    monkeypatch.setattr(layers, "fused_ffn", spy("ffn", layers.fused_ffn))
    from shgvqa_tpu_torch.models.layers import init_weights
    model = init_weights(ShgVqaModel(cfg), 0).eval()
    batch = {k: t(v) for k, v in next(Batcher(items, batch_size=2).epoch(0))
             .items() if k not in ("ques_id", "n_valid")}
    with torch.inference_mode():
        plain = model(batch)
    eval_calls = dict(calls)
    assert eval_calls["attn"] == 20 and eval_calls["ffn"] == 12
    layers.set_headsliced_kernel(model, True)
    for k in calls:
        calls[k] = 0
    with torch.inference_mode():
        model(batch)
    assert calls["headsliced"] == 20 and calls["attn"] == 0
    for k in calls:
        calls[k] = 0
    common._dump_attentions(cfg.replace(output=str(tmp_path)),
                            SimpleNamespace(model=model),
                            Batcher(items, batch_size=2, shuffle=False),
                            "cpu", 1)
    assert calls == {"attn": 0, "headsliced": 0, "ffn": eval_calls["ffn"]}
    with torch.inference_mode():
        out = model(batch, output_attentions=True)
    assert layers.kernels_allowed()
    for key in ("logit", "hg_logit", "rel_preds", "act_preds"):
        close(out[key], plain[key].numpy(), TOL)
    assert all(p is not None for p in out["attentions"]["encoder"]["lang"])
    assert all(x["xl"] is not None and x["xv"] is not None
               for x in out["attentions"]["hgq"])

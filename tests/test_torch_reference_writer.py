"""Weight files under the names their publishers use, written from a tree
in the JAX layout with numpy alone: a reference SHG-VQA ``state_dict``
(``reference_state_dict``), a pytorchvideo slow_r50 checkpoint
(``pytorchvideo_state_dict``) and a bert-base ``pytorch_model.bin``
(``bert_state_dict``).  No such file is in the repository and none can be
fetched, so the importers' tests and ``chip_smoke.py`` write their own from
a model's weights.  This module imports no JAX: ``chip_smoke.py`` imports
it on the card.  ``tests/test_torch_weights_import.py`` pins
``reference_state_dict`` to the JAX importer (which decides what the names
are); the tests here hold the port's importers to the writers.

The reference's layout, as the JAX importer reads it:
- the encoder under ``lxrt_encoder.model.bert``; its ``x_layers.{i}`` are
  N aliases of one module, so every index holds the same tensors;
- ``pooler_dict`` and ``hgq_encoder.cross_attn_layer`` hold every cross
  variant with live parameters; ``extras`` adds a ``self`` variant next to
  the ``cross`` one that is read;
- the tokenizer's ``position_encoding.pe.weight`` has more rows than the
  model's tokens (it is sliced on import); its convs are ``visn_fc.conv.1``
  and ``visn_fc.conv.4``;
- the trunk under ``vid_encoder.backbone.`` with pytorchvideo's names.
"""

import dataclasses

import numpy as np
import pytest
import torch

from shgvqa_tpu_torch.convert import from_jax_variables, to_jax_variables
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.models.backbone import SlowR50
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.shgvqa import VideoShgVqaModel
from shgvqa_tpu_torch.utils import convert_slow_r50
from shgvqa_tpu_torch.utils.ref_import import reference_to_variables
from shgvqa_tpu_torch.utils.torch_import import bert_to_lxrt_params

# the toy slow_r50 of tests/test_slow_r50_convert.py: the real topology
# (depths 3, 4, 6, 3) at narrow widths
R50_TOY = dict(stem_width=8, mids=(8, 16, 32, 64), outs=(32, 64, 128, 256))

ENCODER = "lxrt_encoder.model.bert"


def _linear(out, prefix, tree):
    dense = tree["Dense_0"]
    out[f"{prefix}.weight"] = np.ascontiguousarray(dense["kernel"].T)
    out[f"{prefix}.bias"] = dense["bias"]


def _layer_norm(out, prefix, tree, names=("weight", "bias")):
    out[f"{prefix}.{names[0]}"] = tree["scale"]
    out[f"{prefix}.{names[1]}"] = tree["bias"]


def _conv(w):
    """(kT, kH, kW, I, O) -> torch (O, I, kT, kH, kW)."""
    return np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))


def _bert_layer(out, prefix, tree, ln=("weight", "bias")):
    att = tree["attention"]
    for name in ("query", "key", "value"):
        _linear(out, f"{prefix}.attention.self.{name}", att["self"][name])
    _linear(out, f"{prefix}.attention.output.dense", att["output"]["dense"])
    _layer_norm(out, f"{prefix}.attention.output.LayerNorm",
                att["output"]["ln"], ln)
    ffn = tree["ffn"]
    _linear(out, f"{prefix}.intermediate.dense", ffn["intermediate"])
    _linear(out, f"{prefix}.output.dense", ffn["output"])
    _layer_norm(out, f"{prefix}.output.LayerNorm", ffn["ln"], ln)


def _cross_layer(out, prefix, tree):
    va = tree["visual_attention"]
    for name in ("query", "key", "value"):
        _linear(out, f"{prefix}.visual_attention.att.{name}", va["att"][name])
    _linear(out, f"{prefix}.visual_attention.output.dense",
            va["output"]["dense"])
    _layer_norm(out, f"{prefix}.visual_attention.output.LayerNorm",
                va["output"]["ln"])
    for side in ("lang", "visn"):
        ffn = tree[f"{side}_ffn"]
        _linear(out, f"{prefix}.{side}_inter.dense", ffn["intermediate"])
        _linear(out, f"{prefix}.{side}_output.dense", ffn["output"])
        _layer_norm(out, f"{prefix}.{side}_output.LayerNorm", ffn["ln"])


def _random_self_variant(out, prefix, d, f, rng):
    """The 'self' cross variant's parameters, which the import skips."""
    def put(p, *shape):
        out[f"{p}.weight"] = rng.randn(*shape).astype(np.float32)
        out[f"{p}.bias"] = rng.randn(shape[0]).astype(np.float32)
    for name in ("query", "key", "value"):
        put(f"{prefix}.cross_att.self.{name}", d, d)
    put(f"{prefix}.cross_att.output.dense", d, d)
    put(f"{prefix}.cross_att.output.LayerNorm", d)
    put(f"{prefix}.vl_inter.dense", f, d)
    put(f"{prefix}.vl_output.dense", d, f)
    put(f"{prefix}.vl_output.LayerNorm", d)


def _decoder_layer(out, prefix, tree):
    for name in ("self_attn", "multihead_attn"):
        att = tree[name]
        out[f"{prefix}.{name}.in_proj_weight"] = np.ascontiguousarray(
            att["in_proj"]["kernel"].T)
        out[f"{prefix}.{name}.in_proj_bias"] = att["in_proj"]["bias"]
        _linear(out, f"{prefix}.{name}.out_proj", att["out_proj"])
    _linear(out, f"{prefix}.linear1", tree["linear1"])
    _linear(out, f"{prefix}.linear2", tree["linear2"])
    for i in (1, 2, 3):
        _layer_norm(out, f"{prefix}.norm{i}", tree[f"norm{i}"])


def pytorchvideo_state_dict(params, stats, head_classes=None, seed=0):
    """A slow_r50 trunk's tree (JAX layout: the backbone's params and
    batch_stats) -> pytorchvideo's ``Net`` names, with each BatchNorm's
    ``num_batches_tracked``; with ``head_classes`` also a ``blocks.5``
    classifier head (2048-wide at full width) of random weights."""
    out = {}

    def bn(prefix, p, s):
        out[f"{prefix}.weight"] = p["scale"]
        out[f"{prefix}.bias"] = p["bias"]
        out[f"{prefix}.running_mean"] = s["mean"]
        out[f"{prefix}.running_var"] = s["var"]
        out[f"{prefix}.num_batches_tracked"] = np.array(100, np.int64)

    out["blocks.0.conv.weight"] = _conv(params["stem_conv"]["kernel"])
    bn("blocks.0.norm", params["stem_bn"], stats["stem_bn"])
    for stage in range(4):
        name = f"res_{stage + 2}"
        for i in range(len(params[name])):
            p, s = params[name][f"block_{i}"], stats[name][f"block_{i}"]
            bb = f"blocks.{stage + 1}.res_blocks.{i}"
            if "conv_proj" in p:
                out[f"{bb}.branch1_conv.weight"] = _conv(
                    p["conv_proj"]["kernel"])
                bn(f"{bb}.branch1_norm", p["bn_proj"], s["bn_proj"])
            for tag in ("a", "b", "c"):
                out[f"{bb}.branch2.conv_{tag}.weight"] = _conv(
                    p[f"conv_{tag}"]["kernel"])
                bn(f"{bb}.branch2.norm_{tag}", p[f"bn_{tag}"], s[f"bn_{tag}"])
    if head_classes:
        rng = np.random.RandomState(seed)
        width = params["res_5"]["block_0"]["bn_c"]["scale"].shape[0]
        out["blocks.5.proj.weight"] = rng.randn(
            head_classes, width).astype(np.float32)
        out["blocks.5.proj.bias"] = np.zeros(head_classes, np.float32)
    return out


def reference_state_dict(variables, cfg, seed=0, prefix="", extras=True):
    """The model's variables (JAX layout, ``{"params": {"backbone",
    "head"}, "batch_stats"}``) -> a reference AGQAModel ``state_dict`` of
    numpy arrays, names prefixed with ``prefix`` (``"module."`` for a
    DataParallel save).  ``extras`` adds what the reference holds and the
    import skips: the unread cross variants of ``pooler_dict`` and
    ``cross_attn_layer`` (random), and pe rows past the model's tokens."""
    rng = np.random.RandomState(seed)
    head = variables["params"]["head"]
    enc = cfg.encoder
    d = enc.hidden_size
    out = {}
    lx = head["lxrt"]
    emb = lx["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{ENCODER}.embeddings.{name}.weight"] = emb[name]["embedding"]
    _layer_norm(out, f"{ENCODER}.embeddings.LayerNorm", emb["ln"])
    e = lx["encoder"]
    tok = e["visual_tokenizer"]
    vf = f"{ENCODER}.encoder.visn_fc"
    for name, idx in (("conv1", 1), ("conv2", 4)):
        out[f"{vf}.conv.{idx}.weight"] = _conv(tok[name]["kernel"])
        out[f"{vf}.conv.{idx}.bias"] = tok[name]["bias"]
    out[f"{vf}.cls_token"] = tok["cls_token"]
    pe = tok["pos_embedding"]
    if extras:
        pe = np.concatenate([pe, rng.randn(7, d).astype(np.float32)])
    out[f"{vf}.position_encoding.pe.weight"] = pe
    for i in range(enc.l_layers):
        _bert_layer(out, f"{ENCODER}.encoder.layer.{i}", e[f"l_{i}"])
    for i in range(enc.r_layers):
        _bert_layer(out, f"{ENCODER}.encoder.r_layers.{i}", e[f"r_{i}"])
    for i in range(enc.x_layers):
        _cross_layer(out, f"{ENCODER}.encoder.x_layers.{i}", e["x_tied"])
    _linear(out, f"{ENCODER}.pooler_dict.cross.dense2", lx["pooler"]["dense2"])

    hq = head["hgq_encoder"]
    for name in ("act_token", "rel_token", "cls_token"):
        out[f"hgq_encoder.{name}"] = hq[name]
    _cross_layer(out, "hgq_encoder.cross_attn_layer.cross", hq["x_tied"])
    _linear(out, "hgq_encoder.pooler_dict.cross.dense2",
            hq["pooler"]["dense2"])
    if extras:
        f = enc.intermediate_size
        for p in (f"{ENCODER}.pooler_dict.self.dense",
                  "hgq_encoder.pooler_dict.self.dense"):
            out[f"{p}.weight"] = rng.randn(d, d).astype(np.float32)
            out[f"{p}.bias"] = rng.randn(d).astype(np.float32)
        _random_self_variant(out, "hgq_encoder.cross_attn_layer.self", d, f,
                             rng)

    for name in ("relation_query_embed", "action_query_embed"):
        q = head[name]
        out[f"{name}.word_embeddings.weight"] = q["word_embeddings"][
            "embedding"]
        out[f"{name}.token_type_embeddings.weight"] = q[
            "token_type_embeddings"]["embedding"]
        _layer_norm(out, f"{name}.LayerNorm", q["ln"])
    for name in ("rel_decoder", "action_decoder"):
        for i in range(cfg.decoder.num_layers):
            _decoder_layer(out, f"{name}.layers.{i}", head[name][f"layer_{i}"])
    for name in ("class_embed", "action_embed", "logit_fc"):
        _linear(out, f"{name}.0", head[name]["fc1"])
        _layer_norm(out, f"{name}.2", head[name]["ln"])
        _linear(out, f"{name}.3", head[name]["fc2"])

    trunk = pytorchvideo_state_dict(variables["params"]["backbone"],
                                    variables["batch_stats"]["backbone"])
    out.update({f"vid_encoder.backbone.{k}": v for k, v in trunk.items()})
    return {prefix + k: v for k, v in out.items()}


def bert_state_dict(lxrt, extra_layers=0, seed=0):
    """The language tower of an LXRT tree (JAX layout) -> bert-base's names
    (``bert.`` prefix, LayerNorm ``gamma``/``beta``), with a pooler
    ``dense``, ``extra_layers`` random layers past the model's, and the
    masked-LM head's bias, which no model name matches."""
    rng = np.random.RandomState(seed)
    ln = ("gamma", "beta")
    out = {}
    emb = lxrt["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"bert.embeddings.{name}.weight"] = emb[name]["embedding"]
    _layer_norm(out, "bert.embeddings.LayerNorm", emb["ln"], ln)
    layers = [lxrt["encoder"][f"l_{i}"] for i in range(len(
        [k for k in lxrt["encoder"] if k.startswith("l_")]))]
    d = emb["ln"]["scale"].shape[0]

    def noise(tree):
        if isinstance(tree, dict):
            return {k: noise(v) for k, v in tree.items()}
        return rng.randn(*tree.shape).astype(np.float32)

    layers += [noise(layers[0]) for _ in range(extra_layers)]
    for i, layer in enumerate(layers):
        _bert_layer(out, f"bert.encoder.layer.{i}", layer, ln)
    out["bert.pooler.dense.weight"] = rng.randn(d, d).astype(np.float32)
    out["bert.pooler.dense.bias"] = rng.randn(d).astype(np.float32)
    vocab = emb["word_embeddings"]["embedding"].shape[0]
    out["cls.predictions.bias"] = rng.randn(vocab).astype(np.float32)
    return out


def save_torch(sd, path):
    """{name: np.ndarray} -> a torch ``state_dict`` file."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)


# -- the port's importers against the writers (no JAX) ----------------------

def _toy_model(monkeypatch, seed=0):
    from shgvqa_tpu_torch.models import shgvqa
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **R50_TOY))
    cfg = tiny_test_config(task="hgqa")
    return cfg, init_weights(VideoShgVqaModel(cfg), seed)


def _perturbed(model, seed):
    """The model's state with seeded noise on every tensor (variances kept
    positive), so no leaf equals another model's by accident."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in model.state_dict().items():
        noise = torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
        state[k] = (v.abs() + 0.5 + 0.1 * noise.abs() if k.endswith("_var")
                    else v + 0.05 * noise)
    model.load_state_dict(state)
    return model


def test_port_import_of_a_written_reference_gives_the_model_back(
        monkeypatch):
    cfg, model = _toy_model(monkeypatch)
    _perturbed(model, 1)
    want = model.state_dict()
    sd = reference_state_dict(to_jax_variables(want), cfg, prefix="module.")
    _, other = _toy_model(monkeypatch, seed=3)
    variables, report = reference_to_variables(
        sd, to_jax_variables(other.state_dict()), other.head.cfg)
    got = from_jax_variables(variables, other)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert len(report["mapped"]) == len(want) and not report["skipped"]


def test_converter_inverts_the_pytorchvideo_writer():
    trunk = SlowR50(torch.float32, **R50_TOY)
    tree = to_jax_variables(_perturbed(init_weights(trunk, 0),
                                       2).state_dict())
    sd = pytorchvideo_state_dict(tree["params"], tree["batch_stats"],
                                 head_classes=5)
    assert sum(k.endswith("num_batches_tracked") for k in sd) == 53
    back = convert_slow_r50.convert(
        {k: v for k, v in sd.items() if not k.startswith("blocks.5")})
    state = from_jax_variables(back, trunk)
    for k, v in trunk.state_dict().items():
        assert torch.equal(state[k], v), k


def test_bert_writer_loads_the_language_tower_and_skips_the_pooler(
        monkeypatch):
    _, model = _toy_model(monkeypatch)
    _perturbed(model, 4)
    lxrt = to_jax_variables(model.head.lxrt.state_dict())["params"]
    sd = bert_state_dict(lxrt, extra_layers=2)
    _, fresh = _toy_model(monkeypatch, seed=5)
    params, report = bert_to_lxrt_params(
        sd, to_jax_variables(fresh.head.lxrt.state_dict())["params"])
    # embeddings (3 tables + LayerNorm) and 2 layers of 16 tensors
    assert len(report["loaded"]) == 5 + 2 * 16
    assert report["skipped"] == ["pooler/dense (not in model)"]
    got = from_jax_variables({"params": params}, fresh.head.lxrt)
    for k, v in model.head.lxrt.state_dict().items():
        tower = k.startswith(("embeddings.", "encoder.l_"))
        assert torch.equal(got[k], v) == tower, k


@pytest.mark.parametrize("case", ["task_q", "cross_self", "slowfast"])
def test_what_the_port_does_not_run_raises_naming_its_item(monkeypatch,
                                                          case):
    cfg, model = _toy_model(monkeypatch)
    v = to_jax_variables(model.state_dict())
    sd = reference_state_dict(v, cfg)
    cfg = model.head.cfg
    if case == "task_q":
        cfg, item = cfg.replace(task="q"), "item 15"
    elif case == "cross_self":
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, cross_attn_type="cross_self"))
        item = "item 15"
    else:
        cfg, item = cfg.replace(backbone="slowfast_r50"), "item 17"
    with pytest.raises(NotImplementedError, match=item):
        reference_to_variables(sd, v, cfg)

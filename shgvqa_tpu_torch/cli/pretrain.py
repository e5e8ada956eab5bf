"""LXMERT-style pretraining driver: the port of ``shgvqa_tpu/cli/pretrain.py``.

    python -m shgvqa_tpu_torch.cli.pretrain [--taskMaskLM] [--taskMatched]
        [--taskQA] [--taskContrastive] [--taskObjPredict] ... [reference flags]

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.

Tasks (the reference's flags): ``--taskMaskLM`` masked-LM over the question
tokens (15%, 80/10/10), ``--taskMatched`` cross-modal matching with 50% of
the rows given another item's sentence, ``--taskQA`` answer classification
on matched rows with a known answer, ``--taskContrastive`` the cosine
embedding loss between the language CLS and the pooled output (target
``2 * is_matched - 1``), ``--taskObjPredict`` masked visual-feature
regression (``--visualLosses feat``).  No task flag: LM + matched + QA.

Data: ``--syntheticData N`` makes N items (features seeded by the CRC of
``feat{i}``); otherwise ``{dataDir}/pretrain_items.json`` lists ``{"sent",
"feat_file" (an .npz with ``feats``), "answer"?}``.  ``make_batch`` draws
from one ``numpy.random.RandomState(--seed)`` in JAX's order: the swap and
the permutation of the matched task, ``mask_words``, ``mask_visual_feats``;
the regression targets are subsampled to the tokenizer's time grid.

The optimizer is BertAdam over every parameter (``make_optimizer``, warmup
0.1, its default hyperparameters, as JAX's driver calls it), t_total the
epochs' steps.  The dropout masks and the attention kernels' seeds come
from one ``torch.Generator`` on the device, seeded from ``--seed``.  One
device: ``--multiGPU`` and ``--stepsPerLoop`` are ignored, as in JAX.
After each epoch it prints ``Epoch {e}: k=v ...`` (JAX's metric keys) and
writes ``{output}/Epoch{NN}_LXRT`` (``{"lxrt": state_dict}``, the file
``--loadLXMERT`` / ``--loadLXMERTQA`` read) and ``Epoch{NN}_qa_head.npz``
(``weight`` (answers, d), ``bias``, ``answers``: JAX's format, which either
package reads).  Returns the last step's metrics.
"""

from __future__ import annotations

import os
import sys
import zlib
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from shgvqa_tpu_torch.cli.common import build_tokenizer
from shgvqa_tpu_torch.configs import cli as cli_mod
from shgvqa_tpu_torch.data import featurize
from shgvqa_tpu_torch.entry import resolve_device
from shgvqa_tpu_torch.models.layers import init_weights
from shgvqa_tpu_torch.models.pretrain import (
    AnswerTable,
    LxmertPretrainModel,
    cosine_contrastive_loss,
    mask_visual_feats,
    mask_words,
    masked_lm_loss,
    matched_loss,
    visual_feat_loss,
)
from shgvqa_tpu_torch.train.loop import save_encoder_snapshot
from shgvqa_tpu_torch.train.optimizer import make_optimizer
from shgvqa_tpu_torch.utils.io import load_json_or_pickle

TASKS = ("task_mask_lm", "task_matched", "task_qa", "task_contrastive",
         "task_obj_predict")
MODEL_INPUTS = ("input_ids", "input_mask", "segment_ids", "visual_feats")


def synthetic_pretrain_items(n: int, cfg, n_answers: int = 16, seed: int = 0
                             ) -> List[dict]:
    rng = np.random.RandomState(seed)
    words = ["person", "opens", "door", "holds", "cup", "table", "walks",
             "room", "takes", "puts", "closes", "watches", "book", "food"]
    items = []
    for i in range(n):
        k = rng.randint(4, 10)
        items.append({
            "sent": " ".join(rng.choice(words, size=k)),
            "answer": f"ans{rng.randint(n_answers)}",
            "_seed": i,
        })
    return items


def default_tasks(pt: dict) -> dict:
    """The pretraining flags with the reference's default recipe (LM +
    matched + QA) when no task is asked for."""
    pt = dict(pt)
    if not any(pt[t] for t in TASKS):
        pt["task_mask_lm"] = pt["task_matched"] = pt["task_qa"] = True
    return pt


class PretrainItems(NamedTuple):
    """What ``make_batch`` reads: the encoded sentences, each item's answer
    id (-1 when none), a function giving item i's features (T_in, H, W, C),
    the [MASK] id, the vocabulary size and the tokenizer's time steps."""

    enc: Dict[str, np.ndarray]
    answers: np.ndarray
    feats: Callable[[int], np.ndarray]
    mask_id: int
    vocab_size: int
    visual_t: int


def item_features(items: List[dict], cfg) -> Callable[[int], np.ndarray]:
    """Item i's features: seeded by the CRC of ``feat{_seed}`` for a
    synthetic item, else the ``feats`` array of its ``feat_file``."""
    e = cfg.encoder
    t_in = e.visual_t + 8

    def feats_for(i: int) -> np.ndarray:
        it = items[i]
        if "_seed" in it:
            rng = np.random.RandomState(
                zlib.crc32(f"feat{it['_seed']}".encode()) % (2 ** 31))
            return rng.randn(t_in, e.visual_hw, e.visual_hw,
                             e.visual_feat_dim).astype(np.float32)
        with np.load(it["feat_file"]) as z:
            return z["feats"].astype(np.float32)

    return feats_for


def make_batch(idx: np.ndarray, rng: np.random.RandomState,
               data: PretrainItems, pt: dict) -> Dict[str, np.ndarray]:
    """The batch of items ``idx``, drawing from ``rng`` in the JAX driver's
    order."""
    enc = data.enc
    ids = enc["input_ids"][idx].copy()
    im = enc["input_mask"][idx].copy()
    seg = enc["segment_ids"][idx].copy()
    feats = np.stack([data.feats(int(i)) for i in idx])
    is_matched = np.ones((len(idx),), np.int32)
    if pt["task_matched"]:
        # 50% of rows get another item's sentence (lxmert_data 'matched')
        swap = rng.rand(len(idx)) < 0.5
        perm = rng.permutation(len(idx))
        for r in np.where(swap)[0]:
            o = perm[r]
            if int(idx[o]) != int(idx[r]):
                ids[r], im[r], seg[r] = (enc["input_ids"][idx[o]],
                                         enc["input_mask"][idx[o]],
                                         enc["segment_ids"][idx[o]])
                is_matched[r] = 0
    lm_labels = np.full_like(ids, -1)
    if pt["task_mask_lm"]:
        ids, lm_labels = mask_words(
            ids, im, mask_token_id=data.mask_id, vocab_size=data.vocab_size,
            rate=pt["word_mask_rate"], rng=rng)
    feat_mask = np.zeros(feats.shape[:-1], np.float32)
    feats_in = feats
    if pt["task_obj_predict"]:
        feats_in, feat_mask = mask_visual_feats(
            feats, rate=pt["obj_mask_rate"], rng=rng)
    # the targets at the token grid: the conv tokenizer compresses t_in to
    # visual_t, so the targets and the mask are subsampled to it
    sub = featurize.uniform_subsample_indices(feats.shape[1], data.visual_t)
    tgt_tok = feats[:, sub].reshape(len(idx), -1, feats.shape[-1])
    mask_tok = feat_mask[:, sub].reshape(len(idx), -1)
    return {
        "input_ids": ids.astype(np.int32),
        "input_mask": im.astype(np.int32),
        "segment_ids": seg.astype(np.int32),
        "visual_feats": feats_in,
        "visual_target": tgt_tok,
        "feat_mask": mask_tok,
        "lm_labels": lm_labels.astype(np.int32),
        "is_matched": is_matched,
        "qa_labels": data.answers[idx],
    }


def pretrain_losses(pt: dict, out: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor]):
    """(total, metrics) of the tasks ``pt`` asks for, JAX's keys."""
    metrics = {}
    total = torch.zeros((), dtype=torch.float32,
                        device=out["pooled"].device)
    if pt["task_mask_lm"]:
        metrics["lm_loss"] = masked_lm_loss(out["lm_logits"],
                                            batch["lm_labels"])
    if pt["task_matched"]:
        metrics["matched_loss"] = matched_loss(out["matched_logits"],
                                               batch["is_matched"])
    if pt["task_qa"]:
        # QA on matched rows with a known answer (lxmert_pretrain masks
        # mismatched sentences out of the QA loss)
        logp = torch.log_softmax(out["qa_logits"].float(), -1)
        labels = batch["qa_labels"].long()
        valid = (batch["is_matched"] > 0) & (labels >= 0)
        nll = -torch.gather(logp, 1, labels.clamp(min=0)[:, None])[:, 0]
        metrics["qa_loss"] = (torch.where(valid, nll, 0.0).sum()
                              / valid.sum().clamp(min=1))
    if pt["task_contrastive"]:
        metrics["contrastive_loss"] = cosine_contrastive_loss(
            out["lang_cls"], out["pooled"], batch["is_matched"] * 2 - 1)
    if pt["task_obj_predict"] and "feat" in pt["visual_losses"]:
        metrics["visn_loss"] = visual_feat_loss(
            out["visn_pred"], batch["visual_target"], batch["feat_mask"])
    for value in metrics.values():
        total = total + value
    metrics["total_loss"] = total
    return total, metrics


def make_pretrain_step(model: LxmertPretrainModel, optimizer, pt: dict):
    """``step(batch, generator) -> metrics``: one dropout-bearing forward,
    the losses, the backward and the optimizer update, on the device."""

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        out = model({k: batch[k] for k in MODEL_INPUTS}, generator)
        total, metrics = pretrain_losses(pt, out, batch)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def to_device(batch: Dict[str, np.ndarray], dev: torch.device
              ) -> Dict[str, torch.Tensor]:
    pin = dev.type == "cuda"
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = (t.pin_memory() if pin else t).to(dev, non_blocking=pin)
    return out


def main(argv=None, device="cuda") -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    # resolved at call time, so a caller may wrap the parser
    cfg, extras = cli_mod.parse_reference_flags_with_extras(argv,
                                                            dataset="agqa")
    pt = default_tasks(extras["pretrain"])
    dev = resolve_device(device)
    n_syn = extras.get("synthetic_data") or 0
    items = (synthetic_pretrain_items(n_syn, cfg) if n_syn else
             load_json_or_pickle(os.path.join(cfg.data.data_dir,
                                              "pretrain_items.json")))
    tok = build_tokenizer(cfg, extras, [x["sent"] for x in items])
    table = AnswerTable([x.get("answer", "") for x in items
                         if x.get("answer")])
    num_answers = max(len(table), 2)
    e = cfg.encoder
    data = PretrainItems(
        enc=featurize.encode_questions([x["sent"] for x in items], tok,
                                       cfg.data.max_seq_length),
        answers=np.array([table.convert(x.get("answer", "")) for x in items],
                         np.int32),
        feats=item_features(items, cfg), mask_id=tok.vocab.get("[MASK]", 1),
        vocab_size=e.vocab_size, visual_t=e.visual_t)

    model = init_weights(LxmertPretrainModel(cfg, num_answers).to(dev),
                         cfg.seed).train()
    bsz = cfg.optim.batch_size
    steps_per_epoch = max(1, len(items) // bsz)
    optimizer = make_optimizer(model, cfg.optim.lr,
                               steps_per_epoch * cfg.optim.epochs,
                               warmup=0.1)
    step = make_pretrain_step(model, optimizer, pt)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    name = (f"cuda ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else str(dev))
    print(f"shgvqa_tpu_torch pretraining: {len(items)} items, "
          f"{num_answers} answers, tasks "
          f"{[t for t in TASKS if pt[t]]}, device={name}", flush=True)

    rng = np.random.RandomState(cfg.seed)
    # JAX's driver draws its init's example batch first: the same draws
    make_batch(np.arange(min(bsz, len(items))), rng, data, pt)
    os.makedirs(cfg.output, exist_ok=True)
    last: Dict[str, float] = {}
    metrics = None
    for epoch in range(cfg.optim.epochs):
        order = rng.permutation(len(items))
        for s in range(steps_per_epoch):
            idx = order[s * bsz:(s + 1) * bsz]
            if len(idx) < bsz:
                break
            batch = to_device(make_batch(idx, rng, data, pt), dev)
            metrics = step(batch, generator)
        if metrics is not None:
            last = {k: float(v) for k, v in metrics.items()}
        print(f"Epoch {epoch}: " + " ".join(
            f"{k}={v:0.4f}" for k, v in sorted(last.items())), flush=True)

        # the encoder snapshot, in Trainer.load_encoder's format, and the
        # QA head's last layer in JAX's npz format
        save_encoder_snapshot(
            os.path.join(os.path.abspath(cfg.output),
                         f"Epoch{epoch:02d}_LXRT"), "lxrt", model.lxrt)
        fc2 = model.heads.qa_head.fc2
        np.savez(os.path.join(cfg.output, f"Epoch{epoch:02d}_qa_head.npz"),
                 weight=fc2.weight.detach().cpu().numpy(),
                 bias=fc2.bias.detach().cpu().numpy(),
                 answers=np.array([table.id2ans[i]
                                   for i in range(len(table))]))
    print(f"pretraining done: {cfg.optim.epochs} epochs, "
          f"snapshots in {cfg.output}", flush=True)
    return last


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

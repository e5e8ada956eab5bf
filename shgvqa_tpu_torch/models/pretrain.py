"""LXMERT-style pretraining: the port of ``shgvqa_tpu/models/pretrain.py``.

- ``LMPredictionHead``: transform (dense, GeLU, LayerNorm), then the
  decoder TIED to the word-embedding table, plus a bias;
- ``PretrainingHeads``: the masked-LM head, cross-modal matching (pooled ->
  2) and QA (pooled -> answers, an ``MLPHead`` shaped like the fine-tune
  ``logit_fc`` so its last layer's rows transplant per answer);
- ``LxmertPretrainModel``: the LXRT encoder (``lxrt``, so its snapshots load
  with ``--loadLXMERT``), the heads and ``visn_head``, the visual-feature
  regression over the non-CLS visual tokens;
- the losses ``masked_lm_loss``, ``matched_loss``,
  ``cosine_contrastive_loss`` (torch's ``CosineEmbeddingLoss``) and
  ``visual_feat_loss``;
- the host-side numpy masking ``mask_words`` (15%, 80/10/10) and
  ``mask_visual_feats``, copies of the JAX functions with the same
  ``RandomState`` calls in the same order;
- ``answer_head_surgery`` and ``AnswerTable``, the answer-string transplant
  of ``--loadLXMERTQA``.

Numerics kept from JAX: only ``lxrt`` computes in the compute dtype; the
heads and ``visn_head`` compute in f32 (flax modules built without a
dtype).  The masked-LM decoder reads the raw f32 embedding parameter, so
every row of the table, row 0 included, gets the decoder's gradient (the
lookup alone freezes row 0).  The LXRT gets the config's kernel switches,
as the task models do; JAX's pretraining model applies no remat to it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shgvqa_tpu_torch.configs.config import Config, torch_dtype
from shgvqa_tpu_torch.models.encoder import LXRTModel
from shgvqa_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MLPHead,
    empty_param,
    gelu,
    set_attention_kernel_eval,
    set_ffn_train_kernel,
)


class LMPredictionHead(nn.Module):
    """transform -> decode against the tied word-embedding table."""

    def __init__(self, hidden_size: int, vocab_size: int):
        super().__init__()
        self.transform_dense = Dense(hidden_size, hidden_size)
        self.transform_ln = LayerNorm(hidden_size)
        self.bias = empty_param(vocab_size)

    def init_params(self, g):
        self.bias.zero_()

    def forward(self, hidden: torch.Tensor,
                word_embedding_table: torch.Tensor) -> torch.Tensor:
        h = self.transform_ln(gelu(self.transform_dense(hidden)))
        logits = torch.einsum("bld,vd->blv", h,
                              word_embedding_table.to(h.dtype))
        return logits + self.bias.to(h.dtype)


class PretrainingHeads(nn.Module):
    """Masked-LM + cross-modal matching + QA heads over encoder outputs."""

    def __init__(self, hidden_size: int, vocab_size: int, num_answers: int):
        super().__init__()
        self.lm_head = LMPredictionHead(hidden_size, vocab_size)
        self.seq_relationship = Dense(hidden_size, 2)
        self.qa_head = MLPHead(hidden_size, num_answers)

    def forward(self, lang_feats, pooled, word_embedding_table
                ) -> Dict[str, torch.Tensor]:
        return {
            "lm_logits": self.lm_head(lang_feats, word_embedding_table),
            "matched_logits": self.seq_relationship(pooled),
            "qa_logits": self.qa_head(pooled),
        }


class LxmertPretrainModel(nn.Module):
    """LXRT encoder + pretraining heads (LXRTPretraining); the encoder is
    ``lxrt``, as in the task models, so a snapshot of it loads with
    ``Trainer.load_encoder``."""

    def __init__(self, cfg: Config, num_answers: int = 2):
        super().__init__()
        e = cfg.encoder
        self.cfg = cfg
        kernel_train = (cfg.use_pallas_attention_train
                        or cfg.use_pallas_attention)
        self.lxrt = LXRTModel(e, torch_dtype(cfg.compute_dtype),
                              cfg.use_pallas_ffn, kernel_train)
        self.heads = PretrainingHeads(e.hidden_size, e.vocab_size,
                                      num_answers)
        self.visn_head = Dense(e.hidden_size, e.visual_feat_dim)
        set_ffn_train_kernel(self, cfg.use_pallas_ffn_train)
        set_attention_kernel_eval(self, cfg.use_pallas_attention)

    def word_table(self) -> torch.Tensor:
        """The raw word-embedding parameter the masked-LM decoder is tied
        to."""
        return self.lxrt.embeddings.word_embeddings.weight

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: input_ids, input_mask, segment_ids (B, Lt); visual_feats
        (B, T, H, W, C); optional visual_mask.  Returns lm_logits (B, Lt, V),
        matched_logits (B, 2), qa_logits (B, answers), visn_pred (B, Lv - 1,
        C), pooled and lang_cls (B, D)."""
        pooled, lang, visn, *_ = self.lxrt(
            batch["input_ids"], batch["input_mask"], batch.get("segment_ids"),
            batch["visual_feats"], batch.get("visual_mask"), generator)
        out = self.heads(lang, pooled, self.word_table())
        out["visn_pred"] = self.visn_head(visn[:, 1:])
        out["pooled"] = pooled
        out["lang_cls"] = lang[:, 0]
        return out


# -- losses -----------------------------------------------------------------

def masked_lm_loss(lm_logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """CE over positions with label >= 0 (-1 = unmasked/ignored)."""
    logp = torch.log_softmax(lm_logits.float(), dim=-1)
    valid = labels >= 0
    idx = labels.clamp(min=0).long()
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def matched_loss(matched_logits: torch.Tensor, is_matched: torch.Tensor
                 ) -> torch.Tensor:
    logp = torch.log_softmax(matched_logits.float(), dim=-1)
    return -torch.gather(logp, 1, is_matched.long()[:, None]).mean()


def cosine_contrastive_loss(a: torch.Tensor, b: torch.Tensor,
                            target: torch.Tensor, margin: float = 0.1
                            ) -> torch.Tensor:
    """torch CosineEmbeddingLoss: target +1 -> 1-cos, -1 -> max(0, cos-m)."""
    a32, b32 = a.float(), b.float()
    cos = (a32 * b32).sum(-1) / (
        torch.linalg.vector_norm(a32, dim=-1)
        * torch.linalg.vector_norm(b32, dim=-1) + 1e-8)
    pos = 1.0 - cos
    neg = torch.clamp(cos - margin, min=0.0)
    return torch.where(target > 0, pos, neg).mean()


def visual_feat_loss(pred: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """L2 on masked visual features (visual_loss_config 'feat')."""
    per_tok = ((pred.float() - target.float()) ** 2).mean(-1)
    m = mask.float()
    return (per_tok * m).sum() / m.sum().clamp(min=1)


# -- masking utilities (host-side, numpy) -----------------------------------

def mask_words(input_ids: np.ndarray, input_mask: np.ndarray,
               vocab_size: int, mask_token_id: int,
               rate: float = 0.15, rng: Optional[np.random.RandomState] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """BERT 80/10/10 masking.  Returns (masked_ids, lm_labels with -1 on
    unmasked)."""
    rng = rng or np.random.RandomState(0)
    ids = input_ids.copy()
    labels = np.full_like(ids, -1)
    candidates = input_mask.astype(bool)
    # never mask position 0 ([CLS])
    candidates[..., 0] = False
    pick = (rng.rand(*ids.shape) < rate) & candidates
    labels[pick] = ids[pick]
    roll = rng.rand(*ids.shape)
    ids[pick & (roll < 0.8)] = mask_token_id
    rand_ids = rng.randint(0, vocab_size, ids.shape)
    replace = pick & (roll >= 0.8) & (roll < 0.9)
    ids[replace] = rand_ids[replace]
    return ids, labels


def mask_visual_feats(feats: np.ndarray, rate: float = 0.15,
                      rng: Optional[np.random.RandomState] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero out a fraction of visual tokens; returns (masked, mask)."""
    rng = rng or np.random.RandomState(0)
    mask = rng.rand(*feats.shape[:-1]) < rate
    out = feats.copy()
    out[mask] = 0.0
    return out, mask


# -- answer-head surgery (--loadLXMERTQA) -----------------------------------

def answer_head_surgery(ans_weight: np.ndarray, ans_bias: np.ndarray,
                        model_weight: np.ndarray, model_bias: np.ndarray,
                        label2ans, table: "AnswerTable"
                        ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """load_lxmert_qa's surgery (qa_answer_table.py:118-143): each fine-tune
    label whose normalized answer is in the pretraining table gets that row
    of the pretrained head (weight (n, d), bias (n,)); the other rows are
    ZEROED.  Returns (new_weight, new_bias, loaded, unloaded)."""
    new_w = np.array(model_weight, copy=True)
    new_b = np.array(model_bias, copy=True)
    if isinstance(label2ans, (list, tuple)):
        label2ans = dict(enumerate(label2ans))
    loaded = unloaded = 0
    for label, ans in label2ans.items():
        idx = table.convert(ans)
        if idx >= 0:
            new_w[label] = ans_weight[idx]
            new_b[label] = ans_bias[idx]
            loaded += 1
        else:
            new_w[label] = 0.0
            new_b[label] = 0.0
            unloaded += 1
    return new_w, new_b, loaded, unloaded


class AnswerTable:
    """Cross-dataset answer normalization
    (``pretrain/qa_answer_table.py:8-81``): canonicalize answer strings
    (case, punctuation, leading article) and map them to ids."""

    _STRIP = ("a ", "an ", "the ")

    def __init__(self, answers):
        self.ans2id: Dict[str, int] = {}
        for ans in answers:
            norm = self.normalize(ans)
            if norm not in self.ans2id:
                self.ans2id[norm] = len(self.ans2id)
        self.id2ans = {i: a for a, i in self.ans2id.items()}

    @classmethod
    def normalize(cls, ans: str) -> str:
        out = ans.strip().lower().replace(",", "").replace(".", "")
        for art in cls._STRIP:
            if out.startswith(art):
                out = out[len(art):]
        return out.strip()

    def convert(self, ans: str) -> int:
        return self.ans2id.get(self.normalize(ans), -1)

    def __len__(self) -> int:
        return len(self.ans2id)

"""STAR dataset: the port's own copy of ``shgvqa_tpu/data/star.py``, a
rebuild of ``STARDataset``/``STARTorchDataset`` (``star_data.py:28-291``).

Semantics preserved:
- 4-way multiple choice: the QA string packs question + choices via
  QAInputArrange (``data_transforms.py:137-165``), all choices in one
  string (``add_sep_all`` / ``no_sep_all``), or per choice (``add_sep`` /
  ``no_sep``: four encodings an item, each scored by the model's scalar
  choice head); answer target is the choice index
  (``star_data.py:250-252``).
- question-type filtering: keep datums whose question_id contains --qType;
  during TRAINING, Prediction/Feasibility are augmented with
  Interaction/Sequence questions over videos from
  ``nopred_nofeas_vid_ids_train.json`` (``star_data.py:167-171``).
- --mergeData de-leak: drop Interaction/Sequence questions whose video also
  appears in Prediction/Feasibility (``vis_utils.get_merged_data:130-159``);
  eval or --mergeAll keep everything.
- keyframe trimming: sorted situation keyframes sampled every
  ``len // clip_len`` (``vis_utils.sample_frames:12-18``), then
  nearest-neighbor subsample to clip_len.
- per-situation labels from ``datum['situations']``: rel triplets built from
  (rel_pairs x rel_labels) tokenized through the 563-triplet vocab, actions
  through the 111-action vocab (``star_data.py:262-283``); synthetic data
  carries pre-tokenized ``rel_labels``/``actions`` lists.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from shgvqa_tpu_torch.configs.config import PER_CHOICE, Config
from shgvqa_tpu_torch.data import featurize
from shgvqa_tpu_torch.data import synthetic as synth
from shgvqa_tpu_torch.evalsuite.star import STAREvaluator
from shgvqa_tpu_torch.utils.io import load_json_or_pickle

TINY_SIZE = 512
FAST_SIZE = 5000

QA_ARRANGERS = {
    # data_transforms.py:144-151
    "add_sep_all": lambda q, ch: q + " [SEP] " + " ".join(
        f" {k}: {v} [SEP]" for k, v in ch.items()),
    "no_sep_all": lambda q, ch: q + " " + " ".join(
        f" {k}: {v}" for k, v in ch.items()),
    "add_sep": lambda q, ch: {
        f"qa{k}": f"{q} [SEP] {k}: {v}" for k, v in ch.items()},
    "no_sep": lambda q, ch: {
        f"qa{k}": f"{q} {k}: {v}" for k, v in ch.items()},
}


def sample_frames(frame_ids: Sequence[str], max_show_num: int) -> List[str]:
    """vis_utils.sample_frames:12-18 — every len//max_show_num-th frame."""
    if max_show_num == 0:
        return list(frame_ids)
    max_show_num = min(len(frame_ids), max_show_num)
    interval = len(frame_ids) // max_show_num
    return list(frame_ids)[::max(interval, 1)]


def trim_keyframes(datum: dict, clip_len: int) -> List[str]:
    """Sorted situation keyframes, strided sampling (vis_utils:21-34)."""
    fids = sorted(datum["situations"].keys())
    return sample_frames(fids, clip_len)


def get_merged_data(data: List[dict]) -> Dict[str, List[dict]]:
    """De-leak merge (vis_utils.get_merged_data:130-159): Interaction/
    Sequence drop videos shared with Prediction/Feasibility."""
    by_qtype: Dict[str, List[dict]] = {
        "Interaction": [], "Sequence": [], "Prediction": [], "Feasibility": []
    }
    for qa in data:
        qtype = qa["question_id"].split("_")[0]
        if qtype in by_qtype:
            by_qtype[qtype].append(qa)
    vids = {q: {d["video_id"] for d in ds} for q, ds in by_qtype.items()}
    leaky = (vids["Interaction"] | vids["Sequence"]) & (
        vids["Prediction"] | vids["Feasibility"])
    out = {}
    for qtype, ds in by_qtype.items():
        if qtype in ("Interaction", "Sequence"):
            out[qtype] = [d for d in ds if d["video_id"] not in leaky]
        else:
            out[qtype] = ds
    return out


class STARData:
    def __init__(self, split: str, datums: List[dict], cfg: Optional[Config]
                 = None, augment_vid_ids: Optional[set] = None,
                 rel_vocab: Optional[dict] = None,
                 act_vocab: Optional[dict] = None):
        cfg = cfg or Config()
        self.split = split
        self.cfg = cfg
        d = cfg.data
        is_eval = split in ("test", "valid", "val")

        if d.tiny:
            datums = datums[:TINY_SIZE]
        elif d.fast:
            datums = datums[:FAST_SIZE]

        if d.merge_data:
            if is_eval or d.merge_all:
                selected = list(datums)
            else:
                merged = get_merged_data(datums)
                selected = [x for ds in merged.values() for x in ds]
        else:
            selected = []
            augment_vid_ids = augment_vid_ids or set()
            for datum in datums:
                if d.qtype in datum["question_id"]:
                    selected.append(datum)
                elif (d.qtype in ("Prediction", "Feasibility")
                      and datum["video_id"] in augment_vid_ids
                      and not is_eval):
                    selected.append(datum)

        self.datums = selected
        self.id2datum = {x["question_id"]: x for x in selected}
        self.rel_vocab = rel_vocab    # triplet -> idx (rel_triplets_rp2idx)
        self.act_vocab = act_vocab    # action tag -> idx (actions_rp2idx)
        self.ans2label = {"0": 0, "1": 1, "2": 2, "3": 3}

    @property
    def num_answers(self) -> int:
        return 4

    def __len__(self) -> int:
        return len(self.datums)

    def evaluator(self) -> STAREvaluator:
        return STAREvaluator(self.id2datum)

    @classmethod
    def from_files(cls, cfg: Config, split: str) -> "STARData":
        d = cfg.data
        root = d.data_dir
        name = (f"STAR_{split}.json" if split == "test"
                else f"STAR_{split}_updated.json")
        datums = load_json_or_pickle(os.path.join(root, name))
        rel = load_json_or_pickle(
            os.path.join(root, "relationship_triplets.json"))
        act = load_json_or_pickle(
            os.path.join(root, "action_dictionaries.json"))
        aug_path = os.path.join(root, "nopred_nofeas_vid_ids_train.json")
        aug = set(load_json_or_pickle(aug_path)) if os.path.isfile(aug_path) \
            else set()
        return cls(split, datums, cfg, aug,
                   rel_vocab=rel.get("rel_triplets_rp2idx", rel),
                   act_vocab=act.get("actions_rp2idx", act))

    @classmethod
    def synthetic(cls, cfg: Config, split: str = "train", n: int = 64,
                  seed: int = 0) -> "STARData":
        datums, _fps = synth.make_star_data(
            n=n,
            num_rel_classes=cfg.num_rel_classes,
            num_act_classes=cfg.num_act_classes,
            max_rel=cfg.data.num_rel,
            max_act=cfg.data.num_act,
            seed=seed,
        )
        return cls(split, datums, cfg)


class STARItemSource:
    """Featurized items with QA-choice packing and situation labels."""

    def __init__(self, data: STARData, tokenizer, cfg: Config,
                 frame_loader=None, test_mode: bool = False):
        self.data = data
        self.cfg = cfg
        self.test_mode = test_mode
        self.frame_loader = frame_loader
        d = cfg.data
        arrange = QA_ARRANGERS[d.qa_arrange_type]
        self.per_choice = d.qa_arrange_type in PER_CHOICE
        texts = []
        choice_texts = []
        for datum in data.datums:
            qa = arrange(datum["question"], self._choices(datum))
            if isinstance(qa, dict):
                # per-choice arrangement: four encodings an item, the
                # question alone as the primary text
                choice_texts.append([qa[f"qa{i}"] for i in range(len(qa))])
                texts.append(datum["question"])
            else:
                texts.append(qa)
        self.text = featurize.encode_questions(
            texts, tokenizer, d.max_seq_length)
        self.choice_text = None
        if self.per_choice and choice_texts:
            n, c = len(choice_texts), len(choice_texts[0])
            flat = [t for row in choice_texts for t in row]
            enc = featurize.encode_questions(flat, tokenizer,
                                             d.max_seq_length)
            self.choice_text = {k: v.reshape(n, c, d.max_seq_length)
                                for k, v in enc.items()}

    @staticmethod
    def _choices(datum: dict) -> Dict[str, str]:
        ch = datum["choices"]
        if isinstance(ch, list):
            # real STAR schema: [{'choice_id': int, 'choice': str}, ...]
            return {str(c["choice_id"]): c["choice"] for c in ch}
        return {str(k): v for k, v in ch.items()}

    def __len__(self) -> int:
        return len(self.data.datums)

    def _situation_labels(self, datum: dict, fids: List[str]):
        """Tokenized per-frame (rel, act) label lists."""
        rels, acts = [], []
        for f in fids:
            situ = datum["situations"][f]
            if "rel_labels" in situ and self.data.rel_vocab is None:
                rel_tokens = list(situ["rel_labels"])
            else:
                triplets = [
                    (rp[0], rl, rp[1])
                    for rp, rl in zip(situ["rel_pairs"], situ["rel_labels"])
                ]
                rel_tokens = [self.data.rel_vocab[t] for t in triplets]
            if self.data.act_vocab is None:
                act_tokens = list(situ["actions"])
            else:
                act_tokens = [self.data.act_vocab[a] for a in situ["actions"]]
            rels.append(rel_tokens)
            acts.append(act_tokens)
        return rels, acts

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        d = cfg.data
        datum = self.data.datums[i]
        vid = datum["video_id"]
        item: Dict[str, np.ndarray] = {
            "ques_id": datum["question_id"],
            "input_ids": self.text["input_ids"][i],
            "input_mask": self.text["input_mask"][i],
            "segment_ids": self.text["segment_ids"][i],
        }
        if self.choice_text is not None:
            for k in ("input_ids", "input_mask", "segment_ids"):
                item[f"choice_{k}"] = self.choice_text[k][i]
        if cfg.task != "q":
            if self.frame_loader is not None:
                fids = trim_keyframes(datum, d.clip_len)
                item["frames"] = self.frame_loader(vid, fids)
            item["visual_mask"] = np.ones(
                (cfg.encoder.visual_seq_length,), np.int32)

        has_labels = "answer_choice" in datum or "answer" in datum
        if cfg.task in ("hgqa", "vhga", "hgvqa"):
            if not has_labels or self.test_mode:
                item["hg_mask"] = np.ones(
                    (d.num_situations, d.num_act + d.num_rel), np.int32)
                item["rel_labels"] = np.zeros(
                    (d.num_situations, d.num_rel), np.int32)
                item["rel_lengths"] = np.zeros((d.num_situations,), np.int32)
                item["act_labels"] = np.zeros(
                    (d.num_situations, d.num_act), np.int32)
                item["act_lengths"] = np.zeros((d.num_situations,), np.int32)
            else:
                fids = trim_keyframes(datum, d.clip_len)
                rels, acts = self._situation_labels(datum, fids)
                rel = featurize.pack_hg_labels(rels, d.num_situations,
                                               d.num_rel)
                act = featurize.pack_hg_labels(acts, d.num_situations,
                                               d.num_act)
                item["rel_labels"] = rel["labels"]
                item["rel_lengths"] = rel["lengths"]
                item["act_labels"] = act["labels"]
                item["act_lengths"] = act["lengths"]
                item["hg_mask"] = featurize.hg_token_mask(
                    act["labels"], rel["labels"])
                if cfg.gt_hg:
                    item["rel_tgt_ids"] = rel["labels"].reshape(-1)
                    item["act_tgt_ids"] = act["labels"].reshape(-1)

        target = np.zeros((4,), np.float32)
        answer_idx = -1
        if has_labels and not self.test_mode:
            answer_idx = int(datum["answer_choice"])
            target[answer_idx] = 1.0
        item["target"] = target
        item["answer_idx"] = np.int32(answer_idx)
        return item

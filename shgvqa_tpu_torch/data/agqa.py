"""AGQA 2.0 dataset: the port's own copy of ``shgvqa_tpu/data/agqa.py``.

A featurizing item source over the annotation files (or in-memory
synthetic data), giving the numpy items the ``Batcher`` stacks.

Expected ``data_dir`` layout (the reference's artifacts; JSON or pickle):
- ``{split}_balanced.json``            list of QA datums
- ``trainVal_vocab.json``              answer string -> index
- ``frameTriplets.json``               video_id -> frame_id -> [rel ids >= 1]
- ``frameActions.json``                video_id -> frame_id -> [act ids >= 1]
- ``trimmed_frame_ids.json``           video_id -> ordered frame id list
- frames under ``frame_dir/{video_id}.mp4/{frame_id}.png``

Protocol filters: with --novelComp the train split keeps ``novel_comp ==
0`` and eval splits keep ``== 1``; --compSteps filters on ``more_steps``
the same way; --tiny/--fast truncate the split.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from shgvqa_tpu_torch.configs.config import Config
from shgvqa_tpu_torch.data import featurize
from shgvqa_tpu_torch.data import synthetic as synth
from shgvqa_tpu_torch.evalsuite.agqa import AGQAEvaluator
from shgvqa_tpu_torch.utils.io import load_json_or_pickle

TINY_SIZE = 512
FAST_SIZE = 5000


class AGQAData:
    """Annotations + vocabularies for one split."""

    def __init__(
        self,
        split: str,
        datums: List[dict],
        answer_vocab: Dict[str, int],
        frame_triplets: Dict[str, dict],
        frame_actions: Dict[str, dict],
        frame_ids: Dict[str, list],
        cfg: Optional[Config] = None,
    ):
        cfg = cfg or Config()
        self.split = split
        self.cfg = cfg
        d = cfg.data

        if d.novel_comp:
            keep = 0 if split == d.train_split else 1
            datums = [x for x in datums if x.get("novel_comp") == keep]
        if d.comp_steps:
            keep = 0 if split == d.train_split else 1
            datums = [x for x in datums if x.get("more_steps") == keep]
        if d.tiny:
            datums = datums[:TINY_SIZE]
        elif d.fast:
            datums = datums[:FAST_SIZE]

        self.datums = datums
        self.answer_vocab = answer_vocab
        self.frame_triplets = frame_triplets
        self.frame_actions = frame_actions
        self.frame_ids = frame_ids
        self.id2datum = {x["question_id"]: x for x in datums}

    @property
    def num_answers(self) -> int:
        return len(self.answer_vocab)

    def __len__(self) -> int:
        return len(self.datums)

    def evaluator(self) -> AGQAEvaluator:
        return AGQAEvaluator(self.id2datum, self.answer_vocab)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_files(cls, cfg: Config, split: str) -> "AGQAData":
        d = cfg.data
        root = d.data_dir
        # --trainSubSet swaps the train annotation file for the curated
        # subset (agqa_data.py:66-74 loads new-sub-train.json)
        if d.train_sub_set and split == d.train_split:
            name = "new-sub-train.json"
        else:
            name = f"{split}_balanced.json"
        datums = load_json_or_pickle(os.path.join(root, name))
        vocab = load_json_or_pickle(os.path.join(root, "trainVal_vocab.json"))
        triplets = load_json_or_pickle(
            os.path.join(root, "frameTriplets.json"))
        actions = load_json_or_pickle(os.path.join(root, "frameActions.json"))
        frame_ids = load_json_or_pickle(
            os.path.join(root, "trimmed_frame_ids.json"))
        return cls(split, datums, vocab, triplets, actions, frame_ids, cfg)

    @classmethod
    def synthetic(cls, cfg: Config, split: str = "train", n: int = 64,
                  seed: int = 0) -> "AGQAData":
        datums, vocab, triplets, actions, frame_ids = synth.make_agqa_data(
            n=n,
            num_rel_classes=cfg.num_rel_classes,
            num_act_classes=cfg.num_act_classes,
            max_rel=cfg.data.num_rel,
            max_act=cfg.data.num_act,
            seed=seed,
        )
        return cls(split, datums, vocab, triplets, actions, frame_ids, cfg)


class AGQAItemSource:
    """Per-item featurization -> fixed-shape numpy dicts for the pipeline.
    Questions are tokenized once, up front."""

    def __init__(self, data: AGQAData, tokenizer, cfg: Config,
                 frame_loader=None, test_mode: bool = False):
        self.data = data
        self.cfg = cfg
        self.test_mode = test_mode
        self.frame_loader = frame_loader
        d = cfg.data
        questions = [x["question"] for x in data.datums]
        self.text = featurize.encode_questions(
            questions, tokenizer, d.max_seq_length)
        self.num_answers = cfg.num_answers

    def __len__(self) -> int:
        return len(self.data.datums)

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

        if cfg.task != "q":
            if self.frame_loader is not None:
                item["frames"] = self.frame_loader(vid)
            item["visual_mask"] = np.ones(
                (cfg.encoder.visual_seq_length,), np.int32)

        if cfg.task in ("hgqa", "vhga", "hgvqa"):
            if self.test_mode:
                # test items carry no HG labels: an all-ones hg_mask and
                # zero label grids
                item["hg_mask"] = np.ones(
                    (d.num_situations, d.num_act + d.num_rel), np.int32)
                item["rel_labels"] = np.zeros(
                    (d.num_situations, d.num_rel), np.int32)
                item["rel_lengths"] = np.zeros((d.num_situations,), np.int32)
                item["act_labels"] = np.zeros(
                    (d.num_situations, d.num_act), np.int32)
                item["act_lengths"] = np.zeros((d.num_situations,), np.int32)
            else:
                fids = self.data.frame_ids[vid]
                rel = featurize.pack_hg_labels(
                    [self.data.frame_triplets[vid][f] for f in fids],
                    d.num_situations, d.num_rel)
                act = featurize.pack_hg_labels(
                    [self.data.frame_actions[vid][f] for f in fids],
                    d.num_situations, d.num_act)
                item["rel_labels"] = rel["labels"]
                item["rel_lengths"] = rel["lengths"]
                item["act_labels"] = act["labels"]
                item["act_lengths"] = act["lengths"]
                item["hg_mask"] = featurize.hg_token_mask(
                    act["labels"], rel["labels"])
                if cfg.gt_hg:
                    item["rel_tgt_ids"] = rel["labels"].reshape(-1)
                    item["act_tgt_ids"] = act["labels"].reshape(-1)

        target = np.zeros((self.num_answers,), np.float32)
        if not self.test_mode and "answer" in datum:
            target[int(self.data.answer_vocab[datum["answer"]])] = 1.0
        item["target"] = target
        item["answer_idx"] = np.int32(
            self.data.answer_vocab.get(datum.get("answer"), -1)
            if not self.test_mode else -1
        )
        return item


class FrameLoader:
    """Decode the trimmed clip's PNG frames with PIL, resized on the host;
    normalization runs on the device."""

    def __init__(self, frame_dir: str, frame_ids: Dict[str, list],
                 clip_len: int, image_size: int):
        self.frame_dir = frame_dir
        self.frame_ids = frame_ids
        self.clip_len = clip_len
        self.image_size = image_size

    def __call__(self, vid: str, fids=None) -> np.ndarray:
        from PIL import Image

        fids = fids if fids is not None else self.frame_ids[vid]
        idx = featurize.uniform_subsample_indices(len(fids), self.clip_len)
        frames = []
        for i in idx:
            path = os.path.join(
                self.frame_dir, f"{vid}.mp4", f"{fids[int(i)]}.png")
            with Image.open(path) as im:
                im = im.convert("RGB").resize(
                    (self.image_size, self.image_size), Image.BILINEAR)
                frames.append(np.asarray(im, np.uint8))
        return np.stack(frames)


class SyntheticFrameLoader:
    """Deterministic fake frames keyed by video id (tests/smoke runs)."""

    def __init__(self, clip_len: int, image_size: int):
        self.clip_len = clip_len
        self.image_size = image_size

    def __call__(self, vid: str) -> np.ndarray:
        import zlib

        seed = zlib.crc32(vid.encode()) % (2 ** 31)  # stable across processes
        return synth.make_frames(self.clip_len, self.image_size, seed=seed)

"""Deterministic synthetic micro-datasets in the AGQA schema: the port's own
copy of the AGQA half of ``shgvqa_tpu/data/synthetic.py``.

The generators give the exact annotation fields the evaluator and the
dataset consume.  Answers follow a fixed (question template, object) rule
and frame labels a fixed (video, frame) rule, shared by every split and
seed, so a synthetic run can learn them and its valid scores rise above
chance.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_ANSWERS = [
    "yes", "no", "before", "after", "blanket", "shoe", "phone", "bag",
    "closet", "table", "food", "running", "sitting", "standing",
]
_QTEMPLATES = [
    "was the person touching the {}?",
    "what did they do before holding the {}?",
    "did the person put down the {} after taking the {}?",
    "which object were they carrying while watching the {}?",
]
_OBJECTS = ["blanket", "shoe", "phone", "bag", "closet", "table", "food"]
_REASONING = ["obj-rel", "rel-act", "obj-act", "superlative", "sequencing",
              "exists", "duration-comparison", "action-recognition"]
_SEMANTIC = ["object", "relation", "action"]
_STRUCTURAL = ["query", "compare", "choose", "logic", "verify"]


def answer_vocab() -> Dict[str, int]:
    return {a: i for i, a in enumerate(_ANSWERS)}


def rule_answer(template_idx: int, obj_idx: int) -> str:
    """The LEARNABLE answer rule: a fixed (question template, object) ->
    answer mapping shared by every split/seed.

    Synthetic runs used to draw answers independently of questions, so
    valid-split accuracy was chance by construction and BEST-on-hg
    selection had nothing to select (round-4 verdict item 5).  With a
    deterministic rule the language stream can learn the mapping on train
    and generalize to the (same-rule) valid split."""
    return _ANSWERS[(template_idx * len(_OBJECTS) + obj_idx) % len(_ANSWERS)]


def rule_frame_labels(vid_idx: int, fid_idx: int, n_classes: int,
                      count: int) -> List[int]:
    """Deterministic per-(video, frame) HG labels in [1, n_classes]: the
    clip's content IS its labels, identically across splits/seeds, so the
    visual stream can learn frame->label and the per-epoch valid hg class
    accuracy climbs above chance."""
    return [1 + (vid_idx * 131 + fid_idx * 17 + j * 7) % n_classes
            for j in range(count)]


def make_agqa_data(
    n: int = 32,
    n_videos: int = 4,
    frames_per_video: int = 8,
    num_rel_classes: int = 11,
    num_act_classes: int = 7,
    max_rel: int = 3,
    max_act: int = 2,
    seed: int = 0,
) -> Tuple[List[dict], Dict[str, int], Dict[str, dict], Dict[str, dict], Dict[str, list]]:
    """Returns (datums, answer_vocab, frame_triplets, frame_actions, frame_ids).

    frame_triplets/frame_actions: video_id -> frame_id -> list[int] labels in
    [1, num_classes] (0 is background/pad, as in the real vocab dicts).
    frame_ids: video_id -> ordered list of frame ids (the 'trimmed' clip).
    """
    rng = np.random.RandomState(seed)
    vocab = answer_vocab()
    videos = [f"VID{v:03d}" for v in range(n_videos)]
    frame_ids = {
        vid: [f"{fi:06d}" for fi in range(frames_per_video)] for vid in videos
    }
    frame_triplets: Dict[str, dict] = {}
    frame_actions: Dict[str, dict] = {}
    for vi, vid in enumerate(videos):
        frame_triplets[vid] = {}
        frame_actions[vid] = {}
        for fi, fid in enumerate(frame_ids[vid]):
            # label COUNTS vary with the rng (exercises padding/lengths);
            # label VALUES follow the deterministic rule so valid-split hg
            # accuracy is learnable (rule_frame_labels)
            n_rel = int(rng.randint(1, max_rel + 1))
            n_act = int(rng.randint(1, max_act + 1))
            frame_triplets[vid][fid] = rule_frame_labels(
                vi, fi, num_rel_classes, n_rel)
            frame_actions[vid][fid] = rule_frame_labels(
                vi, fi, num_act_classes, n_act)

    datums: List[dict] = []
    for i in range(n):
        obj_idx = int(rng.randint(len(_OBJECTS)))
        obj = _OBJECTS[obj_idx]
        template_idx = int(rng.randint(len(_QTEMPLATES)))
        template = _QTEMPLATES[template_idx]
        question = template.replace("{}", obj)
        answer = rule_answer(template_idx, obj_idx)
        ans_type = "binary" if answer in ("yes", "no", "before", "after") else "open"
        n_tags = int(rng.randint(1, 3))
        tags = [
            _REASONING[int(rng.randint(len(_REASONING)))] for _ in range(n_tags)
        ]
        datums.append({
            "question_id": f"Q{i:05d}",
            "video_id": videos[i % n_videos],
            "question": question,
            "answer": answer,
            "ans_type": ans_type,
            "global": tags,
            "semantic": _SEMANTIC[int(rng.randint(len(_SEMANTIC)))],
            "structural": _STRUCTURAL[int(rng.randint(len(_STRUCTURAL)))],
            "novel_comp": int(rng.randint(2)),
            "more_steps": int(rng.randint(2)),
            "steps": int(rng.randint(1, 9)),
            "nc_seq": int(rng.randint(2)),
            "nc_sup": int(rng.randint(2)),
            "nc_dur": int(rng.randint(2)),
            "nc_objrel": int(rng.randint(2)),
            "i_obj": int(rng.randint(2)),
            "i_act": int(rng.randint(2)),
            "i_temp": int(rng.randint(2)),
            "indirect": int(rng.randint(2)),
            "direct_equiv": f"Q{int(rng.randint(n)):05d}" if rng.rand() < 0.5 else None,
        })
    return datums, vocab, frame_triplets, frame_actions, frame_ids


def make_frames(n_frames: int, size: int = 32, seed: int = 0) -> np.ndarray:
    """Fake decoded frames (T, H, W, 3) uint8."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(n_frames, size, size, 3), dtype=np.uint8)

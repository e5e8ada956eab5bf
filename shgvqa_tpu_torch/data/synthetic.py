"""Deterministic synthetic micro-datasets in the AGQA and STAR schemas: the
port's own copy of ``shgvqa_tpu/data/synthetic.py``.

The generators give the exact annotation fields the evaluator and the
dataset consume.  Answers follow a fixed (question template, object) rule
and frame labels a fixed (video, frame) rule, shared by every split and
seed, so a synthetic run can learn them and its valid scores rise above
chance.

``write_agqa_files`` puts such a dataset on disk in the reference's layout
(annotation JSON files and one PNG per frame), so the drivers' real-file
path and the frame decoders run on it.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
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


def make_star_data(
    n: int = 32,
    n_videos: int = 4,
    frames_per_video: int = 8,
    num_rel_classes: int = 11,
    num_act_classes: int = 7,
    max_rel: int = 3,
    max_act: int = 2,
    seed: int = 0,
) -> Tuple[List[dict], Dict[str, float]]:
    """Returns (datums, fps_dict).  Datums carry STAR fields:
    question_id (qtype-prefixed), video_id, question, choices, answer_choice,
    situations: {frame_id: {"rel_labels": [...], "actions": [...]}}, start/end.
    """
    rng = np.random.RandomState(seed)
    qtypes = ["Interaction", "Sequence", "Prediction", "Feasibility"]
    videos = [f"SVID{v:03d}" for v in range(n_videos)]
    datums: List[dict] = []
    for i in range(n):
        qtype = qtypes[i % 4]
        vid = videos[i % n_videos]
        obj_idx = int(rng.randint(len(_OBJECTS)))
        obj = _OBJECTS[obj_idx]
        situations = {}
        for fi in range(frames_per_video):
            fid = f"{fi:06d}"
            # counts random (padding coverage), values rule-determined so
            # the valid split is learnable (see rule_frame_labels)
            n_rel = int(rng.randint(1, max_rel + 1))
            n_act = int(rng.randint(1, max_act + 1))
            situations[fid] = {
                "rel_labels": rule_frame_labels(
                    i % n_videos, fi, num_rel_classes, n_rel),
                "actions": rule_frame_labels(
                    i % n_videos, fi, num_act_classes, n_act),
            }
        choices = {
            str(c): f"{_ANSWERS[int(rng.randint(len(_ANSWERS)))]} the {obj}"
            for c in range(4)
        }
        datums.append({
            "question_id": f"{qtype}_T1_{i:05d}",
            "video_id": vid,
            "question": f"what happened to the {obj}?",
            "choices": choices,
            # learnable: the answer choice is a fixed function of the
            # question's object (rule_answer analog for 4-way choices)
            "answer_choice": obj_idx % 4,
            "situations": situations,
            "start": 0.0,
            "end": float(frames_per_video),
        })
    fps = {vid: 1.0 for vid in videos}
    return datums, fps


def make_frames(n_frames: int, size: int = 32, seed: int = 0) -> np.ndarray:
    """Fake decoded frames (T, H, W, 3) uint8."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(n_frames, size, size, 3), dtype=np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a (H, W, 3) uint8 array (no filter, zlib level
    1): needs no image library."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + row.tobytes()
                   for row in np.ascontiguousarray(rgb, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_agqa_files(data_dir: str, frame_dir: str, split: str = "test",
                     n: int = 16, num_rel_classes: int = 11,
                     num_act_classes: int = 7, max_rel: int = 3,
                     max_act: int = 2, frame_hw: Tuple[int, int] = (360, 480),
                     frames_per_video: int = 8, seed: int = 0) -> None:
    """``make_agqa_data`` written as the AGQA files of ``split`` under
    ``data_dir`` (``{split}_balanced.json``, ``trainVal_vocab.json``,
    ``frameTriplets.json``, ``frameActions.json``,
    ``trimmed_frame_ids.json``) and each frame as a random 8 x 8-block
    ``frame_hw`` PNG at ``{frame_dir}/{video_id}.mp4/{frame_id}.png``."""
    datums, vocab, trip, acts, fids = make_agqa_data(
        n=n, frames_per_video=frames_per_video,
        num_rel_classes=num_rel_classes, num_act_classes=num_act_classes,
        max_rel=max_rel, max_act=max_act, seed=seed)
    os.makedirs(data_dir, exist_ok=True)
    for name, obj in ((f"{split}_balanced.json", datums),
                      ("trainVal_vocab.json", vocab),
                      ("frameTriplets.json", trip),
                      ("frameActions.json", acts),
                      ("trimmed_frame_ids.json", fids)):
        with open(os.path.join(data_dir, name), "w") as f:
            json.dump(obj, f)
    rng = np.random.RandomState(seed)
    h, w = frame_hw
    for vid, ids in fids.items():
        os.makedirs(os.path.join(frame_dir, f"{vid}.mp4"), exist_ok=True)
        for fid in ids:
            # random 8 x 8 blocks: flat areas and sharp edges both
            coarse = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
            img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
            with open(os.path.join(frame_dir, f"{vid}.mp4", f"{fid}.png"),
                      "wb") as f:
                f.write(encode_png(img.astype(np.uint8)))

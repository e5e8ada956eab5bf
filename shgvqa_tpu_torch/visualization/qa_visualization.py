"""Offline QA / situation-hypergraph visualization: the port's own copy of
``shgvqa_tpu/visualization/qa_visualization.py``, numpy and matplotlib
only.  matplotlib is imported inside each plotting function, so importing
the port needs no matplotlib.

Rebuild of ``visualization_tools/qa_visualization.py`` (matplotlib plots of
keyframes, QA pairs, predicted situation graphs, attention heatmaps) without
the notebook-only dependencies (ipyplot).  All functions save to files —
this is an offline analysis tool, not part of the training path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def plot_clip(frames: np.ndarray, path: str, title: str = "",
              max_cols: int = 8) -> None:
    """Save a (T, H, W, 3) clip as a frame grid."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = frames.shape[0]
    cols = min(t, max_cols)
    rows = -(-t // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_2d(axes)
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        ax.axis("off")
        if i < t:
            img = frames[i]
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 1)
            ax.imshow(img)
            ax.set_title(f"t={i}", fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_situation_hypergraph(
    rel_preds: np.ndarray,          # (S, R) predicted rel class ids
    act_preds: np.ndarray,          # (S, A) predicted act class ids
    path: str,
    rel_names: Optional[Dict[int, object]] = None,
    act_names: Optional[Dict[int, object]] = None,
    question: str = "",
    answer: str = "",
) -> None:
    """Per-situation table of predicted actions + relation triplets
    (background 0 omitted)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = rel_preds.shape[0]
    fig, ax = plt.subplots(figsize=(10, 0.5 * s + 2))
    ax.axis("off")
    lines = []
    for i in range(s):
        acts = [a for a in act_preds[i].tolist() if a != 0]
        rels = [r for r in rel_preds[i].tolist() if r != 0]
        act_str = ", ".join(
            str(act_names.get(a, a)) if act_names else str(a) for a in acts)
        rel_str = ", ".join(
            str(rel_names.get(r, r)) if rel_names else str(r) for r in rels)
        lines.append(f"s{i:02d}  acts: [{act_str}]  rels: [{rel_str}]")
    text = "\n".join(lines)
    header = ""
    if question:
        header += f"Q: {question}\n"
    if answer:
        header += f"A: {answer}\n"
    ax.text(0.01, 0.99, header + text, family="monospace", fontsize=8,
            va="top")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


# OpenPose BODY_25-style limb list used by the reference's pose overlay
# (visualization_tools/vis_utils.py:63-65); links drawn only when both
# endpoints have confidence > 0, keypoints as dots (:86-95).
POSE_LINKS = ((4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
              (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1), (0, 1))


def plot_boxes(frames: np.ndarray, boxes: Sequence[Sequence],
               labels: Sequence[Sequence[str]], path: str,
               title: str = "", max_cols: int = 8) -> None:
    """Frame grid with per-frame bounding boxes + labels.

    Rebuild of ``Vis_Box`` (``qa_visualization.py:55-79``): rainbow colormap
    over a frame's boxes, label text at the box corner — matplotlib patches
    instead of cv2 rectangles (cv2/ipyplot are notebook-only upstream deps).

    frames: (T, H, W, 3); boxes[t]: iterable of (x1, y1, x2, y2) or None;
    labels[t]: same length as boxes[t].
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    t = frames.shape[0]
    cols = min(t, max_cols)
    rows = -(-t // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.4 * cols, 2.4 * rows))
    axes = np.atleast_2d(axes)
    cmap = plt.get_cmap("rainbow")
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        ax.axis("off")
        if i >= t:
            continue
        img = frames[i]
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 1)
        ax.imshow(img)
        frame_boxes = boxes[i] if i < len(boxes) else []
        frame_labels = labels[i] if i < len(labels) else []
        n = max(len(frame_boxes), 1)
        colors = [cmap(v) for v in np.linspace(0, 1, n + 2)]
        ci = 0
        for j, bb in enumerate(frame_boxes):
            if bb is None:
                continue
            x1, y1, x2, y2 = (float(v) for v in bb)
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1,
                                   fill=False, edgecolor=colors[ci],
                                   linewidth=1.5))
            if j < len(frame_labels) and frame_labels[j]:
                ax.text(x1, y1, str(frame_labels[j]), fontsize=6,
                        color="white",
                        bbox=dict(facecolor=colors[ci], alpha=0.7, pad=1))
            ci += 1
        ax.set_title(f"t={i}", fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_pose(frames: np.ndarray, keypoints: Sequence[Optional[Sequence]],
              path: str, title: str = "", max_cols: int = 8) -> None:
    """Frame grid with OpenPose skeleton overlays.

    Rebuild of ``Vis_Pose`` + ``vis_utils.vis_keypoints``
    (``qa_visualization.py:82-101``, ``vis_utils.py:63-97``): keypoints[t]
    is the flat [x0, y0, c0, x1, y1, c1, ...] ``pose_keypoints_2d`` list (or
    None for frames without a detection, drawn plain like the reference's
    except-branch); limbs drawn rainbow-colored when both endpoint
    confidences are > 0, visible joints as red dots.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = frames.shape[0]
    cols = min(t, max_cols)
    rows = -(-t // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.4 * cols, 2.4 * rows))
    axes = np.atleast_2d(axes)
    cmap = plt.get_cmap("rainbow")
    colors = [cmap(v) for v in np.linspace(0, 1, len(POSE_LINKS) + 2)]
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        ax.axis("off")
        if i >= t:
            continue
        img = frames[i]
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 1)
        ax.imshow(img)
        kp = keypoints[i] if i < len(keypoints) else None
        if kp is not None and len(kp) >= 3:
            xs, ys, vs = kp[0::3], kp[1::3], kp[2::3]
            for li, (a, b) in enumerate(POSE_LINKS):
                if a < len(vs) and b < len(vs) and vs[a] > 0 and vs[b] > 0:
                    ax.plot([xs[a], xs[b]], [ys[a], ys[b]],
                            color=colors[li], linewidth=2)
            vis_x = [x for x, v in zip(xs, vs) if v > 0]
            vis_y = [y for y, v in zip(ys, vs) if v > 0]
            ax.scatter(vis_x, vis_y, s=6, c="red", zorder=3)
        ax.set_title(f"t={i}", fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_attention(attn: np.ndarray, path: str,
                   query_labels: Optional[Sequence[str]] = None,
                   key_labels: Optional[Sequence[str]] = None,
                   title: str = "") -> None:
    """Save a (H, Lq, Lk) or (Lq, Lk) attention map (heads averaged)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if attn.ndim == 3:
        attn = attn.mean(0)
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(attn, aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax)
    if query_labels is not None:
        ax.set_yticks(range(len(query_labels)))
        ax.set_yticklabels(query_labels, fontsize=6)
    if key_labels is not None:
        ax.set_xticks(range(len(key_labels)))
        ax.set_xticklabels(key_labels, fontsize=6, rotation=90)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


# ---------------------------------------------------------------------------
# STAR-datum browsing helpers — the text/video half of the reference's
# qa_visualization.py (Vis_Meta_Info/Vis_Question_Answer_Options/Vis_Video/
# Vis_SituationGraph/qa_visulization, qa_visualization.py:25-153).  The
# reference drives these from notebooks (IPython/ipywidgets/cv2); here they
# are plain functions over STAR-format dicts, with frame IO delegated to a
# caller-supplied loader so they run anywhere the repo runs.
# ---------------------------------------------------------------------------


def print_meta_info(datum: dict) -> None:
    """``Vis_Meta_Info`` (qa_visualization.py:25-26)."""
    print("QID:", datum["question_id"], ", VID: ", datum["video_id"])


def print_question_answer_options(datum: dict) -> None:
    """``Vis_Question_Answer_Options`` (qa_visualization.py:28-35)."""
    print("\tQ:", datum["question"], "\n")
    print("\tAnswer:", datum["answer"])
    for c in datum.get("choices", []):
        if c["choice"] != datum["answer"]:
            print("\tOption:", c["choice"])
    print("\n")


def print_situation_graph(datum: dict, act_cls: Dict[str, str],
                          obj_vocab: Sequence[str],
                          rel_vocab: Sequence[str],
                          max_show_num: int) -> None:
    """Textual per-frame situation subgraphs, ``Vis_SituationGraph``
    (qa_visualization.py:102-118): actions by description, relationships as
    'object ---- relation ---- object' triplet lines."""
    from shgvqa_tpu_torch.data.star import sample_frames

    frame_ids = sorted(datum["situations"].keys())
    for i, f in enumerate(sample_frames(frame_ids, max_show_num)):
        sit = datum["situations"][f]
        act_arr = [act_cls[a] for a in sit["actions"]]
        print(f"{i} Frame ID:", f)
        print("Subgraph:")
        print("\t Actions:")
        print("\t\t", " ,".join(act_arr))
        print("\t Relationships:")
        rel_ids = sit["rel_labels"]
        for j, rel in enumerate(sit["rel_pairs"]):
            print("\t\t", obj_vocab[int(rel[0][1:])], " ---- ",
                  rel_vocab[int(rel_ids[j][1:])], " ---- ",
                  obj_vocab[int(rel[1][1:])])
        print("\n")


def extract_video_segment(datum: dict, raw_video_dir: str,
                          save_video_dir: str) -> str:
    """Trim the question's [start, end] segment out of the raw mp4,
    ``Vis_Video`` (qa_visualization.py:37-46) minus the notebook embed.
    Uses the same stream-copy ffmpeg invocation; raises a clear error when
    ffmpeg is absent rather than silently writing nothing (the reference's
    os.system ignores failures)."""
    import shutil
    import subprocess

    start = round(float(datum["start"]), 2)
    end = round(float(datum["end"]), 2)
    in_path = f"{raw_video_dir}{datum['video_id']}.mp4"
    out_path = f"{save_video_dir}{datum['question_id']}.mp4"
    print("\tVideo Seg: ", f"{start}s", "-", f"{end}s")
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found on PATH - extract_video_segment needs it "
            "(the reference shells out to ffmpeg the same way)")
    subprocess.run(
        ["ffmpeg", "-y", "-ss", str(start), "-to", str(end), "-i", in_path,
         "-codec", "copy", out_path], check=True, capture_output=True)
    return out_path


def visualize_qa(data: Sequence[dict], *, load_frames=None,
                 output_dir: str = ".", max_show_num: int = 16,
                 act_cls: Optional[Dict[str, str]] = None,
                 obj_vocab: Optional[Sequence[str]] = None,
                 rel_vocab: Optional[Sequence[str]] = None,
                 raw_video_dir: str = "", save_video_dir: str = "",
                 pose_loader=None,
                 vis_meta: bool = False, vis_q_a_o: bool = False,
                 vis_v: bool = False, vis_kf: bool = False,
                 vis_sg: bool = False, vis_pose: bool = False,
                 vis_box: bool = False) -> None:
    """Flag-for-flag rebuild of the ``qa_visulization`` driver
    (qa_visualization.py:120-153) over STAR-format datum dicts.

    ``load_frames(video_id, frame_ids) -> (T, H, W, 3) ndarray`` supplies
    keyframe pixels (the repo's data.frames.FrameLoader works);
    ``pose_loader(video_id, frame_id) -> flat keypoint list or None``
    supplies OpenPose detections.  Plots land in ``output_dir`` keyed by
    question_id; text sections print like the reference.
    """
    import os

    from shgvqa_tpu_torch.data.star import trim_keyframes

    for datum in data:
        qid = datum.get("question_id", "qa")
        if vis_meta:
            print_meta_info(datum)
        if vis_q_a_o:
            print("=" * 20, "Question & Answer & Options", "=" * 20, "\n")
            print_question_answer_options(datum)
        if vis_v:
            print("=" * 20, "Trimmed Video", "=" * 20, "\n")
            extract_video_segment(datum, raw_video_dir, save_video_dir)
        frame_ids = trim_keyframes(datum, max_show_num) if (
            vis_kf or vis_pose or vis_box) else []
        frames = (np.asarray(load_frames(datum["video_id"], frame_ids))
                  if frame_ids and load_frames is not None else None)
        if vis_kf and frames is not None:
            print("=" * 20, "Keyframes", "=" * 20, "\n")
            plot_clip(frames, os.path.join(output_dir, f"{qid}_frames.png"),
                      title=str(qid))
        if vis_pose and frames is not None:
            print("=" * 20, "Pose", "=" * 20, "\n")
            kps = [pose_loader(datum["video_id"], f) if pose_loader else None
                   for f in frame_ids]
            plot_pose(frames, kps,
                      os.path.join(output_dir, f"{qid}_pose.png"),
                      title=str(qid))
        if vis_box and frames is not None:
            print("=" * 20, "Bounding Boxes", "=" * 20, "\n")
            boxes, labels = [], []
            for f in frame_ids:
                sit = datum["situations"].get(f, {})
                bbs = sit.get("bbox", [])
                lbs = sit.get("bbox_labels", [""] * len(bbs))
                names = [(obj_vocab[int(l[1:])] if (
                    obj_vocab is not None and isinstance(l, str)
                    and len(l) > 1 and l[1:].isdigit()) else str(l))
                    for l in lbs]
                boxes.append(bbs)
                labels.append(names)
            plot_boxes(frames, boxes, labels,
                       os.path.join(output_dir, f"{qid}_boxes.png"),
                       title=str(qid))
        if vis_sg and act_cls is not None:
            print("=" * 20, "Situation Graphs", "=" * 20, "\n")
            print_situation_graph(datum, act_cls, obj_vocab or [],
                                  rel_vocab or [], max_show_num)

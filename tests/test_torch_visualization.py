"""The port's visualization tools (``visualization/qa_visualization.py``)
against the JAX package's: every plot pixel-equal after a PIL decode, the
attention heat map of a map the port's dumps write, and the orchestrator's
printed text and files equal."""

import contextlib
import io

import numpy as np
import pytest
from PIL import Image

pytest.importorskip("matplotlib")

from shgvqa_tpu.visualization import qa_visualization as jax_vis  # noqa: E402
from shgvqa_tpu_torch.visualization import qa_visualization as vis  # noqa: E402


def _frames(t=4, h=32, w=32):
    return np.random.RandomState(0).randint(0, 256, (t, h, w, 3), np.uint8)


def _pose():
    rng = np.random.RandomState(2)
    kp = []
    for t in range(4):
        kp.append(None if t == 2 else [
            v for _ in range(14) for v in (float(rng.uniform(0, 31)),
                                           float(rng.uniform(0, 31)),
                                           float(rng.randint(0, 2)))])
    return kp


PLOTS = {
    "clip": ("plot_clip", lambda: (_frames(),), dict(title="clip")),
    "clip_float": ("plot_clip", lambda: (_frames(t=9) / 200.0,), {}),
    "hypergraph": ("plot_situation_hypergraph", lambda: (
        np.array([[1, 0, 2], [3, 3, 0]]), np.array([[1, 0], [0, 2]])),
        dict(rel_names={1: "on", 2: "holding", 3: "near"},
             act_names={1: "sit", 2: "stand"}, question="what is it?",
             answer="sitting")),
    "attention": ("plot_attention", lambda: (
        np.random.RandomState(1).rand(2, 5, 7),),
        dict(query_labels=[f"q{i}" for i in range(5)],
             key_labels=[f"k{i}" for i in range(7)], title="x")),
    "boxes": ("plot_boxes", lambda: (
        _frames(), [[(2, 2, 20, 20), None], [(5, 5, 28, 28)], [], []],
        [["person", "cup"], ["table"], [], []]), dict(title="boxes")),
    "pose": ("plot_pose", lambda: (_frames(), _pose()), dict(title="pose")),
}


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _plot_both(tmp_path, fname, args, kw):
    """Both packages' plot of the same inputs: (port pixels, JAX pixels)."""
    out = []
    for name, mod in (("port", vis), ("jax", jax_vis)):
        path = tmp_path / f"{name}.png"
        fn = getattr(mod, fname)
        if fname in ("plot_boxes", "plot_pose"):
            fn(*args, path=str(path), **kw)
        else:
            fn(*args, str(path), **kw)
        out.append(_pixels(path))
    return out


@pytest.mark.parametrize("kind", sorted(PLOTS))
def test_plots_are_pixel_equal_to_jax(tmp_path, kind):
    fname, args, kw = PLOTS[kind]
    got, want = _plot_both(tmp_path, fname, args(), kw)
    assert got.shape == want.shape and got.shape[0] > 50
    np.testing.assert_array_equal(got, want)


def test_attention_heat_map_of_a_dumped_map(tmp_path):
    """The heat map of a dumped entry's attention (heads, HG tokens): the
    port's JSON rows plot as JAX's."""
    row = np.random.RandomState(5).dirichlet(np.ones(25), size=4)
    got, want = _plot_both(tmp_path, "plot_attention", (row[:, None, :],),
                           dict(title="hgq CLS"))
    np.testing.assert_array_equal(got, want)


def _datum():
    return {
        "question_id": "Interaction_T1_0", "video_id": "VID001",
        "question": "What did the person do?", "answer": "took the book",
        "choices": [{"choice": "took the book"}, {"choice": "sat down"}],
        "start": 1.0, "end": 3.0,
        "situations": {
            "000001": {"actions": ["a001"], "rel_labels": ["r000"],
                       "rel_pairs": [["o000", "o001"]],
                       "bbox": [[2.0, 2.0, 20.0, 20.0]],
                       "bbox_labels": ["o000"]},
            "000002": {"actions": ["a000"], "rel_labels": ["r001"],
                       "rel_pairs": [["o001", "o000"]],
                       "bbox": [[4.0, 4.0, 16.0, 24.0]],
                       "bbox_labels": ["o001"]},
        },
    }


def test_orchestrator_prints_and_draws_as_jax(tmp_path):
    frames = _frames(t=2)
    texts, files = [], []
    for name, mod in (("port", vis), ("jax", jax_vis)):
        out = tmp_path / name
        out.mkdir()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.visualize_qa(
                [_datum()], load_frames=lambda vid, ids: frames[:len(ids)],
                output_dir=str(out), max_show_num=2,
                act_cls={"a000": "look at book", "a001": "take book"},
                obj_vocab=["person", "book"], rel_vocab=["on", "behind"],
                pose_loader=lambda vid, f: [5, 5, 1.0, 9, 9, 1.0, 13, 5,
                                            1.0],
                vis_meta=True, vis_q_a_o=True, vis_kf=True, vis_sg=True,
                vis_pose=True, vis_box=True)
        texts.append(buf.getvalue())
        files.append({p.name: _pixels(p) for p in sorted(out.iterdir())})
    assert texts[0] == texts[1] and "QID: Interaction_T1_0" in texts[0]
    assert files[0].keys() == files[1].keys() == {
        "Interaction_T1_0_frames.png", "Interaction_T1_0_pose.png",
        "Interaction_T1_0_boxes.png"}
    for key in files[1]:
        np.testing.assert_array_equal(files[0][key], files[1][key])

"""The port's native frame decoder (``csrc/frameloader.cpp`` through
``data/native_loader.py``) against the JAX package's
(``shgvqa_tpu/data/native_loader.py``): bit-equal on the cases of
``tests/test_native_loader.py`` (RGB, grayscale and palette PNGs, JPEG by
magic bytes, STAR's explicit frame ids, a missing file) and on a 480 x 360
frame downscaled to 224, where PIL's antialiased resize differs; the
drivers' ``--frameLoader`` wiring against the JAX ``make_frame_loader``;
and the ``agqa_hgqa`` driver on default flags over PNG frames on disk."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from shgvqa_tpu.cli import common as jax_common
from shgvqa_tpu.configs.config import tiny_test_config as jax_tiny
from shgvqa_tpu.data import native_loader as jax_native
from shgvqa_tpu_torch.cli import agqa_hgqa, common
from shgvqa_tpu_torch.configs.config import tiny_test_config
from shgvqa_tpu_torch.data import native_loader, synthetic
from shgvqa_tpu_torch.data.agqa import FrameLoader
from shgvqa_tpu_torch.kernels import _build
from shgvqa_tpu_torch.models import shgvqa
from shgvqa_tpu_torch.models.backbone import SlowR50
from test_torch_common import TOY


@pytest.fixture(scope="module")
def lib():
    got = native_loader.get_lib()
    assert got is not None, "g++, libpng and libjpeg are on this host"
    return got


def _png(path, arr, **kw):
    Image.fromarray(arr, **kw).save(path)
    return str(path)


def _both(paths, h, w):
    got = native_loader.decode_clip(paths, h, w)
    want = jax_native.decode_clip(paths, h, w)
    np.testing.assert_array_equal(got, want)
    return got


def test_library_is_built_from_the_ports_source(lib):
    """The library lies under ``shgvqa_tpu_torch/_build/``, named by the
    hash of the port's ``csrc/frameloader.cpp`` and the flags; the source
    is the port's copy, its C entries as JAX's."""
    path = _build.host_library_path("frameloader")
    assert lib._name == str(path)
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parent.name == "shgvqa_tpu_torch"
    src = (_build.CSRC_DIR / "frameloader.cpp").read_text()
    for entry in ("int fl_set_threads(int n)", "int fl_decode_clip("):
        assert entry in src
    assert not str(path).startswith(os.path.dirname(jax_native._SO))


def test_rgb_pngs_at_size_and_resized(lib, tmp_path):
    rng = np.random.RandomState(0)
    arrays = [rng.randint(0, 256, (37, 53, 3), np.uint8) for _ in range(4)]
    paths = [_png(tmp_path / f"{i:06d}.png", a) for i, a in enumerate(arrays)]
    np.testing.assert_array_equal(_both(paths, 37, 53), np.stack(arrays))
    assert _both(paths, 16, 16).shape == (4, 16, 16, 3)


def test_grayscale_and_palette_pngs(lib, tmp_path):
    rng = np.random.RandomState(1)
    gray = rng.randint(0, 256, (20, 20), np.uint8)
    pal = tmp_path / "pal.png"
    Image.fromarray(rng.randint(0, 256, (20, 20, 3), np.uint8)).convert(
        "P", palette=Image.ADAPTIVE).save(pal)
    out = _both([_png(tmp_path / "gray.png", gray, mode="L"), str(pal)],
                20, 20)
    for c in range(3):
        np.testing.assert_array_equal(out[0, :, :, c], gray)


def test_jpeg_by_magic_bytes(lib, tmp_path):
    rng = np.random.RandomState(3)
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    rgb, gray = tmp_path / "f1.png", tmp_path / "f2.png"
    Image.fromarray(img).save(rgb, format="JPEG", quality=92)
    Image.fromarray(img[:, :, 0]).save(gray, format="JPEG")
    out = _both([str(rgb), str(gray)], 48, 64)
    np.testing.assert_array_equal(out[0], np.asarray(
        Image.open(rgb).convert("RGB")))


@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_downscale_480x360_to_224_is_jaxs_not_pils(lib, tmp_path, kind):
    """The default loader's pixels on a frame of the dataset's size: the
    port's loader (``make_frame_loader`` under ``auto``) bit-equal to
    JAX's; PIL's antialiased resize, which the port took under ``auto``
    before, is not."""
    rng = np.random.RandomState(4)
    if kind == "noise":
        img = rng.randint(0, 256, (360, 480, 3), np.uint8)
    else:
        y, x = np.mgrid[0:360, 0:480]
        img = np.stack([x * 255 // 479, y * 255 // 359, (x + y) % 256],
                       -1).astype(np.uint8)
    d = tmp_path / "V.mp4"
    d.mkdir()
    _png(d / "000000.png", img)
    cfg = tiny_test_config()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, frame_dir=str(tmp_path), clip_len=1, image_size=224))
    jcfg = jax_tiny().replace(data=dataclasses.replace(
        jax_tiny().data, frame_dir=str(tmp_path), clip_len=1,
        image_size=224))
    ids = {"V": ["000000"]}
    ours = common.make_frame_loader(cfg, ids, {})
    theirs = jax_common.make_frame_loader(jcfg, ids, {})
    assert isinstance(ours, native_loader.NativeFrameLoader)
    assert isinstance(theirs, jax_native.NativeFrameLoader)
    got = ours("V")
    np.testing.assert_array_equal(got, theirs("V"))
    pil = FrameLoader(str(tmp_path), ids, 1, 224)("V")
    assert np.abs(got.astype(int) - pil.astype(int)).max() > 0


def test_star_explicit_fids_and_subsampling(lib, tmp_path):
    """The dataset layout, clip_len out of 6 frames, and STAR's explicit
    keyframes (``fids``) through the same loader."""
    rng = np.random.RandomState(0)
    d = tmp_path / "VIDX.mp4"
    d.mkdir()
    fids = [f"{i:06d}" for i in range(6)]
    for fid in fids:
        _png(d / f"{fid}.png", rng.randint(0, 255, (32, 48, 3), np.uint8))
    ids = {"VIDX": fids}
    ours = native_loader.NativeFrameLoader(str(tmp_path), ids, 4, 32)
    theirs = jax_native.NativeFrameLoader(str(tmp_path), ids, 4, 32)
    np.testing.assert_array_equal(ours("VIDX"), theirs("VIDX"))
    np.testing.assert_array_equal(ours("VIDX", fids[2:]),
                                  theirs("VIDX", fids[2:]))


def test_missing_file_raises_naming_the_path(lib, tmp_path):
    rng = np.random.RandomState(0)
    good = _png(tmp_path / "a.png", rng.randint(0, 256, (8, 8, 3), np.uint8))
    missing = str(tmp_path / "nope.png")
    for mod in (native_loader, jax_native):
        with pytest.raises(IOError, match="nope.png"):
            mod.decode_clip([good, missing], 8, 8)


def test_frame_loader_wiring_and_threads(lib, monkeypatch):
    """auto -> native when it builds, pil -> PIL, native -> native; with
    the library missing auto prints JAX's notice and takes PIL, native
    raises RuntimeError; ``--numWorkers`` sizes the decoder's pool."""
    cfg = tiny_test_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_workers=3))
    sizes = []
    real = lib.fl_set_threads
    monkeypatch.setattr(lib, "fl_set_threads",
                        lambda n: sizes.append(n) or real(n))
    for kind in ("auto", "native"):
        assert isinstance(common.make_frame_loader(
            cfg, {}, {"frame_loader": kind}),
            native_loader.NativeFrameLoader)
    assert sizes == [3, 3]
    assert isinstance(common.make_frame_loader(
        cfg, {}, {"frame_loader": "pil"}), FrameLoader)
    monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loader = common.make_frame_loader(cfg, {}, {"frame_loader": "auto"})
    assert isinstance(loader, FrameLoader)
    assert out.getvalue() == "native frame decoder unavailable; using PIL\n"
    with pytest.raises(RuntimeError, match="native"):
        common.make_frame_loader(cfg, {}, {"frame_loader": "native"})
    with pytest.raises(RuntimeError, match="did not build"):
        native_loader.decode_clip(["x.png"], 8, 8)


def test_driver_on_default_flags_decodes_pngs_natively(lib, tmp_path,
                                                      monkeypatch):
    """``agqa_hgqa --test`` on real files (``synthetic.write_agqa_files``:
    480 x 360 PNG frames) with no ``--frameLoader``: every clip goes
    through the native decoder, and the oracle scores 1.0."""
    data, frames = tmp_path / "data", tmp_path / "frames"
    synthetic.write_agqa_files(str(data), str(frames), n=4,
                               frames_per_video=4)
    parse = common.parse_reference_flags_with_extras

    def narrow(argv, dataset=None):
        cfg, extras = parse(argv, dataset)
        return cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, hidden_size=32,
                                        num_heads=4, intermediate_size=64,
                                        visual_hw=1, visual_t=2),
            decoder=dataclasses.replace(cfg.decoder, num_heads=4,
                                        ffn_dim=64),
            data=dataclasses.replace(cfg.data, clip_len=10,
                                     image_size=32)), extras

    monkeypatch.setattr(common, "parse_reference_flags_with_extras", narrow)
    monkeypatch.setattr(shgvqa, "make_backbone",
                        lambda name, dtype: SlowR50(dtype, **TOY))
    clips = []
    decode = native_loader.decode_clip
    monkeypatch.setattr(native_loader, "decode_clip",
                        lambda p, h, w: clips.append(len(p)) or decode(p, h,
                                                                       w))
    out = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            agqa_hgqa.main(
                ["--taskHGQA", "--noCaps", "--test", "test", "--batchSize",
                 "8", "--llayers", "1", "--xlayers", "1", "--rlayers", "1",
                 "--dlayers", "1", "--computeDtype", "float32",
                 "--buildVocab", "--dataDir", str(data), "--frameDir",
                 str(frames), "--output", str(tmp_path / "out")],
                device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert "Oracle score: 1.0000" in out.getvalue()
    assert "native frame decoder unavailable" not in out.getvalue()
    assert clips == [10] * 4
    with open(tmp_path / "out" / "predict.json") as f:
        assert len(json.load(f)) == 4

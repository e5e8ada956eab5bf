"""ctypes bindings of the native clip decoder (``csrc/frameloader.cpp``):
the port of ``shgvqa_tpu/data/native_loader.py``.

The library is built with ``g++`` at first use into the git-ignored
``shgvqa_tpu_torch/_build/`` (``kernels/_build.build_host``; its name
hashes the source and the flags) and loaded with ``ctypes``.  It sniffs
PNG or JPEG by magic bytes, decodes a whole clip on a thread pool and
resizes bilinearly without antialias (the reference's pytorchvideo Resize
on the decoded tensor), straight into one (T, H, W, 3) uint8 buffer.

``get_lib`` returns None when the library does not build (no ``g++``,
libpng or libjpeg), after printing why; ``decode_clip`` then raises.  The
drivers' ``--frameLoader auto`` takes PIL in that case, with the JAX
driver's notice (``cli/common.make_frame_loader``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from shgvqa_tpu_torch.data.featurize import uniform_subsample_indices
from shgvqa_tpu_torch.kernels import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The decoder's library, built on first use; None when it does not
    build (the reason is printed once)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            path = _build.build_host("frameloader")
        except RuntimeError as e:
            print(f"native frameloader build failed: {e}", flush=True)
            _failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.fl_decode_clip.restype = ctypes.c_int
        lib.fl_decode_clip.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.fl_set_threads.restype = ctypes.c_int
        lib.fl_set_threads.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native frame decoder did not build "
                           "(g++, libpng or libjpeg missing?)")
    return lib


def set_threads(n: int) -> int:
    """Size the decoder's thread pool; returns the size it took."""
    return int(_require().fl_set_threads(n))


def decode_clip(paths: List[str], out_h: int, out_w: int) -> np.ndarray:
    """Decode and resize a list of PNG / JPEG paths -> (T, out_h, out_w, 3)
    uint8.  Raises IOError naming the first path that failed."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.fl_decode_clip(
        arr, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        raise IOError(f"frame decode failed for {paths[-rc - 1]!r}")
    return out


class NativeFrameLoader:
    """``data.agqa.FrameLoader`` on the native decoder: the clip's frames
    ``{frame_dir}/{vid}.mp4/{fid}.png``, ``clip_len`` of them by
    ``uniform_subsample_indices``, resized to ``image_size`` square.
    ``threads`` (``--numWorkers``) sizes the decoder's pool."""

    def __init__(self, frame_dir: str, frame_ids, clip_len: int,
                 image_size: int, threads: Optional[int] = None):
        self.frame_dir = frame_dir
        self.frame_ids = frame_ids
        self.clip_len = clip_len
        self.image_size = image_size
        if threads:
            set_threads(threads)

    def __call__(self, vid: str, fids=None) -> np.ndarray:
        fids = fids if fids is not None else self.frame_ids[vid]
        idx = uniform_subsample_indices(len(fids), self.clip_len)
        paths = [
            os.path.join(self.frame_dir, f"{vid}.mp4", f"{fids[int(i)]}.png")
            for i in idx
        ]
        return decode_clip(paths, self.image_size, self.image_size)

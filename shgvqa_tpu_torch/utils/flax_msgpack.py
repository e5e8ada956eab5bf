"""The file format of the JAX package's converted weights: the subset of
flax's msgpack serialization (``flax.serialization.msgpack_serialize`` and
``msgpack_restore``) that ``tools/convert_slow_r50.py`` writes and the JAX
``Trainer.load_backbone`` reads, in pure Python (the card's machine has no
``msgpack`` package).

- A tree is msgpack maps with str keys.  flax runs ``jax.tree_util.tree_map``
  over the tree before it packs it, which sorts the keys of every dict, so
  ``msgpack_serialize`` writes them sorted: its bytes equal flax's.
- An array leaf is ext type 1 holding a msgpack array ``(shape, dtype name,
  C-order bytes)``; a numpy scalar is ext type 3 in the same form.
- flax splits a leaf above 2^30 bytes into chunks
  (``__msgpack_chunked_array__``); neither function takes that form, and no
  slow_r50 leaf comes near it.

``msgpack_restore`` reads every msgpack type; arrays come back as read-only
views of the file's bytes, as flax's do.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30    # flax's MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# -- writer -----------------------------------------------------------------

def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A map, array or str header: the fix form up to ``fix_max``, else
    the 8- (where ``codes`` has one), 16- or 32-bit length form."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I")[3 - len(codes):],
                                (0xFF, 0xFFFF, 0xFFFFFFFF)[3 - len(codes):]):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} out of range")


def _pack_uint(out: bytearray, n: int) -> None:
    if n < 0:
        raise ValueError(f"negative array dimension {n}")
    if n < 0x80:
        out.append(n)
    elif n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    else:
        out += b"\xcf" + struct.pack(">Q", n)


def _pack_str(out: bytearray, s: str) -> None:
    data = s.encode("utf-8")
    _header(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += data


def _pack_bin(out: bytearray, data: bytes) -> None:
    n = len(data)
    if n <= 0xFF:
        out += b"\xc4" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc5" + struct.pack(">H", n)
    else:
        out += b"\xc6" + struct.pack(">I", n)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    out = bytearray()
    out.append(0x93)
    _header(out, arr.ndim, 0x90, 15, (0xDC, 0xDD))
    for n in arr.shape:
        _pack_uint(out, n)
    _pack_str(out, arr.dtype.name)
    _pack_bin(out, arr.tobytes("C"))
    return bytes(out)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, x: Any, path: str) -> None:
    if isinstance(x, dict):
        _header(out, len(x), 0x80, 15, (0xDE, 0xDF))
        for key in sorted(x):
            if not isinstance(key, str):
                raise TypeError(f"{path}: key {key!r} is not a str")
            _pack_str(out, key)
            _pack(out, x[key], f"{path}/{key}")
    elif isinstance(x, np.ndarray):
        if x.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(
                f"{path}: {x.nbytes} bytes is above flax's chunk size "
                f"{MAX_CHUNK_SIZE}; its chunked form is not written here")
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    else:
        raise TypeError(f"{path}: cannot serialize {type(x).__name__}; the "
                        "tree holds dicts of numpy arrays")


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """A nested dict of numpy arrays -> the bytes
    ``flax.serialization.msgpack_serialize`` writes for it."""
    out = bytearray()
    _pack(out, tree, "")
    return bytes(out)


# -- reader -----------------------------------------------------------------

class _Reader:
    def __init__(self, data, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack_from(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xD9: (">B", "str"),
                 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"),
                 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack_from(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack_from(numbers[b])
        raise ValueError(f"msgpack type byte {b:#x} is not valid")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError(
                "a chunked array leaf (flax writes leaves above 2^30 bytes "
                "in chunks); this reader does not take that form")
        return out

    def ext(self, n: int):
        code = self.unpack_from(">b")
        return self.ext_hook(code, self.take(n))


def _ndarray_from_bytes(data: memoryview) -> np.ndarray:
    inner = _Reader(data, None)
    shape, name, buffer = inner.value()
    if not isinstance(name, str):
        raise ValueError("array leaf without a dtype name")
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array leaf of dtype {name!r}, which numpy does "
                         "not have") from None
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_hook(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a flax array leaf")


def msgpack_restore(data: bytes) -> Any:
    """Bytes written by ``flax.serialization.msgpack_serialize`` (or by
    ``msgpack_serialize``) -> the tree of dicts and numpy arrays."""
    reader = _Reader(data, _ext_hook)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack tree")
    return tree

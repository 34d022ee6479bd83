"""Pure-Python msgpack reader and writer for flax weight files.

Bundles store their weights with ``flax.serialization.to_bytes``: msgpack
maps of str keys whose leaves are numpy arrays, each packed as ExtType
code 1 (ndarray) or 3 (numpy scalar) whose payload is itself msgpack of
``(shape, dtype.name, C-order bytes)``. Arrays over 2**30 bytes are split
into flax's ``__msgpack_chunked_array__`` dict. This module covers exactly
that subset (maps, arrays, str, bin, int, float, bool, nil, ext), so a
machine without the ``msgpack`` package can read and write bundles.
``packb`` reproduces flax's bytes for such trees.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


# --- writer --------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif -0x8000 <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif -0x80000000 <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif -0x8000000000000000 <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags, out: bytearray) -> None:
    """Length header: fix form, then 8-/16-/32-bit forms (``tags`` maps
    the width in bytes to its tag; a missing width is skipped)."""
    if fix_tag is not None and n <= fix_max:
        out.append(fix_tag | n)
        return
    for width, fmt in ((1, ">B"), (2, ">H"), (4, ">I")):
        if width in tags and n < (1 << (8 * width)):
            out.append(tags[width])
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(n, None, 0, {1: 0xC7, 2: 0xC8, 4: 0xC9}, out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, {1: 0xD9, 2: 0xDA, 4: 0xDB}, out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, {1: 0xC4, 2: 0xC5, 4: 0xC6}, out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, {2: 0xDC, 4: 0xDD}, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, {2: 0xDE, 4: 0xDF}, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (numpy arrays and scalars as flax's ext
    types)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# --- reader --------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        lens = {1: ">B", 2: ">H", 4: ">I"}
        sized = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
                 0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
                 0xDC: ("array", 2), 0xDD: ("array", 4),
                 0xDE: ("map", 2), 0xDF: ("map", 4),
                 0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4)}
        if t in sized:
            kind, width = sized[t]
            n = self.unpack(lens[width])
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if dtype_name == "bfloat16":
        # numpy has no bfloat16: widen exactly to float32 (top 16 bits)
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _unchunk(d: Dict[str, Any]) -> Any:
    if CHUNKED_KEY in d:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) if isinstance(v, dict) else v for k, v in d.items()}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object; trailing bytes are an error."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: decode and reassemble
    chunked arrays."""
    obj = unpackb(data)
    return _unchunk(obj) if isinstance(obj, dict) else obj


def serialize(tree: Dict[str, Any]) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a dict tree of numpy
    leaves (arrays over ``MAX_CHUNK_SIZE`` bytes are chunked as flax
    does)."""
    return packb(_chunk_tree(tree))


MAX_CHUNK_SIZE = 2 ** 30


def _chunk_tree(d: Any) -> Any:
    if isinstance(d, dict):
        return {k: _chunk_tree(v) for k, v in d.items()}
    if isinstance(d, np.ndarray) and d.nbytes > MAX_CHUNK_SIZE:
        step = max(1, MAX_CHUNK_SIZE // d.dtype.itemsize)
        flat = d.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {CHUNKED_KEY: True,
                "shape": {str(i): s for i, s in enumerate(d.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return d

"""A msgpack codec for the subset flax writes, in pure Python.

``Final_Model.nn`` is flax's msgpack serialization of nested dicts whose
leaves are numpy arrays: maps, str, bin, ints, floats, nil, bool, arrays,
and ext type 1, an ndarray packed as the msgpack array
``(shape, dtype name, C-order bytes)`` (``flax.serialization.
_ndarray_to_bytes``).  Ext type 3 is a numpy scalar in the same layout.
This module reads and writes exactly that, so the port needs neither flax
nor the ``msgpack`` package.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# --- encoding -----------------------------------------------------------------
def _pack_int(v: int, out: bytearray):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer too large for msgpack: {v}")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer too small for msgpack: {v}")


def _pack_len(n: int, fix_base, fix_max, codes, out: bytearray):
    """Length header: fix form when ``n <= fix_max``, else 8/16/32-bit."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack length too large: {n}")


def _pack_ext(code: int, data: bytes, out: bytearray):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        # keys sorted, as flax's tree_map leaves them: byte-identical files
        for k, v in sorted(obj.items()):
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Serialize ``obj`` (dict/list/str/bytes/int/float/bool/None, numpy
    arrays and scalars) to msgpack bytes in flax's layout."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# --- decoding -----------------------------------------------------------------
def _bf16_to_f32(raw: bytes, shape) -> np.ndarray:
    """numpy has no bfloat16: widen the 16-bit patterns to float32."""
    bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32).reshape(shape)


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, dtype_name, raw = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        return _bf16_to_f32(raw, shape)
    return np.frombuffer(raw, np.dtype(dtype_name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lens:
            return self.take(self.unpack(lens[b]))
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self.ext(self.unpack(exts[b]))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.read() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes):
    """Deserialize msgpack bytes written by flax (or by :func:`packb`).
    ndarray ext records come back as numpy arrays (bfloat16 widened to
    float32)."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj

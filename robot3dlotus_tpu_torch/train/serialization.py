"""Reader and writer of the flax msgpack checkpoint layout, in pure Python
(the port's own codec of what `flax.serialization.to_bytes` /
`msgpack_restore` read and write; neither flax nor msgpack is imported).

The subset of msgpack a flax state dict uses:
  maps with str keys, arrays, str, bin, int, float, bool and nil;
  ext type 1, an ndarray: the msgpack of (shape, dtype name, C bytes);
  ext type 3, a numpy scalar (the np.int64 step): the same payload of its
    0-d array;
  arrays over `chunk_size` bytes (2**30, flax's MAX_CHUNK_SIZE) as
    {'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...},
     'chunks': {'0': flat[0:n], ...}} of n = chunk_size // itemsize
    elements each.

`dump` writes each array's buffer straight to the file after its headers,
without an encoded copy; `load` reads the file into one writable buffer
and returns arrays that are views of it (np.frombuffer), so a chunked array
is the only one copied (its chunks are joined).

`packb` / `unpackb` are plain msgpack (what msgpack.packb(default=...,
use_bin_type=True) and msgpack.unpackb(object_hook=..., raw=False,
strict_map_key=False) write and read: keys of any type, bin apart from
str, floats as float64, ints in their shortest form, map order kept), the
codec of the GemBench episode records (train/datasets/store.py).
"""
from __future__ import annotations

import io
import os
import struct

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------- encode --

def _uint_header(n, small, codes):
    """Length header: fix form below `small`, else the 8/16/32-bit code."""
    if n < small:
        return bytes([codes[0] | n])
    for code, fmt, top in zip(codes[1:], (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(v):
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _pack_str(s):
    b = s.encode("utf-8")
    return _uint_header(len(b), 32, (0xA0, 0xD9, 0xDA, 0xDB)) + b


def _bin_header(n):
    return _uint_header(n, 0, (0, 0xC4, 0xC5, 0xC6))


def _array_header(n):
    return _uint_header(n, 16, (0x90, None, 0xDC, 0xDD))


def _map_header(n):
    return _uint_header(n, 16, (0x80, None, 0xDE, 0xDF))


def _ext_header(code, n):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _uint_header(n, 0, (0, 0xC7, 0xC8, 0xC9)) + bytes([code])


def _ndarray_parts(arr):
    """(payload headers, raw buffer) of flax's ndarray encoding."""
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    if not arr.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    head = (bytes([0x93]) + _array_header(arr.ndim) +
            b"".join(_pack_int(int(d)) for d in arr.shape) +
            _pack_str(arr.dtype.name) + _bin_header(arr.nbytes))
    return head, arr.reshape(-1).view(np.uint8)


def _chunk(arr, chunk_size):
    n = max(1, chunk_size // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + n] for i, j in
                       enumerate(range(0, flat.size, n))}}


def dump(tree, f, chunk_size=MAX_CHUNK_SIZE):
    """Writes `tree` (nested dicts with str keys, lists, Python scalars,
    bytes, np.ndarray and numpy scalars) to the binary file `f`."""
    if isinstance(tree, np.ndarray):
        if tree.nbytes > chunk_size:
            return dump(_chunk(tree, chunk_size), f, chunk_size)
        head, body = _ndarray_parts(tree)
        f.write(_ext_header(_EXT_NDARRAY, len(head) + body.size) + head)
        f.write(memoryview(body))
    elif isinstance(tree, np.generic):
        head, body = _ndarray_parts(np.asarray(tree))
        f.write(_ext_header(_EXT_NPSCALAR, len(head) + body.size) + head)
        f.write(body.tobytes())
    elif isinstance(tree, dict):
        f.write(_map_header(len(tree)))
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"state dict keys are str, got {k!r}")
            f.write(_pack_str(k))
            dump(v, f, chunk_size)
    elif isinstance(tree, (list, tuple)):
        f.write(_array_header(len(tree)))
        for v in tree:
            dump(v, f, chunk_size)
    elif tree is None:
        f.write(b"\xc0")
    elif isinstance(tree, bool):
        f.write(b"\xc3" if tree else b"\xc2")
    elif isinstance(tree, int):
        f.write(_pack_int(tree))
    elif isinstance(tree, float):
        f.write(b"\xcb" + struct.pack(">d", tree))
    elif isinstance(tree, str):
        f.write(_pack_str(tree))
    elif isinstance(tree, (bytes, bytearray, memoryview)):
        f.write(_bin_header(len(tree)) + bytes(tree))
    else:
        raise TypeError(f"cannot serialize {type(tree).__name__}")


def packb(obj, default=None):
    """msgpack bytes of `obj` (None, bool, int, float, str, bytes, lists,
    tuples and dicts); any other object is replaced by default(obj)."""
    out = []

    def put(o):
        if o is None:
            out.append(b"\xc0")
        elif isinstance(o, bool):
            out.append(b"\xc3" if o else b"\xc2")
        elif isinstance(o, int):
            out.append(_pack_int(o))
        elif isinstance(o, float):
            out.append(b"\xcb" + struct.pack(">d", o))
        elif isinstance(o, (bytes, bytearray, memoryview)):
            out.append(_bin_header(len(o)) + bytes(o))
        elif isinstance(o, str):
            out.append(_pack_str(o))
        elif isinstance(o, dict):
            out.append(_map_header(len(o)))
            for k, v in o.items():
                put(k)
                put(v)
        elif isinstance(o, (list, tuple)):
            out.append(_array_header(len(o)))
            for v in o:
                put(v)
        elif default is not None:
            put(default(o))
        else:
            raise TypeError(f"cannot serialize {type(o).__name__}")

    put(obj)
    return b"".join(out)


def dumps(tree, chunk_size=MAX_CHUNK_SIZE):
    buf = io.BytesIO()
    dump(tree, buf, chunk_size)
    return buf.getvalue()


def save(path, tree):
    """dump into `path` through a temporary file renamed into place, so
    that an interrupted save leaves the previous file whole."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        dump(tree, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------- decode --

_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# type byte -> (kind, struct format of its length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}


class _Reader:
    def __init__(self, buf, object_hook=None):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0
        self.object_hook = object_hook

    def take(self, n):
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def read(self, raw_bin=False):
        """The next object; bin as bytes, or as a view of the buffer with
        raw_bin (an array's data)."""
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SCALARS:
            fmt = _SCALARS[b]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in _FIXEXT:
            return self._ext(self.take(1)[0], _FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
            if kind == "bin":
                return self.take(n) if raw_bin else bytes(self.take(n))
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(self.take(1)[0], n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out if self.object_hook is None else self.object_hook(out)

    def _ext(self, code, n):
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        if self.take(1)[0] != 0x93:     # (shape, dtype name, data)
            raise ValueError("malformed ndarray ext payload")
        shape, name = self.read(), self.read()
        data = self.read(raw_bin=True)
        if self.pos != end:
            raise ValueError("malformed ndarray ext payload")
        if isinstance(name, bytes):
            name = name.decode("ascii")
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(buf):
    """Decodes msgpack bytes; arrays are views of `buf` (writable when
    `buf` is)."""
    reader = _Reader(buf)
    tree = reader.read()
    if reader.pos != len(reader.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def unpackb(buf, object_hook=None):
    """Decodes plain msgpack bytes (bin as bytes, str as str); every map
    is passed through object_hook(map) when one is given."""
    reader = _Reader(buf, object_hook)
    obj = reader.read()
    if reader.pos != len(reader.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def load(path):
    """Reads `path` into one writable buffer and decodes it."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise IOError(f"{path}: short read")
    return loads(buf)

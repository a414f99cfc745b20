"""The msgpack subset that flax's ``serialization.msgpack_serialize`` and
``msgpack_restore`` use, read and written without the ``msgpack`` package.

The JAX package's checkpoints are flax msgpack
(``clip_lite_tpu/utils/checkpointing.py``); this module is the port's
counterpart of those flax calls, in Python and numpy alone.  What it
reads and writes:

* maps with str keys, written in sorted key order (flax maps every tree
  through ``jax.tree_util``, which sorts dict keys), and the ``nil``,
  bool, int, float64, str and bin types;
* an array as ext type 1, a numpy scalar as ext type 3: each carries a
  msgpack array of (shape, dtype name, the C-order buffer).  A leaf may
  be a numpy array or a CPU ``torch.Tensor``; bfloat16 (numpy has no such
  dtype) is read back as a torch tensor;
* an array above ``MAX_CHUNK_SIZE`` bytes as flax's
  ``__msgpack_chunked_array__`` map of flat chunks, on write and on read.

:func:`write` streams each leaf's buffer straight to the file, so a
checkpoint is never assembled in memory; :func:`read` maps the file and
returns each array as a view of the mapping (no copy per leaf).
"""

from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Any, BinaryIO, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                      torch.float16: "float16", torch.bfloat16: "bfloat16",
                      torch.int64: "int64", torch.int32: "int32",
                      torch.int16: "int16", torch.int8: "int8",
                      torch.uint8: "uint8", torch.bool: "bool"}


# -- writing ---------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Tuple[int, int], codes) -> bytes:
    """The header of a str, bin, array or map of length ``n``: a fix form
    (base, limit) where there is one, else the first code whose length
    field holds ``n``."""
    if fix and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack's 32 bits")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), (0xA0, 32),
                  ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + data


def _bin_header(n: int) -> bytes:
    return _sized(n, (), ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), ((0xDE, ">H"), (0xDF, ">I")))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), ((0xDC, ">H"), (0xDD, ">I")))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _sized(n, (), ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    return head + struct.pack(">b", code)


def _leaf_buffer(x) -> Tuple[tuple, str, np.ndarray]:
    """(shape, dtype name, a C-contiguous numpy array of its bytes)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError("msgpack_io writes CPU tensors; copy to the host "
                            "first")
        if x.dtype not in _TORCH_DTYPE_NAMES:
            raise TypeError(f"unsupported tensor dtype {x.dtype}")
        x = x.detach().contiguous()
        raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return tuple(x.shape), _TORCH_DTYPE_NAMES[x.dtype], raw.numpy()
    arr = np.asarray(x, order="C")  # np.ascontiguousarray makes 0-d 1-d
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError(f"unsupported array dtype {arr.dtype}")
    return arr.shape, arr.dtype.name, arr


def _write_array(f: BinaryIO, x, code: int = EXT_NDARRAY) -> None:
    shape, name, arr = _leaf_buffer(x)
    inner = (b"\x93" + _array_header(len(shape))
             + b"".join(_int(int(d)) for d in shape) + _str(name)
             + _bin_header(arr.nbytes))
    f.write(_ext_header(len(inner) + arr.nbytes, code))
    f.write(inner)
    if arr.nbytes:
        f.write(memoryview(arr.reshape(-1)).cast("B"))


def _write_chunked(f: BinaryIO, x) -> None:
    """flax's ``_chunk``: the map keeps its insertion order."""
    shape, _, arr = _leaf_buffer(x)
    flat = arr.reshape(-1)
    step = max(1, MAX_CHUNK_SIZE // flat.dtype.itemsize)
    chunks = [flat[i: i + step] for i in range(0, flat.size, step)]
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        chunks = [torch.from_numpy(c).view(torch.bfloat16) for c in chunks]
    f.write(_map_header(3) + _str(_CHUNKED) + b"\xc3")
    f.write(_str("shape") + _map_header(len(shape)))
    for i, d in enumerate(shape):
        f.write(_str(str(i)) + _int(int(d)))
    f.write(_str("chunks") + _map_header(len(chunks)))
    for i, c in enumerate(chunks):
        f.write(_str(str(i)))
        _write_array(f, c)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else np.asarray(x).nbytes


def dump(f: BinaryIO, tree: Any) -> None:
    """Write ``tree`` to the binary file ``f`` as flax's
    ``msgpack_serialize`` would."""
    if isinstance(tree, dict):
        f.write(_map_header(len(tree)))
        for key in sorted(tree):
            if not isinstance(key, str):
                raise TypeError(f"map key {key!r} is not a str")
            f.write(_str(key))
            dump(f, tree[key])
    elif isinstance(tree, (np.ndarray, torch.Tensor)):
        if _nbytes(tree) > MAX_CHUNK_SIZE:
            _write_chunked(f, tree)
        else:
            _write_array(f, tree)
    elif isinstance(tree, np.generic):
        _write_array(f, np.asarray(tree), EXT_NPSCALAR)
    elif tree is None:
        f.write(b"\xc0")
    elif isinstance(tree, bool):
        f.write(b"\xc3" if tree else b"\xc2")
    elif isinstance(tree, int):
        f.write(_int(tree))
    elif isinstance(tree, float):
        f.write(b"\xcb" + struct.pack(">d", tree))
    elif isinstance(tree, str):
        f.write(_str(tree))
    elif isinstance(tree, (bytes, bytearray)):
        f.write(_bin_header(len(tree)) + bytes(tree))
    else:
        raise TypeError(f"cannot write {type(tree).__name__} as msgpack")


def pack(tree: Any) -> bytes:
    """``tree`` as bytes, equal to flax's ``msgpack_serialize(tree)``."""
    buf = io.BytesIO()
    dump(buf, tree)
    return buf.getvalue()


def write(path: str, tree: Any) -> int:
    """Write ``tree`` to ``path`` atomically: into ``path + ".tmp"``,
    flushed and fsynced, then renamed over ``path``, so that a crash never
    leaves a truncated file.  Returns the file's size in bytes."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        dump(f, tree)
        f.flush()
        os.fsync(f.fileno())
        size = f.tell()
    os.replace(tmp, path)
    return size


# -- reading ---------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = data
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (value,) = struct.unpack_from(fmt, self.take(size))
        return value

    def obj(self, raw: bool = False):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack({0xD9: ">B", 0xDA: ">H",
                                          0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack type byte {b:#x} is not supported")

    def text(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool):
        out = {}
        for _ in range(n):
            key = self.obj(raw)
            out[key] = self.obj(raw)
        if _CHUNKED in out:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        b = self.unpack(">B")
        if b != 0x93:
            raise ValueError("an array's ext payload is not a 3-array")
        shape = tuple(self.obj(raw=True))
        name = self.obj(raw=True).decode("ascii")
        b = self.unpack(">B")
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b not in lengths:
            raise ValueError("an array's buffer is not a bin")
        size = self.unpack(lengths[b])
        offset = self.pos
        self.take(size)
        if self.pos != end:
            raise ValueError("an array's ext payload has trailing bytes")
        arr = _array(self.buf, name, shape, offset, size)
        return arr[()] if code == EXT_NPSCALAR else arr


def _array(buf, name: str, shape: tuple, offset: int, size: int):
    if name == "bfloat16":
        if not size:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buf, dtype=torch.bfloat16, count=size // 2,
                                offset=offset).reshape(shape)
    dtype = np.dtype(name)
    return np.frombuffer(buf, dtype=dtype, count=size // dtype.itemsize,
                         offset=offset).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpack(data) -> Any:
    """The tree in ``data`` (bytes-like), as flax's ``msgpack_restore``
    gives it: maps as dicts, ext 1 as arrays that are views of ``data``,
    ext 3 as numpy scalars, chunked leaves joined."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def read(path: str) -> Any:
    """The tree in the file at ``path``, with each array a view of a
    private (copy-on-write) mapping of the file: no leaf is read from disk
    until it is used, and arrays are writable."""
    with open(path, "rb") as f:
        mapping = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return unpack(mapping)


__all__ = ["MAX_CHUNK_SIZE", "dump", "pack", "read", "unpack", "write"]

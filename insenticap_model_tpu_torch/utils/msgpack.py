"""A minimal msgpack decoder for the JAX package's checkpoints.

The checkpoints' array trees are written by flax's ``serialization.to_bytes``
(``insenticap_model_tpu/training/checkpoint.py:53-69``), which is msgpack
with one extension: ext type 1 holds an ndarray as a nested msgpack
``(shape, dtype name, C-order bytes)``. The machine with the card has no
``msgpack`` package, so the port reads the format itself.

Covered: nil, bool, positive and negative fixint, (u)int 8-64, float 32/64,
fixstr and str 8-32, bin 8-32, fixarray and array 16/32, fixmap and map
16/32, fixext 1-16 and ext 8-32. Arrays become CPU tensors; ``bfloat16``
(which numpy lacks) is read through its raw 16-bit pattern into
``torch.bfloat16``. flax's chunked arrays (``__msgpack_chunked_array__``,
leaves over 1 GiB) are reassembled. Any other ext type raises
``ValueError``, as does a truncated or malformed buffer. Arrays, maps and
strings come back as lists, dicts and ``str``; map keys keep their decoded
type.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"
_LEN8_16_32 = (">B", ">H", ">I")
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _dtype_name(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def _array(data: bytes) -> torch.Tensor:
    """Ext type 1 payload -> a CPU tensor (a copy, so it is writable)."""
    shape, dtype, buf = unpackb(data, _arrays=False)
    dtype = _dtype_name(dtype)
    if not isinstance(shape, list) or not isinstance(buf, bytes):
        raise ValueError("msgpack ndarray: malformed (shape, dtype, bytes)")
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype="<i2").reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype))
    except TypeError as e:
        raise ValueError(f"msgpack ndarray: dtype {dtype!r}") from e
    return torch.from_numpy(arr.reshape(shape).copy())


def _unchunk(node: dict) -> torch.Tensor:
    n = len(node["chunks"])
    flat = torch.cat([node["chunks"][str(i)].reshape(-1) for i in range(n)])
    shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
    return flat.reshape(shape)


class _Reader:
    __slots__ = ("buf", "pos", "arrays")

    def __init__(self, buf: bytes, arrays: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        self.arrays = arrays

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated buffer")
        out = self.buf[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def ext(self, code: int, size: int):
        data = self.take(size)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        return _array(data) if self.arrays else data

    def seq(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if self.arrays and out.get(_CHUNKED) is True:
            return _unchunk(out)
        return out

    def value(self) -> Any:   # noqa: C901 — one branch per format byte
        (b,) = self.take(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.seq(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:                      # bin 8/16/32
            (n,) = self.unpack(_LEN8_16_32[b - 0xC4])
            return self.take(n)
        if 0xC7 <= b <= 0xC9:                      # ext 8/16/32
            (n,) = self.unpack(_LEN8_16_32[b - 0xC7])
            (code,) = self.unpack(">b")
            return self.ext(code, n)
        if b == 0xCA:
            return self.unpack(">f")[0]
        if b == 0xCB:
            return self.unpack(">d")[0]
        if b in _INTS:
            return self.unpack(_INTS[b])[0]
        if 0xD4 <= b <= 0xD8:                      # fixext 1/2/4/8/16
            (code,) = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:                      # str 8/16/32
            (n,) = self.unpack(_LEN8_16_32[b - 0xD9])
            return self.take(n).decode()
        if b in (0xDC, 0xDD):
            (n,) = self.unpack(">H" if b == 0xDC else ">I")
            return self.seq(n)
        if b in (0xDE, 0xDF):
            (n,) = self.unpack(">H" if b == 0xDE else ">I")
            return self.map(n)
        raise ValueError(f"msgpack: unknown format byte 0x{b:02x}")


def unpackb(data: bytes, *, _arrays: bool = True) -> Any:
    """Decode one msgpack object that fills ``data`` exactly."""
    r = _Reader(data, _arrays)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out

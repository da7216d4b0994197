"""Image-feature stores: the port's copy of the native record format of
``insenticap_model_tpu/data/feature_store.py`` (:86-194), read with numpy.

    MAGIC "ISCF0001" | u64 index length | index JSON | records

The index JSON is ``{"dtype", "shape", "entries": {file name: record}}``;
every record has the one shape and dtype, so the data region is one
[records, *shape] array, memory-mapped here. The JAX package reads the
same file (through its C++ reader or numpy). The reference's HDF5 files
are not read: the card's machine has no h5py, and ``open_store`` refuses
one with a message naming the ``.isc`` format (the JAX package's feature
extraction writes it under ``store_format="isc"``, and so does the
port's ``synthetic.build_tree``).

Every store has ``get(fn)`` and ``batch(fns)`` (float32 by default).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Sequence

import numpy as np

MAGIC = b"ISCF0001"


class MemoryFeatureStore:
    """Dict-backed, for tests and small runs."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self._data = data

    def get(self, fn):
        return self._data[fn]

    def batch(self, fns: Sequence[str]) -> np.ndarray:
        return np.stack([self.get(fn) for fn in fns])

    def keys(self) -> List[str]:
        return list(self._data.keys())


def write_native_store(path: str, data_iter, shape,
                       dtype="float16") -> None:
    """``data_iter`` yields (fn, array of ``shape``); written through a
    temporary file and ``os.replace``. The records go to a scratch file
    first, as the index (which precedes them) is known only at the end."""
    entries = {}
    scratch = path + ".tmp"
    with open(scratch, "wb") as f:
        for fn, arr in data_iter:
            arr = np.ascontiguousarray(arr, dtype=dtype)
            if arr.shape != tuple(shape):
                raise ValueError(f"{fn}: shape {arr.shape} != {tuple(shape)}")
            f.write(arr.tobytes())
            entries[fn] = len(entries)
    index = json.dumps({"dtype": np.dtype(dtype).name, "shape": list(shape),
                        "entries": entries}).encode()
    final = path + ".tmp2"
    with open(final, "wb") as out, open(scratch, "rb") as src:
        out.write(MAGIC)
        out.write(struct.pack("<Q", len(index)))
        out.write(index)
        while True:
            chunk = src.read(1 << 24)
            if not chunk:
                break
            out.write(chunk)
    os.remove(scratch)
    os.replace(final, path)


class NativeFeatureStore:
    """A memory-mapped record file; ``batch`` gathers the records in one
    numpy take and widens them to ``out_dtype``."""

    def __init__(self, path: str, out_dtype=np.float32):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}")
            (ilen,) = struct.unpack("<Q", f.read(8))
            index = json.loads(f.read(ilen).decode())
            data_off = f.tell()
        self.dtype = np.dtype(index["dtype"])
        self.shape = tuple(index["shape"])
        self.entries: Dict[str, int] = index["entries"]
        rec_elems = int(np.prod(self.shape))
        n = (os.path.getsize(path) - data_off) // (rec_elems
                                                  * self.dtype.itemsize)
        self._mm = np.memmap(path, mode="r", dtype=self.dtype,
                             offset=data_off, shape=(n, rec_elems))
        self.out_dtype = out_dtype

    def get(self, fn):
        rec = self._mm[self.entries[fn]]
        return np.asarray(rec, dtype=self.out_dtype).reshape(self.shape)

    def batch(self, fns: Sequence[str]) -> np.ndarray:
        idx = np.asarray([self.entries[fn] for fn in fns], np.int64)
        return self._mm[idx].astype(self.out_dtype, copy=False).reshape(
            (len(fns),) + self.shape)

    def keys(self) -> List[str]:
        return list(self.entries.keys())


def open_store(path: str) -> NativeFeatureStore:
    """Open a native (``.isc``) record store; refuse anything else."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic != MAGIC:
        hdf5 = magic == b"\x89HDF\r\n\x1a\n"
        raise ValueError(
            f"{path}: {'an HDF5 file' if hdf5 else 'not a feature store'}; "
            "the port reads the native record format (.isc, magic "
            "ISCF0001, which the JAX package's feature extraction writes "
            "with store_format='isc') and does not read HDF5")
    return NativeFeatureStore(path)

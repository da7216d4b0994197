"""ctypes binding of the feature-store gather (``csrc/fstore.cc``).

The port's copy of ``insenticap_model_tpu/utils/native.py``:41-86.
``FStoreReader`` gathers a batch of records in one C call, over
``pread`` threads with the GIL released, fp16 widened to fp32 in the
workers. The library is built at first use by ``ops/_build.load_host``
(the host's C++ compiler) into the git-ignored build directory; a
missing compiler or a failed build raises, as everywhere in the port.
"""
from __future__ import annotations

import ctypes

import numpy as np

_I64 = ctypes.c_int64
_SIGS = {"fstore_open": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                         ctypes.POINTER(_I64)],
         "fstore_gather": [_I64, ctypes.c_void_p, _I64, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int],
         "fstore_close": [_I64]}


def _lib():
    from ..ops import _build
    return _build.load_host("fstore", _SIGS)


class FStoreReader:
    """Random access to the records of a native store (the layout is in
    ``data/feature_store.py``): ``data_off`` is where the records start,
    each ``rec_elems`` elements of ``dtype``."""

    def __init__(self, path: str, data_off: int, dtype, rec_elems: int,
                 num_threads: int = 8):
        self.dtype = np.dtype(dtype)
        self.rec_elems = int(rec_elems)
        self.rec_bytes = self.rec_elems * self.dtype.itemsize
        self.widen = int(self.dtype == np.float16)
        self.num_threads = num_threads
        self._h = -1
        h = _I64(-1)
        if _lib().fstore_open(path.encode(), data_off, self.rec_bytes,
                              ctypes.byref(h)) != 0:
            raise OSError(f"fstore_open failed for {path}")
        self._h = h.value

    @property
    def out_dtype(self):
        return np.dtype(np.float32) if self.widen else self.dtype

    def read(self, idx: int) -> np.ndarray:
        return self.gather(np.asarray([idx], np.int64))[0]

    def gather(self, idxs) -> np.ndarray:
        """[n] indices -> [n, rec_elems] array (fp16 widened to fp32).
        Raises IOError where a record cannot be read whole."""
        idxs = np.ascontiguousarray(idxs, np.int64)
        out = np.empty((len(idxs), self.rec_elems), self.out_dtype)
        if _lib().fstore_gather(self._h, idxs.ctypes.data, len(idxs),
                                out.ctypes.data, self.widen,
                                self.num_threads) != 0:
            raise IOError("fstore_gather failed")
        return out

    def close(self):
        if self._h >= 0:
            _lib().fstore_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

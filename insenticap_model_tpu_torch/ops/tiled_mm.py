"""Row-tiled matrix product with a resident weight (CUDA kernel + plain twin).

Replaces the Pallas kernel ``tools/bench_megacell.py`` ``_mm_kernel`` (:71,
through ``pallas_tiled_mm`` :76-96): out = x @ w with f32 accumulation, out
in x's dtype, the rows cut into tiles of ``tile_rows``. It is the decode
cell's LSTM product as a fused per-image-tile kernel would have to run it:
tile_b images x beam rows a tile (24, 48 or 96) against the whole weight.
The kernel (``csrc/tiled_mm.cu``, bf16) keeps w resident in L2 rather than
in a block's shared memory, which cannot hold it, and pads a tile of 24 rows
to 32 for ``mma.sync``; see the source's header.

What bounds it on the H100 at [1152, 1536] x [1536, 2048] (bf16): 7.25
GFLOP, 0.0073 ms at 989 TFLOP/s, against 14.5 MB, 0.0043 ms: operations.

``tiled_mm`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (bf16 only, no operand requiring grad), or
raises; ``tiled_mm.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import nn
from . import _build

MAX_TILE_ROWS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"isc_tiled_mm_bf16": [_P, _P, _P, _I, _I, _I, _I, _P]}


def _lib():
    return _build.load("tiled_mm", _SIGS)


def tiled_mm_plain(x, w):
    """(x.float() @ w.float()).to(x.dtype): the kernel's function, f32
    sums and one rounding (the row tiles do not change it)."""
    with nn.exact_numerics():
        return (x.float() @ w.float()).to(x.dtype)


def tiled_mm(x, w, *, tile_rows: int):
    """x [rows, K] @ w [K, N] -> [rows, N] in x's dtype, the rows in tiles
    of ``tile_rows``, which must divide rows (the Pallas grid ``rows //
    tile_rows`` would leave a remainder unwritten). The kernel takes bf16,
    K and N multiples of 8 and tile_rows <= 128."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiled_mm shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    rows, K = x.shape
    N = w.shape[1]
    if tile_rows < 1 or rows % tile_rows:
        raise ValueError(f"tiled_mm: tile_rows={tile_rows} does not divide "
                         f"rows={rows}")
    if x.device.type == "cpu":
        return tiled_mm_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"tiled_mm: devices {x.device}, {w.device}")
    _build.no_grad_guard("tiled_mm", x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"tiled_mm: the kernel takes bfloat16: {x.dtype}, "
                        f"{w.dtype}")
    if tile_rows > MAX_TILE_ROWS or K % 8 or N % 8:
        raise ValueError(f"tiled_mm needs tile_rows <= {MAX_TILE_ROWS} "
                         f"(got {tile_rows}) and K, N % 8 == 0 (K={K}, "
                         f"N={N})")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("tiled_mm needs 16-byte aligned operands")
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    _build.check(_lib().isc_tiled_mm_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, tile_rows, K, N,
        _build.stream_ptr(x.device)), "tiled_mm")
    tiled_mm.launches += 1
    return out


tiled_mm.launches = 0

"""Row-tiled matrix product with a resident weight (CUDA kernel + plain twin).

Replaces the Pallas kernel ``tools/bench_megacell.py`` ``_mm_kernel`` (:71,
through ``pallas_tiled_mm`` :76-96): out = x @ w with f32 accumulation, out
in x's dtype, the rows cut into tiles of ``tile_rows``. It is the decode
cell's LSTM product as a fused per-image-tile kernel would have to run it:
tile_b images x beam rows a tile (24, 48 or 96) against the whole weight.

The kernel (``csrc/tiled_mm.cu``, bf16) gives each CTA a slab of 64 columns
of w, resident in shared memory for the whole K, and walks a group of row
tiles against it: x streams through a ring of TMA copies (one 64-wide K
panel of up to 48 rows a stage) into ``wgmma`` with the tile's rows as the
product's n (no row of a 24-, 48- or 96-row tile is padded). Where the slab
does not fit beside the ring, the same kernel streams w with x. ``plan``
makes these choices; see the source's header.

What bounds it on the H100 at [1152, 1536] x [1536, 2048] (bf16): 7.25
GFLOP, 0.0073 ms at 989 TFLOP/s, against 14.5 MB, 0.0043 ms: operations.

``tiled_mm`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (bf16 only, no operand requiring grad), or
raises; ``tiled_mm.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import nn
from . import _build

MAX_TILE_ROWS = 128
# the kernel's constants (csrc/tiled_mm.cu; tests/test_torch_tiled_mm_source.py
# holds the two sides together)
SLAB_COLS = 64                  # columns of w a CTA
PANEL_K = 64                    # K a ring stage: one 128-byte swizzle row
MAX_STAGE_ROWS = 48             # a tile of more rows takes two stages a panel
NARROW_STAGE, WIDE_STAGE = 6144, 12288   # bytes of x a stage, at least
PREFER_STAGES = 4               # a wide stage only where 4 groups' fit
SMEM_BUDGET = 232_448           # a block's shared memory, H100
ALIGN_PAD = 1024
MIN_STAGES, MAX_STAGES = 2, 16  # ring depth, in groups' stages
BARRIER_BYTES = 2 * 8 * MAX_STAGES   # a full and an empty mbarrier a stage
TILE_NS = (8, 16, 24, 32, 48, 64, 96, 128)   # the wgmma n a tile can take
H100_SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"isc_tiled_mm_bf16": [_P, _P, _P] + [_I] * 8 + [_P]}


class Plan(NamedTuple):
    n: int              # the tile's rows rounded up into TILE_NS
    stage_rows: int     # rows of a ring stage: n, or n / 2 above 48
    panels: int         # 64-wide K panels a stage
    wide: bool          # stages of WIDE_STAGE bytes, not NARROW_STAGE
    resident: bool      # the slab of w stays in shared memory
    stages: int         # ring depth
    groups: int         # row groups: the grid is (slabs, groups)
    smem: int           # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=256)
def plan(rows: int, tile_rows: int, K: int, N: int,
         sms: int = H100_SMS) -> Plan:
    """The kernel's path for x [rows, K] @ w [K, N] in tiles of
    ``tile_rows``. A stage holds enough 64-wide K panels for WIDE_STAGE or
    NARROW_STAGE bytes of x (K padded with zero panels to whole stages).
    In order of preference: w resident (its 64-column slab, all of the
    padded K, in shared memory) with a ring of PREFER_STAGES groups' wide
    stages, then of narrow ones, then of two groups' narrow ones; else w
    streamed with x, in wide stages (two groups' always fit). The ring takes
    as many stages as fit, up to 16; the grid as many row groups as fill
    one wave of ``sms`` CTAs (at most one a tile). The order is what
    measured fastest on the H100 at the decode cell's shapes (PERF.md).
    Cached, as the wrapper asks for a plan at every launch."""
    n = next(v for v in TILE_NS if v >= tile_rows)
    sr = n if n <= MAX_STAGE_ROWS else n // 2
    h = n // sr                              # stages a group
    w_panel = PANEL_K * SLAB_COLS * 2
    x_panel = sr * PANEL_K * 2
    room = SMEM_BUDGET - ALIGN_PAD - BARRIER_BYTES

    def shape(wide, resident):
        panels = -(-(WIDE_STAGE if wide else NARROW_STAGE) // x_panel)
        held = -(-K // (PANEL_K * panels)) * panels * w_panel if resident \
            else 0
        stage = panels * (x_panel + (0 if resident else w_panel))
        return panels, held, stage, (room - held) // stage

    # the last is always taken: two groups' wide stages of x and w fit at
    # every n (at n8, two of 110,592 bytes), so a streamed ring is wide
    for wide, resident, least in ((True, True, PREFER_STAGES * h),
                                  (False, True, PREFER_STAGES * h),
                                  (False, True, MIN_STAGES * h),
                                  (True, False, 0)):
        panels, held, stage, fit = shape(wide, resident)
        if fit >= least:
            break
    stages = min(MAX_STAGES, fit)
    slabs = -(-N // SLAB_COLS)
    groups = max(1, min(rows // tile_rows, sms // slabs))
    return Plan(n, sr, panels, wide, resident, stages, groups,
                ALIGN_PAD + BARRIER_BYTES + held + stages * stage)


def _lib():
    return _build.load("tiled_mm", _SIGS)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    p = plan(rows, tile_rows, K, N, _sms(x.device.index))
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    _build.check(_lib().isc_tiled_mm_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, tile_rows, K, N,
        int(p.resident), int(p.wide), p.stages, p.groups,
        _build.stream_ptr(x.device)),
        "tiled_mm")
    tiled_mm.launches += 1
    return out


tiled_mm.launches = 0

"""Chained Winograd F(5x5, 3x3) conv stack: three CUDA kernels + plain twins.

Replaces the Pallas kernels of ``insenticap_model_tpu/ops/winograd_pallas.py``
(``conv3x3_stack_sm``, :155-229): ``_input_kernel`` (:67), ``_middle_kernel``
(:99) and ``_output_kernel`` (:83). The kernels are in ``csrc/winograd.cu``;
each has a wrapper here that launches it for a CUDA tensor, runs its plain
PyTorch twin for a CPU tensor, and counts its launches (``.launches``);
on a CUDA tensor it raises where an operand requires grad (the kernels
have no backward: ``_build.no_grad_guard``):

  wino_input   x [H, W, B, C]        -> V [49, tiles, B, C]   V = B^T d B
  wino_middle  M [49, tiles, B, K]   -> V [49, tiles, B, K]   A^T M A + bias,
               trimmed to H x W, SAME re-padded, forward-transformed again
  wino_output  M [49, tiles, B, K]   -> y [H, W, B, K]        A^T M A + bias

with tiles = ceil(H/5) * ceil(W/5). The per-layer product V @ U between
them is a batched matrix product (``torch.bmm``), as it was an XLA
``dot_general`` outside the Pallas kernels; it runs in the serving dtype
with f32 accumulation and one rounding of its result, where the JAX code
casts ``m.astype(gemm_dtype)`` (winograd_pallas.py:200).

What bounds the kernels on the H100: bytes. At the detector's serving
shapes (bs=384, 2048 -> 1024 -> 512, bf16) they move about 1.0, 0.69 and
0.25 GB; the transforms are a few hundred f32 FMAs per 7x7 tile, under the
memory time once the zero terms of the transform matrices are skipped.
All three take one block a slab (one image, a run of 64 channels, a lane
two adjacent channels): the input kernel brings the slab's positions into
shared memory once with 16-byte ``cp.async`` (the 7x7 windows overlap at
stride 5), the middle one keeps the slab's f32 interior plane in shared
memory, so the activation between the two convs never reaches device
memory, and the output one loads each tile's 49 planes straight into
registers and writes the trimmed 5x5 with two-channel stores. The SAME
padding is applied on the fly (the input is never padded in memory) and
the output kernel writes only the H x W interior (see the source's
header). An operand whose base is not aligned to two elements, or an odd
channel count, takes the kernels' element-by-element path, never the
plain twin.

``wino_input`` reads x through its strides wherever its channels lie at
stride 1, so the detector's permuted NHWC features go in without a copy;
a base pointer or strides that are not 16-byte multiples take the
kernel's element-by-element load path, never the plain twin.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from . import _build
from .winograd import _AT5, _BT5, _G5, M5, MAX_TILES, T5, transform_filter

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SIGS = {}
for _sfx in _DT.values():
    _SIGS[f"isc_wino_input_{_sfx}"] = [_P, _P, _P, _I, _I, _I, _I, _L, _L,
                                       _L, _P]
    _SIGS[f"isc_wino_middle_{_sfx}"] = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    _SIGS[f"isc_wino_output_{_sfx}"] = [_P, _P, _P, _P, _I, _I, _I, _I, _P]

# B^T (49 values) then A^T (35), row-major f32: the kernels' constants
_MATS = np.ascontiguousarray(
    np.concatenate([_BT5.ravel(), _AT5.ravel()]).astype(np.float32))


def _lib():
    return _build.load("winograd", _SIGS)


def _tiles(h: int, w: int):
    return -(-h // M5), -(-w // M5)


# ---------------------------------------------------------------------------
# Plain twins (f32 transform arithmetic, the kernels' function)
# ---------------------------------------------------------------------------

def _forward_plain(plane):
    """Padded f32 plane [5*th+2, 5*tw+2, B, C] -> [49, th*tw, B, C] f32."""
    d = plane.unfold(0, T5, M5).unfold(1, T5, M5)      # [th, tw, B, C, 7, 7]
    bt = torch.as_tensor(_BT5, device=plane.device)
    with nn.exact_numerics():
        v = torch.einsum("ai,bj,xyncij->abxync", bt, bt, d)
    return v.reshape(T5 * T5, -1, *plane.shape[2:])


def _inverse_plain(m, bias, h: int, w: int):
    """[49, th*tw, B, K] + bias -> f32 [h, w, B, K]."""
    th, tw = _tiles(h, w)
    mm = m.float().reshape(T5, T5, th, tw, *m.shape[2:])
    at = torch.as_tensor(_AT5, device=m.device)
    with nn.exact_numerics():
        y = torch.einsum("xa,yb,abtunk->txuynk", at, at, mm)
    y = y.reshape(M5 * th, M5 * tw, *m.shape[2:])[:h, :w]
    return y + bias.float()


def _same_pad(y):
    """[h, w, B, C] -> [5*th+2, 5*tw+2, B, C]: one zero row/column before,
    the rest after (the SAME pad plus the tile overhang)."""
    h, w = y.shape[:2]
    th, tw = _tiles(h, w)
    return F.pad(y, (0, 0, 0, 0, 1, M5 * tw + 1 - w, 1, M5 * th + 1 - h))


def wino_input_plain(x, out_dtype=None):
    """x [H, W, B, C], any strides (the detector's permuted features
    included): the same numbers as for its contiguous copy."""
    return _forward_plain(_same_pad(x.float())).to(out_dtype or x.dtype)


def wino_middle_plain(m, bias, h: int, w: int):
    return _forward_plain(_same_pad(_inverse_plain(m, bias, h, w))).to(m.dtype)


def wino_output_plain(m, bias, h: int, w: int, out_dtype=None):
    return _inverse_plain(m, bias, h, w).to(out_dtype or m.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, t, ndim):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: device {t.device}")
    if t.dtype not in _DT:
        raise TypeError(f"{name}: dtype {t.dtype} (float32 or bfloat16)")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")


def _check_extent(name, h, w):
    th, tw = _tiles(h, w)
    if h < 1 or w < 1 or th > MAX_TILES or tw > MAX_TILES:
        raise ValueError(f"{name}: spatial extent {h}x{w} outside the "
                         f"kernel's cap of {M5 * MAX_TILES}x{M5 * MAX_TILES}")


def _bias_f32(name, bias, m):
    if bias.shape != (m.shape[-1],) or bias.device != m.device:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} on "
                         f"{bias.device} for {tuple(m.shape)} on {m.device}")
    return bias.float().contiguous()   # exact from bf16; the kernel sums f32


def wino_input(x):
    """x [H, W, B, C] -> V [49, tiles, B, C] in x's dtype. x may be any
    view whose channels lie at stride 1 (the kernel takes the other three
    strides); another layout is copied first."""
    if x.device.type == "cpu":
        return wino_input_plain(x)
    _build.no_grad_guard("wino_input", x)
    _check("wino_input", x, 4)
    h, w, bsz, c = x.shape
    _check_extent("wino_input", h, w)
    th, tw = _tiles(h, w)
    if x.stride(3) != 1:
        x = x.contiguous()
    v = torch.empty((T5 * T5, th * tw, bsz, c), dtype=x.dtype,
                    device=x.device)
    fn = getattr(_lib(), f"isc_wino_input_{_DT[x.dtype]}")
    with _build.launch("wino_input", x, v) as stream:
        _build.check(fn(x.data_ptr(), v.data_ptr(), _MATS.ctypes.data, h, w,
                        bsz, c, x.stride(0), x.stride(1), x.stride(2),
                        stream), "wino_input")
    _build.count(wino_input)
    return v


def wino_middle(m, bias, h: int, w: int):
    """M [49, tiles, B, K] + bias [K] -> V [49, tiles, B, K] for the next
    conv of the chain, in M's dtype."""
    if m.device.type == "cpu":
        return wino_middle_plain(m, bias, h, w)
    _build.no_grad_guard("wino_middle", m, bias)
    _check("wino_middle", m, 4)
    _check_extent("wino_middle", h, w)
    th, tw = _tiles(h, w)
    if m.shape[:2] != (T5 * T5, th * tw):
        raise ValueError(f"wino_middle: M {tuple(m.shape)} for {h}x{w}")
    b32 = _bias_f32("wino_middle", bias, m)
    m = m.contiguous()
    v = torch.empty_like(m)
    k = m.shape[-1]
    fn = getattr(_lib(), f"isc_wino_middle_{_DT[m.dtype]}")
    with _build.launch("wino_middle", m, b32, v) as stream:
        _build.check(fn(m.data_ptr(), b32.data_ptr(), v.data_ptr(),
                        _MATS.ctypes.data, h, w, k, m.shape[2] * k, stream),
                     "wino_middle")
    _build.count(wino_middle)
    return v


def wino_output(m, bias, h: int, w: int):
    """M [49, tiles, B, K] + bias [K] -> y [h, w, B, K] in M's dtype."""
    if m.device.type == "cpu":
        return wino_output_plain(m, bias, h, w)
    _build.no_grad_guard("wino_output", m, bias)
    _check("wino_output", m, 4)
    _check_extent("wino_output", h, w)
    th, tw = _tiles(h, w)
    if m.shape[:2] != (T5 * T5, th * tw):
        raise ValueError(f"wino_output: M {tuple(m.shape)} for {h}x{w}")
    b32 = _bias_f32("wino_output", bias, m)
    m = m.contiguous()
    bsz, k = m.shape[2], m.shape[3]
    y = torch.empty((h, w, bsz, k), dtype=m.dtype, device=m.device)
    fn = getattr(_lib(), f"isc_wino_output_{_DT[m.dtype]}")
    with _build.launch("wino_output", m, b32, y) as stream:
        _build.check(fn(m.data_ptr(), b32.data_ptr(), y.data_ptr(),
                        _MATS.ctypes.data, h, w, k, bsz * k, stream),
                     "wino_output")
    _build.count(wino_output)
    return y


wino_input.launches = 0
wino_middle.launches = 0
wino_output.launches = 0


def conv3x3_stack_sm(x, layers, variant: str = "f5"):
    """A chain of 3x3 SAME convs with no nonlinearity between them, in the
    Winograd domain from end to end: one input transform, one batched
    product per layer, one middle kernel per junction, one output
    transform. x [H, W, B, C] spatial-major; layers = [(w HWIO, b or None),
    ...]. Returns [H, W, B, K_last] in x's dtype. The product runs in bf16
    for bf16 x and in f32 otherwise (the JAX package's ``gemm_dtype``)."""
    if variant != "f5":
        raise ValueError(f"variant {variant!r}: the port carries F(5x5,3x3) "
                         "only")
    if not layers:
        raise ValueError("conv3x3_stack_sm needs at least one conv layer")
    h, w, bsz, _ = x.shape
    th, tw = _tiles(h, w)
    gemm_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 \
        else torch.float32
    v = wino_input(x.to(gemm_dtype))
    for li, (wt, b) in enumerate(layers):
        cin, cout = wt.shape[2], wt.shape[3]
        with nn.exact_numerics():
            u = transform_filter(wt, _G5).to(gemm_dtype).reshape(
                T5 * T5, cin, cout)
            m = torch.bmm(v.reshape(T5 * T5, th * tw * bsz, cin), u)
        m = m.reshape(T5 * T5, th * tw, bsz, cout)
        bias = b if b is not None else torch.zeros(cout, device=x.device)
        if li == len(layers) - 1:
            return wino_output(m, bias, h, w).to(x.dtype)
        v = wino_middle(m, bias, h, w)

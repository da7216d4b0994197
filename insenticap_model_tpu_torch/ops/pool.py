"""The encoder stem's ceil-mode 3x3/stride-2 max pool: CUDA kernel + plain
version.

Replaces the Pallas kernel ``insenticap_model_tpu/ops/pool_pallas.py``
``_pool_kernel`` (:38), with its two public forms
``ceil_maxpool_3x3s2_sm`` (:95, spatial-major ``[H, W, B, C]``) and
``ceil_maxpool_3x3s2_nhwc`` (:140, ``[B, H, W, C]``). The function is
MaxPool2d(3, stride 2, padding 0, ceil_mode=True) (reference
models/encoder.py:12): ``oh = ceil((H - 3) / 2) + 1`` (likewise ``ow``), and
window taps past the bottom/right edge count as -inf. Max is exact, so the
kernel equals the plain version bit for bit in f32 and bf16.

What bounds it on the H100: bytes (nine loads and eight comparisons an
output, no other arithmetic). bf16 at bs=32, 448x448 reads [32,224,224,64]
(205.5 MB) and writes [32,112,112,64] (51.4 MB): 0.077 ms at 3.35 TB/s. The
design (``csrc/maxpool.cu``): one thread an output pixel x 16 bytes of
channels, neighbouring threads on neighbouring channels, the edge masked in
registers, the four strides passed in, so the ``_sm`` form launches the same
kernel on a permuted view. A scalar instance takes what the 16-byte path
cannot (a channel count, stride or pointer not 16-byte aligned).

Both forms run the plain version for a CPU tensor and launch the kernel for
a CUDA tensor (raising where it requires grad: the kernel has no
backward); ``ceil_maxpool_3x3s2_nhwc.launches`` counts the launches of
both (one per call).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# x, y, B, H, W, C, x strides (b, h, w), y strides (b, h, w), vec, stream
_SIG = [_P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, _P]
_FNS = {torch.float32: "isc_maxpool_f32", torch.bfloat16: "isc_maxpool_bf16"}


def _lib():
    return _build.load("maxpool", {fn: _SIG for fn in _FNS.values()})


def out_extent(n: int) -> int:
    """ceil((n - 3) / 2) + 1, the ceil-mode output extent (0 for n < 2)."""
    return -(-(n - 3) // 2) + 1


def ceil_maxpool_3x3s2_plain(x):
    """The kernel's function in PyTorch, NHWC: -inf padding on the bottom
    and right to the extent the windows reach, then the max of the nine
    stride-2 slices (the ``reduce_window`` definition of the JAX package's
    ``encoder._ceil_maxpool_3x3s2``, encoder.py:132-143)."""
    H, W = x.shape[1], x.shape[2]
    oh, ow = out_extent(H), out_extent(W)
    ph = max(0, 2 * (oh - 1) + 3 - H)
    pw = max(0, 2 * (ow - 1) + 3 - W)
    xp = F.pad(x, (0, 0, 0, pw, 0, ph), value=float("-inf"))
    out = None
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + 2 * oh - 1:2, dj:dj + 2 * ow - 1:2]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def _launch(xv, yv):
    """Run the kernel from xv [B, H, W, C] into yv [B, oh, ow, C], both
    views with unit channel stride."""
    if xv.device.type != "cuda":
        raise ValueError(f"ceil_maxpool_3x3s2 kernel: device {xv.device}")
    _build.no_grad_guard("ceil_maxpool_3x3s2", xv)
    if xv.dtype not in _FNS:
        raise TypeError(f"ceil_maxpool_3x3s2: dtype {xv.dtype} (float32 or "
                        "bfloat16)")
    if xv.dim() != 4:
        raise ValueError(f"ceil_maxpool_3x3s2: expected 4 dims, got "
                         f"{tuple(xv.shape)}")
    B, H, W, C = xv.shape
    if xv.stride(3) != 1:
        raise ValueError("ceil_maxpool_3x3s2: the channel axis must be "
                         f"contiguous (strides {xv.stride()})")
    if min(B, C) < 1 or min(H, W) < 2:
        raise ValueError(f"ceil_maxpool_3x3s2: extent {tuple(xv.shape)}")
    vec = 16 // xv.element_size()
    aligned = (C % vec == 0
               and all(s % vec == 0 for s in xv.stride()[:3] + yv.stride()[:3])
               and xv.data_ptr() % 16 == 0 and yv.data_ptr() % 16 == 0)
    fn = getattr(_lib(), _FNS[xv.dtype])
    _build.check(fn(xv.data_ptr(), yv.data_ptr(), B, H, W, C,
                    *xv.stride()[:3], *yv.stride()[:3],
                    vec if aligned else 1, _build.stream_ptr(xv.device)),
                 "ceil_maxpool_3x3s2")
    ceil_maxpool_3x3s2_nhwc.launches += 1
    return yv


def ceil_maxpool_3x3s2_nhwc(x):
    """x [B, H, W, C] (f32 or bf16) -> [B, oh, ow, C] in x's dtype."""
    if x.device.type == "cpu":
        return ceil_maxpool_3x3s2_plain(x)
    B, H, W, C = x.shape
    y = torch.empty((B, out_extent(H), out_extent(W), C), dtype=x.dtype,
                    device=x.device)
    return _launch(x, y)


def ceil_maxpool_3x3s2_sm(x):
    """Spatial-major x [H, W, B, C] -> [oh, ow, B, C]: the same kernel on
    the permuted views, no transpose."""
    if x.device.type == "cpu":
        return ceil_maxpool_3x3s2_plain(x.permute(2, 0, 1, 3)).permute(
            1, 2, 0, 3)
    H, W, B, C = x.shape
    y = torch.empty((out_extent(H), out_extent(W), B, C), dtype=x.dtype,
                    device=x.device)
    _launch(x.permute(2, 0, 1, 3), y.permute(2, 0, 1, 3))
    return y


ceil_maxpool_3x3s2_nhwc.launches = 0

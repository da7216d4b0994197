"""Winograd F(5x5, 3x3) transform matrices, the filter transform, and the
gate that routes the detector's 3x3 convs to the CUDA Winograd stack.

The port's own copy of ``insenticap_model_tpu/ops/winograd.py``'s
``cook_toom``, ``_AT5/_G5/_BT5`` and ``transform_filter`` (:68-123): the
matrices come from exact rational arithmetic (transposed Toom-Cook over
the points {0, 1, -1, 2, -2, 1/2} and infinity), then round once to f32;
the tests require them equal to the JAX package's, element for element.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

M5 = 5                  # output tile of F(5x5, 3x3)
T5 = M5 + 2             # input tile / transform size
MAX_TILES = 3           # spatial cap: at most 3x3 tiles, i.e. h, w <= 15


def cook_toom(m: int, r: int, points):
    """F(m, r) Winograd matrices (A^T [m,t], G [t,r], B^T [t,t]) by
    transposed Toom-Cook over t-1 finite points + infinity, in exact
    rational arithmetic: y = A^T [(G g) * (B^T d)] is the m-output valid
    correlation of d (length t) with g (length r)."""
    t = m + r - 1
    if len(points) != t - 1:
        raise ValueError(f"F({m},{r}) needs {t - 1} points, got {points}")
    a = [Fraction(x) for x in points]

    def vand(width):
        rows = [[p ** k for k in range(width)] for p in a]
        rows.append([Fraction(0)] * (width - 1) + [Fraction(1)])
        return rows

    full = vand(t)
    aug = [row[:] + [Fraction(int(i == j)) for j in range(t)]
           for i, row in enumerate(full)]
    for col in range(t):      # Gauss-Jordan inverse of the Vandermonde
        piv = next(i for i in range(col, t) if aug[i][col] != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        pv = aug[col][col]
        aug[col] = [x / pv for x in aug[col]]
        for i in range(t):
            if i != col and aug[i][col] != 0:
                f = aug[i][col]
                aug[i] = [x - f * y for x, y in zip(aug[i], aug[col])]
    vinv = [row[t:] for row in aug]
    tofl = lambda rows: np.array([[float(x) for x in rr] for rr in rows],  # noqa: E731
                                 dtype=np.float32)
    return tofl(vand(m)).T, tofl(vand(r)), tofl(vinv).T


_AT5, _G5, _BT5 = cook_toom(5, 3, [0, 1, -1, 2, -2, Fraction(1, 2)])


def transform_filter(w, g_mat=_G5):
    """w [3, 3, Cin, Cout] (HWIO) -> U [t, t, Cin, Cout] = G w G^T per
    channel pair, in f32."""
    g = torch.as_tensor(g_mat, dtype=torch.float32, device=w.device)
    u = torch.einsum("ur,rsio->usio", g, w.float())
    return torch.einsum("vs,usio->uvio", g, u)


def kernel_eligible(x_shape, w_shape, dtype, device) -> bool:
    """True when the CUDA Winograd stack serves a 3x3 SAME conv: a 3x3
    kernel, bf16 (the serving policy; f32 keeps the direct conv), a CUDA
    tensor, and the 14x14-class spatial cap (at most 3x3 output tiles of
    5x5, i.e. h, w <= 15 — the input and middle kernels keep a slab's
    h x w positions in shared memory). x_shape is [bs, h, w, C] (NHWC).

    Dropped from the JAX gate: batch % 8 and channels % 256, which were the
    TPU's (8, 128) block-tiling rules; the CUDA kernels mask a ragged
    channel tail and take unaligned inputs element by element, so any batch
    and channel count works."""
    _, h, wd = x_shape[0], x_shape[1], x_shape[2]
    kh, kw = w_shape[0], w_shape[1]
    return ((kh, kw) == (3, 3) and dtype == torch.bfloat16
            and torch.device(device).type == "cuda"
            and -(-h // M5) <= MAX_TILES and -(-wd // M5) <= MAX_TILES)

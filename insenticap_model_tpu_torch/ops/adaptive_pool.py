"""Adaptive average pooling with torch's window semantics, channels last.

Counterpart of ``insenticap_model_tpu/ops/adaptive_pool.py``: output cell
(i, j) averages the input window rows [floor(i*H/oh), ceil((i+1)*H/oh)) and
columns likewise. The encoder uses it for the 14x14 att grid of any conv-map
size (reference models/encoder.py:53); at the 448x448 bucket the map is
already 14x14 and the pool is the identity.

The JAX package sums through an integral image (``jnp.cumsum``) in the
input's dtype, which in bf16 loses whole units on the serving policy's
features (ROADMAP queue 3). Here the window mean is taken with f32
accumulation and rounded once to the input's dtype, so a bf16 result is
within one bf16 rounding of the f32 mean. The JAX package computes this
outside Pallas, so the library's ``F.adaptive_avg_pool2d`` (on the
channels-last NCHW view, no copy of the layout) carries it.
"""
from __future__ import annotations

import torch.nn.functional as F


def adaptive_avg_pool2d(x, out_hw):
    """x [..., H, W, C] -> [..., oh, ow, C] in x's dtype."""
    oh, ow = out_hw
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    x4 = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)      # NCHW view
    y = F.adaptive_avg_pool2d(x4.float(), (oh, ow))
    return y.permute(0, 2, 3, 1).to(x.dtype).reshape(*lead, oh, ow, C)

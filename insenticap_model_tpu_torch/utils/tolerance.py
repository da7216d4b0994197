"""Comparison of a kernel's bf16 output with its plain version."""
from __future__ import annotations

import torch


def bf16_ulp_error(got, want, floor_frac: float = 1e-3):
    """(max |got - want|, max |got - want| in bf16 ulps of want). The ulp
    is taken at no less than ``floor_frac`` of max|want|: where both sides
    sum in f32 in other orders and round once to bf16, they differ by at
    most one ulp, and near zero the summation order, not the rounding,
    sets the difference. Computed in f64 on the tensors' device."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).to(got.device).double()
    mag = torch.maximum(want.abs(), floor_frac * want.abs().max())
    err = (got - want).abs()
    ulps = err / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(err.max()), float(ulps.max())

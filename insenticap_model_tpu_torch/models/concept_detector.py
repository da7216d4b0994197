"""Multi-label concept detector, serving parts (reference
models/concept_detector.py:5-58).

Counterpart of ``insenticap_model_tpu/models/concept_detector.py``: a 3-layer
MLP (fc_feat_dim -> mid -> mid -> num_concepts) with a sigmoid output, and
``sample``, the top-k concepts by score. Dropout (between fc2's ReLU and
fc3) and the multi-label loss come with the training slice; serving runs
the deterministic forward.

``jax.lax.top_k`` ranks equal scores by the lower index first, and sigmoid
scores do tie: in f32 they saturate to exactly 1.0 once a logit passes
about 17. ``torch.topk`` promises no order among equals, so ``sample``
takes the first k of a stable descending sort, which keeps the lower index
first.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import nn
from ..utils.dtypes import resolve_device


def init_params(gen: torch.Generator, num_concepts: int, settings, *,
                device="cuda", dtype=torch.float32) -> Dict:
    """torch's default Linear initialisers, drawn from ``gen``."""
    kw = {"dtype": dtype, "device": resolve_device(device)}
    mid = settings.concept_mid_dim
    return {"fc1": nn.linear_init(gen, settings.fc_feat_dim, mid, **kw),
            "fc2": nn.linear_init(gen, mid, mid, **kw),
            "fc3": nn.linear_init(gen, mid, num_concepts, **kw)}


def forward(params, features):
    """features [bs, fc_feat_dim] -> sigmoid scores [bs, num_concepts]
    (reference :10-18, eval mode)."""
    with nn.exact_numerics():
        x = torch.relu(nn.linear(params["fc1"], features))
        x = torch.relu(nn.linear(params["fc2"], x))
        return torch.sigmoid(nn.linear(params["fc3"], x))


def sample(params, features, num: int):
    """Top-``num`` concepts by score, descending, the lower index first on
    a tie (reference :24-37). Returns (scores [bs, C], top_idx [bs, num]
    int64, top_scores [bs, num])."""
    out = forward(params, features)
    top_scores, top_idx = torch.sort(out, dim=-1, descending=True,
                                     stable=True)
    return out, top_idx[:, :num], top_scores[:, :num]

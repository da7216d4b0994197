"""Image sentiment detector, "full" variant: the serving part
(reference models/sentiment_detector_full.py:5-73).

Counterpart of ``insenticap_model_tpu/models/sentiment_detector_full.py``
(:42-126), selected by ``sentiment_detector.module_for`` when
``Settings.num_kernels_per_sentiment > 0``. The same 3x3 conv stack as the
standard detector (one ReLU after the stack) feeds a 1x1 conv with
``k = num_kernels_per_sentiment`` kernels per class (channel ``c*k + j``
belongs to class c). Two branches:

- detection: spatial max pool, then the mean over each class's k kernels
  -> ``det_out`` [bs, S];
- classification: softmax(det_out) weights the per-class mean maps into
  one spatial map; [mean(x), mean(x * map)] over space feeds one Linear
  -> ``cls_out`` [bs, S].

``sample`` thresholds softmax(cls_out) like the standard detector, and
``xent_loss`` / ``xent_nll_rows`` are the cross entropy on cls_out (the
detection branch carries no loss of its own in the reference, :71-73).
On a CUDA bf16 batch the conv stack runs through the Winograd kernels, as
the standard head's does; a training forward (dropout after the stack)
keeps the direct conv.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import nn
from ..utils.dtypes import resolve_device
from .sentiment_detector import conv_stack, nll_rows, threshold_labels


def init_params(gen: torch.Generator, num_sentiments: int, settings, *,
                device="cuda", dtype=torch.float32) -> Dict:
    k = settings.num_kernels_per_sentiment
    if k <= 0:
        raise ValueError("the full variant needs num_kernels_per_sentiment "
                         f"> 0, got {k}")
    kw = {"dtype": dtype, "device": resolve_device(device)}
    params: Dict = {"convs": []}
    in_ch = settings.fc_feat_dim
    for _ in range(settings.sentiment_convs_num):
        params["convs"].append(nn.conv2d_init(gen, in_ch, in_ch // 2, 3, 3,
                                              **kw))
        in_ch //= 2
    params["senti_conv"] = nn.conv2d_init(gen, in_ch, num_sentiments * k,
                                          1, 1, **kw)
    params["cls"] = nn.linear_init(gen, 2 * in_ch, num_sentiments, **kw)
    return params


def forward_full(params, features, *, use_kernels: bool = True,
                 dropout_p: float = 0.0,
                 gen: Optional[torch.Generator] = None,
                 deterministic: bool = True):
    """features [bs, H, W, C] -> (det_out [bs, S], cls_out [bs, S],
    spatial map [bs, H, W]). ``deterministic=False`` (dropout from
    ``gen``) keeps the kernels out (``conv_stack``)."""
    x, spatial_major = conv_stack(params, features, use_kernels=use_kernels,
                                  dropout_p=dropout_p, gen=gen,
                                  deterministic=deterministic)
    if spatial_major:   # not a hot path: one transpose back after the stack
        x = x.permute(2, 0, 1, 3)
    senti_maps = nn.conv2d(params["senti_conv"], x, padding="SAME")
    bs, h, w, sk = senti_maps.shape
    n_cls = params["cls"]["weight"].shape[0]
    k = sk // n_cls
    det_out = senti_maps.amax(dim=(1, 2)).reshape(bs, n_cls, k).mean(-1)
    class_maps = senti_maps.reshape(bs, h, w, n_cls, k).mean(-1)
    weights = torch.softmax(det_out, dim=-1)
    spatial = torch.einsum("bs,bhws->bhw", weights, class_maps)
    semantic = torch.cat([x.mean(dim=(1, 2)),
                          (x * spatial[..., None]).mean(dim=(1, 2))], dim=-1)
    cls_out = nn.linear(params["cls"], semantic)
    return det_out, cls_out, spatial


def forward(params, features, *, use_kernels: bool = True,
            dropout_p: float = 0.0, gen: Optional[torch.Generator] = None,
            deterministic: bool = True):
    """The standard detector's surface: (cls logits [bs, S], spatial
    [bs, H, W]); sample runs on the classification branch, the branch the
    reference's own ``sample`` thresholds (:59-61)."""
    _, cls_out, spatial = forward_full(params, features,
                                       use_kernels=use_kernels,
                                       dropout_p=dropout_p, gen=gen,
                                       deterministic=deterministic)
    return cls_out, spatial


def sample(params, features, senti_threshold: float, neu_idx: int, *,
           use_kernels: bool = True):
    """(labels [bs] int32, spatial [bs, H, W], scores [bs]); predictions
    below the threshold fall back to neutral (reference :56-63)."""
    logits, spatial = forward(params, features, use_kernels=use_kernels)
    labels, scores = threshold_labels(logits, senti_threshold, neu_idx)
    return labels, spatial, scores


def xent_loss(params, features, labels, *, dropout_p: float,
              gen: Optional[torch.Generator], deterministic: bool):
    """The training cross entropy on the classification logits (reference
    get_optim_criterion :71-73)."""
    logits, _ = forward(params, features, dropout_p=dropout_p, gen=gen,
                        deterministic=deterministic)
    return nll_rows(logits, labels).mean()


def xent_nll_rows(params, features, labels, *, use_kernels: bool = True):
    """Per-row cross entropy of the deterministic forward."""
    logits, _ = forward(params, features, use_kernels=use_kernels)
    return nll_rows(logits, labels)

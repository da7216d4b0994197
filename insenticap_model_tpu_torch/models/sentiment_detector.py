"""Image sentiment detector (reference models/sentiment_detector.py:5-64).

Counterpart of ``insenticap_model_tpu/models/sentiment_detector.py``: an FCN
head over the 14x14x2048 feature grid. ``sentiment_convs_num`` 3x3 convs
each halve the channels, with one dropout and ReLU after the whole stack
(the reference appends dropout+relu once, :11-18; the dropout only in a
training forward), then a 1x1 conv to one channel per sentiment, a global
mean pool and ``sentiment_fcs_num`` stacked Linear layers. ``forward``
returns the pre-softmax logits and the softmax-weighted 14x14 spatial
map; ``xent_loss`` and ``xent_nll_rows`` are the training and eval
cross entropy on the logits (JAX :129-146).

On a CUDA bf16 batch the 3x3 stack runs through the Winograd kernels
(``ops/winograd_kernels.py``) spatial-major ``[H, W, bs, C]``; f32, every
CPU tensor and ``deterministic=False`` keep the direct convolution.
``module_for`` picks this head or the "full" variant
(``sentiment_detector_full.py``) from ``Settings``.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

from .. import nn
from ..ops.winograd import kernel_eligible
from ..ops.winograd_kernels import conv3x3_stack_sm
from ..utils.dtypes import resolve_device


def module_for(settings):
    """The detector module ``settings`` selects: this standard head, or the
    "full" variant when ``num_kernels_per_sentiment > 0`` (the JAX
    package's ``sentiment_detector.module_for``, :29-40). Both expose
    ``init_params`` / ``forward`` / ``sample`` / ``xent_loss`` /
    ``xent_nll_rows``."""
    if getattr(settings, "num_kernels_per_sentiment", 0) > 0:
        from . import sentiment_detector_full
        return sentiment_detector_full
    return sys.modules[__name__]


def init_params(gen: torch.Generator, num_sentiments: int, settings, *,
                device="cuda", dtype=torch.float32) -> Dict:
    kw = {"dtype": dtype, "device": resolve_device(device)}
    params: Dict = {"convs": [], "fcs": []}
    in_ch = settings.fc_feat_dim
    for _ in range(settings.sentiment_convs_num):
        params["convs"].append(nn.conv2d_init(gen, in_ch, in_ch // 2, 3, 3,
                                              **kw))
        in_ch //= 2
    params["senti_conv"] = nn.conv2d_init(gen, in_ch, num_sentiments, 1, 1,
                                          **kw)
    for _ in range(settings.sentiment_fcs_num):
        params["fcs"].append(nn.linear_init(gen, num_sentiments,
                                            num_sentiments, **kw))
    return params


def conv_stack(params, features, *, use_kernels: bool = True,
               dropout_p: float = 0.0, gen: Optional[torch.Generator] = None,
               deterministic: bool = True):
    """The shared 3x3 conv stack, its dropout (a training forward only,
    the mask drawn from ``gen``) and its ReLU, for both detector heads.
    Returns (x, spatial_major): x is [H, W, bs, C] when the Winograd
    kernels ran (``spatial_major`` True), else [bs, H, W, C].
    ``use_kernels=False`` keeps the direct convolution on the card too
    (the reference run of the smoke check). ``deterministic=False`` (a
    training step, as in the JAX package, sentiment_detector.py:75-77)
    keeps the differentiable direct convolution: the kernels have no
    backward."""
    convs = params["convs"]
    fast = deterministic and use_kernels and bool(convs) and all(
        kernel_eligible(features.shape, cp["weight"].shape, features.dtype,
                        features.device) for cp in convs)
    if fast:
        # the whole stack in the Winograd domain: the activation between
        # the convs never reaches device memory (the stack is linear)
        x = conv3x3_stack_sm(features.permute(1, 2, 0, 3),
                             [(cp["weight"], cp.get("bias"))
                              for cp in convs], variant="f5")
    else:
        x = features
        for cp in convs:
            x = nn.conv2d(cp, x, padding="SAME")
    x = nn.dropout(gen, x, dropout_p, deterministic)
    return torch.relu(x), fast


def forward(params, features, *, use_kernels: bool = True,
            dropout_p: float = 0.0, gen: Optional[torch.Generator] = None,
            deterministic: bool = True):
    """features [bs, 14, 14, C] (NHWC). Returns (logits [bs, S], spatial
    map [bs, 14, 14]). ``deterministic=False`` (dropout from ``gen``)
    keeps the kernels out (``conv_stack``)."""
    x, fast = conv_stack(params, features, use_kernels=use_kernels,
                         dropout_p=dropout_p, gen=gen,
                         deterministic=deterministic)
    # a 1x1 conv mixes channels only, so it is correct on both layouts
    senti_maps = nn.conv2d(params["senti_conv"], x, padding="SAME")
    if fast:
        senti_maps = senti_maps.permute(2, 0, 1, 3)       # [bs, H, W, S]
    out = senti_maps.mean(dim=(1, 2))                      # [bs, S]
    for fp in params["fcs"]:
        out = nn.linear(fp, out)
    probs = torch.softmax(out, dim=-1)
    spatial = torch.einsum("bs,bhws->bhw", probs, senti_maps)
    return out, spatial


def sample(params, features, senti_threshold: float, neu_idx: int, *,
           use_kernels: bool = True):
    """Detect sentiment; predictions below ``senti_threshold`` fall back to
    neutral (reference :47-60). Returns (labels [bs] int32, spatial
    [bs, 14, 14], scores [bs])."""
    logits, spatial = forward(params, features, use_kernels=use_kernels)
    labels, scores = threshold_labels(logits, senti_threshold, neu_idx)
    return labels, spatial, scores


def threshold_labels(logits, senti_threshold: float, neu_idx: int):
    """softmax -> (argmax labels [bs] int32 with the ones below the
    threshold set to ``neu_idx``, max scores [bs])."""
    probs = torch.softmax(logits, dim=-1)
    scores, labels = probs.max(dim=-1)
    labels = torch.where(scores < senti_threshold,
                         torch.full_like(labels, neu_idx), labels)
    return labels.to(torch.int32), scores


def nll_rows(logits, labels):
    """Per-row cross entropy of ``logits`` [bs, S] at ``labels`` [bs]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def xent_loss(params, features, labels, *, dropout_p: float,
              gen: Optional[torch.Generator], deterministic: bool):
    """The training cross entropy on the logits (reference
    get_optim_criterion :62-64 and train_senti.py's forward)."""
    logits, _ = forward(params, features, dropout_p=dropout_p, gen=gen,
                        deterministic=deterministic)
    return nll_rows(logits, labels).mean()


def xent_nll_rows(params, features, labels, *, use_kernels: bool = True):
    """Per-row cross entropy of the deterministic forward (the masked eval
    sums' building block): on a CUDA bf16 batch, through the kernels."""
    logits, _ = forward(params, features, use_kernels=use_kernels)
    return nll_rows(logits, labels)

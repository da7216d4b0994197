"""Serving path: image-sentiment detection, then the batched beam decode.

Counterpart of ``insenticap_model_tpu/inference.py`` (:26-65, 96-137,
173-249), mirroring the reference ``Detector.sample`` (models/decoder.py:
182-192): the detector's label (threshold -> neutral fallback) conditions a
sentiment-aware beam search over the whole batch. PyTorch runs eagerly, so
the ``make_*`` factories return plain callables with the static
configuration bound; there is no compilation to mirror. The data-parallel
variants come with the multi-device slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .models import captioner as cap
from .models import sentiment_detector as senti_det
from .ops import beam

SENTI_THRESHOLD = 0.7  # reference decoder.py:41


class ServingParams(NamedTuple):
    captioner: dict
    senti_detector: dict


def detect_and_decode(params: ServingParams, fc, att, sentis, *, settings,
                      ids: cap.TokenIds, beam_size: int = 3,
                      max_seq_len: int = 16,
                      senti_threshold: float = SENTI_THRESHOLD,
                      return_weights: bool = False,
                      use_kernels: bool = True):
    """Full serving step for a batch of images on the tensors' device.

    fc [bs, Ff], att [bs, 14, 14, Fa], sentis [bs, M] sentiment-word ids.
    Returns (seqs [bs, beam, T] int32, scores [bs, beam] descending,
    senti_labels [bs] int32), plus the weights dict with
    ``return_weights``. ``use_kernels=False`` runs the plain PyTorch
    versions on the card too (the CPU always runs them)."""
    senti_labels, _, _ = senti_det.module_for(settings).sample(
        params.senti_detector, att, senti_threshold, ids.neutral,
        use_kernels=use_kernels)
    ctx = cap.build_visual_context(params.captioner, fc, att,
                                   senti_words=sentis,
                                   senti_labels=senti_labels,
                                   pad_id=ids.pad)
    out = beam.beam_search_batched(
        params.captioner, ctx, settings=settings, ids=ids,
        beam_size=beam_size, max_seq_len=max_seq_len, mode="rl",
        return_weights=return_weights, use_kernels=use_kernels)
    return (*out[:2], senti_labels, *out[2:])


def decode_xe(params_captioner, fc, att, *, settings, ids: cap.TokenIds,
              beam_size: int = 3, max_seq_len: int = 16,
              use_kernels: bool = True):
    """XE-stage beam decode: no sentiment words and no sentiment-label
    embedding (reference train_xe.py:221-229, captioner.py:375-376).
    use_kernels=False runs the plain cell and tail (``beam_search_batched``)."""
    ctx = cap.build_visual_context(params_captioner, fc, att,
                                   pad_id=ids.pad)
    return beam.beam_search_batched(
        params_captioner, ctx, settings=settings, ids=ids,
        beam_size=beam_size, max_seq_len=max_seq_len, mode="xe",
        use_kernels=use_kernels)


def decode_greedy(params_captioner, fc, att, sentis, senti_labels, *,
                  settings, ids: cap.TokenIds, max_seq_len: int = 16):
    """Greedy decode with sentiment conditioning: ``forward_rl`` with
    ``sample_max``, in eval mode (reference captioner.py:290-349, greedy
    branch). Returns (seqs [bs, T] int32, masks [bs, T])."""
    seq, _, masks, _ = cap.forward_rl(
        params_captioner, fc, att,
        torch.zeros((fc.shape[0], 1), dtype=torch.int32, device=fc.device),
        sentis, senti_labels, settings=settings, ids=ids,
        max_seq_len=max_seq_len, sample_max=True, deterministic=True)
    return seq, masks


def sweep_sentiments(params_captioner, fc, att, sentis_by_label, *,
                     settings, ids: cap.TokenIds, num_labels: int = 3,
                     beam_size: int = 3, max_seq_len: int = 16):
    """Decode every image under every sentiment label (the paper's
    controllable-sentiment sweep). sentis_by_label: [num_labels, bs, M]
    sentiment-word ids per label. Returns (seqs [num_labels, bs, beam, T],
    scores [num_labels, bs, beam]).

    The label axis folds into the batch (rows label-major, as the JAX
    package folds it), so the sweep is one decode at num_labels times the
    rows; each row decodes independently, so the outputs equal the
    per-label decodes."""
    bs = fc.shape[0]
    fc_flat = fc.repeat(num_labels, 1)
    att_flat = att.repeat(num_labels, *([1] * (att.dim() - 1)))
    sentis_flat = sentis_by_label.reshape(num_labels * bs,
                                          *sentis_by_label.shape[2:])
    labels_flat = torch.arange(num_labels, dtype=torch.int32,
                               device=fc.device).repeat_interleave(bs)
    ctx = cap.build_visual_context(params_captioner, fc_flat, att_flat,
                                   senti_words=sentis_flat,
                                   senti_labels=labels_flat, pad_id=ids.pad)
    seqs, scores = beam.beam_search_batched(
        params_captioner, ctx, settings=settings, ids=ids,
        beam_size=beam_size, max_seq_len=max_seq_len, mode="rl")
    return (seqs.reshape(num_labels, bs, *seqs.shape[1:]),
            scores.reshape(num_labels, bs, *scores.shape[1:]))


def make_serving_fn(settings, ids: cap.TokenIds, beam_size: int = 3,
                    max_seq_len: int = 16, return_weights: bool = False):
    """detect_and_decode with the static configuration bound."""
    def fn(params: ServingParams, fc, att, sentis):
        return detect_and_decode(params, fc, att, sentis, settings=settings,
                                 ids=ids, beam_size=beam_size,
                                 max_seq_len=max_seq_len,
                                 return_weights=return_weights)
    return fn


def make_detect_fn(senti_threshold: float = SENTI_THRESHOLD,
                   neutral: int = 2, settings=None):
    """Image-sentiment label detection: fn(params, att) -> labels [bs].
    ``settings`` selects the detector variant
    (``sentiment_detector.module_for``); None is the standard head."""
    sd = senti_det.module_for(settings)

    def fn(params, att):
        return sd.sample(params, att, senti_threshold, neutral)[0]
    return fn


def make_forced_serving_fn(settings, ids: cap.TokenIds, beam_size: int = 3,
                           max_seq_len: int = 16,
                           return_weights: bool = False):
    """Sentiment-forced beam decode: like detect_and_decode, but the label
    comes from the caller (the paper's controllable-sentiment mode).
    fn(cap_params, fc, att, sentis, senti_labels) -> (seqs, scores)."""
    def fn(cap_params, fc, att, sentis, senti_labels):
        ctx = cap.build_visual_context(cap_params, fc, att,
                                       senti_words=sentis,
                                       senti_labels=senti_labels,
                                       pad_id=ids.pad)
        return beam.beam_search_batched(
            cap_params, ctx, settings=settings, ids=ids,
            beam_size=beam_size, max_seq_len=max_seq_len, mode="rl",
            return_weights=return_weights)
    return fn

"""Dynamic-batching serving: concurrent caption requests ride the batched
beam search.

Counterpart of ``insenticap_model_tpu/serving_daemon.py``'s single-device
``DynamicBatcher`` (:83-334):

* requests (features, sentiment-word ids, an auto or forced label) queue
  up and one dispatch thread coalesces them into batches;
* a batch is padded up a fixed bucket ladder by repeating a live row; the
  batched beam search treats rows independently, so padding has no effect
  on the live rows;
* sentiment is resolved row-wise: the detector runs on the whole batch
  when any row asks for it, forced rows override the detected label on
  the device, and one forced-label decode serves the mixed batch.

``make_batcher_from_checkpoint`` builds one from a JAX-written RL
checkpoint. The encode stage, ``EncodeBatcher`` (``serving/encode.py``),
and its ladder are re-exported here, as the JAX module does. The mesh and
multi-host branches come in later slices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import inference
from .config import Settings
from .serving.batching import (AUTO, DEFAULT_BUCKETS,   # noqa: F401
                               Saturated, _BatcherBase, _RequestBase,
                               default_buckets, default_encode_buckets,
                               prometheus_metrics)
from .serving.encode import EncodeBatcher  # noqa: F401 (re-export)
from .utils.dtypes import cast_bf16, resolve_device, to_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Request(_RequestBase):
    __slots__ = ("fc", "att", "sentis", "forced_label")

    def __init__(self, fc, att, sentis, forced_label):
        super().__init__()
        self.fc = fc
        self.att = att
        self.sentis = sentis
        self.forced_label = forced_label


class DynamicBatcher(_BatcherBase):
    """Coalesce feature-level caption requests into bucket-sized batches.

    cap_params / senti_params: the port's captioner and sentiment-detector
    parameters (any device; they are moved to ``device`` once).
    bucket_sizes: ascending batch shapes; the largest is the dispatch cap.
    max_wait_s: how long the oldest queued request may wait for co-riders.
    compute_dtype: "bfloat16" casts the parameters once here and the
    features on the host per batch (the serving policy); "float32" keeps
    f32. device: "cuda" by default, refused when CUDA is absent; "cpu"
    runs the plain PyTorch versions.
    """

    def __init__(self, cap_params, senti_params, *, settings, ids,
                 beam_size: int = 3, max_seq_len: int = 16,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 max_wait_s: float = 0.005,
                 senti_threshold: float = inference.SENTI_THRESHOLD,
                 num_sentiments: int = 10, att_hw: Tuple[int, int] = (14, 14),
                 num_cats: int = 3, compute_dtype: str = "float32",
                 device="cuda", max_queue: int = 4096):
        if bucket_sizes is None:
            bucket_sizes = default_buckets()
        if list(bucket_sizes) != sorted(set(bucket_sizes)):
            raise ValueError(f"bucket_sizes must be ascending/unique: "
                             f"{bucket_sizes}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self._device = resolve_device(device)
        self._ids = ids
        self._feat_dtype = _DTYPES[compute_dtype]
        cap_params = to_device(cap_params, self._device)
        senti_params = to_device(senti_params, self._device)
        if compute_dtype == "bfloat16":
            cap_params = cast_bf16(cap_params)
            senti_params = cast_bf16(senti_params)
        self._cap_params = cap_params
        self._senti_params = senti_params
        # per-row feature shapes are fixed at construction and enforced
        # in submit()
        self._fc_shape = (settings.fc_feat_dim,)
        self._att_shape = tuple(att_hw) + (settings.att_feat_dim,)
        self._m = int(num_sentiments)
        self._num_cats = int(num_cats)
        self._buckets = tuple(int(b) for b in bucket_sizes)
        self._detect = inference.make_detect_fn(senti_threshold,
                                                ids.neutral, settings)
        self._serve = inference.make_forced_serving_fn(
            settings, ids, beam_size, max_seq_len)
        super().__init__(cap_n=self._buckets[-1], max_wait_s=max_wait_s,
                         max_queue=max_queue, bucket_keys=self._buckets,
                         name="isc-serve")

    # -- public API -------------------------------------------------------

    def submit(self, fc, att, sentis, forced_label: int = AUTO,
               timeout: Optional[float] = None,
               enqueue_timeout: Optional[float] = None):
        """Caption one image; blocks until its batch completes.

        fc [Ff] float, att [14, 14, Fa] float, sentis [M] int ranked
        sentiment-word ids (PAD-padded), forced_label AUTO or a sentiment
        index. Returns (seqs [beam, T] int32 desc-sorted, scores [beam]
        f32, label int). enqueue_timeout: None blocks while the queue is
        full; a number raises Saturated past the deadline."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        fc = np.asarray(fc, np.float32)
        att = np.asarray(att, np.float32)
        sentis = np.asarray(sentis, np.int64)
        if (fc.shape != self._fc_shape or att.shape != self._att_shape
                or sentis.shape != (self._m,)):
            raise ValueError(
                f"request shapes {fc.shape}/{att.shape}/{sentis.shape} != "
                f"expected {self._fc_shape}/{self._att_shape}/({self._m},)")
        if forced_label != AUTO and not 0 <= forced_label < self._num_cats:
            raise ValueError(f"forced_label {forced_label} not in "
                             f"[0, {self._num_cats}) or AUTO")
        r = _Request(fc, att, sentis, int(forced_label))
        return self._enqueue_and_wait(r, timeout, enqueue_timeout)

    # -- dispatch/finish --------------------------------------------------

    def _run(self, fc, att, sentis, forced, run_detect: bool):
        """The device work of one batch: labels merge on the device."""
        if run_detect:
            detected = self._detect(self._senti_params, att)
            labels = torch.where(forced == AUTO, detected, forced)
        else:
            labels = forced
        seqs, scores = self._serve(self._cap_params, fc, att, sentis,
                                   labels)
        return seqs, scores, labels

    def _dispatch(self, batch: List[_Request]) -> None:
        """Stage 1: stack, stage and launch; the completion thread copies
        the results back while this thread collects the next batch."""
        n = len(batch)
        bucket = next(b for b in self._buckets if b >= n)
        pad = bucket - n
        rows = batch + [batch[-1]] * pad      # repeat a live row
        forced_h = np.asarray([r.forced_label for r in rows], np.int32)
        out = self._run(
            self._stage(np.stack([r.fc for r in rows]), self._feat_dtype),
            self._stage(np.stack([r.att for r in rows]), self._feat_dtype),
            self._stage(np.stack([r.sentis for r in rows])),
            self._stage(forced_h), bool((forced_h == AUTO).any()))
        self._fq.put((batch, bucket, pad) + out)

    def _finish(self, item) -> None:
        """Stage 2: copy device outputs back, fan results out."""
        batch, bucket, pad, seqs, scores, labels = item
        try:
            seqs = seqs.cpu().numpy()
            scores = scores.float().cpu().numpy()
            labels = labels.cpu().numpy()
        except BaseException as e:   # runtime device errors land here
            self._fail_batch(batch, e)
            return
        self._record_batch(batch, bucket, pad)
        for i, r in enumerate(batch):
            r.result = (seqs[i], scores[i], int(labels[i]))
            r.done.set()

    # -- warmup -----------------------------------------------------------

    def warm(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run the detector and the decode once per bucket (default: all)
        on zero inputs, so the first real requests find the kernels built
        and the libraries initialised. Call before accepting traffic."""
        for b in (buckets or self._buckets):
            seqs, _, _ = self._run(
                self._stage(np.zeros((b,) + self._fc_shape, np.float32),
                            self._feat_dtype),
                self._stage(np.zeros((b,) + self._att_shape, np.float32),
                            self._feat_dtype),
                self._stage(np.full((b, self._m), self._ids.pad, np.int64)),
                self._stage(np.zeros((b,), np.int32)), True)
            seqs.cpu()


def make_batcher_from_checkpoint(rl_model: str, *, beam_size: int = 3,
                                 max_seq_len: int = 16,
                                 bucket_sizes=None,
                                 max_wait_s: float = 0.005,
                                 compute_dtype: str = "float32",
                                 num_sentiments: int = 10, device="cuda"):
    """A DynamicBatcher (plus vocab, categories and settings) from a
    composite RL checkpoint written by the JAX package (its
    ``serving_daemon.make_batcher_from_checkpoint``, :337-369). The
    checkpoint must carry ``idx2word`` and ``sentiment_categories`` in its
    metadata and both the captioner and the detector in its tree."""
    from .training import checkpoint as ckpt
    from .vocab import Vocab, token_ids

    device = resolve_device(device)
    meta = ckpt.load_metadata(rl_model)
    if meta.get("idx2word") is None:
        raise ckpt.CheckpointError(f"{rl_model}: no idx2word in metadata")
    params, meta = ckpt.load(rl_model, device=device)
    for part in ("captioner", "senti_detector"):
        if part not in params:
            raise ckpt.CheckpointError(f"{rl_model}: no {part} in the tree")
    settings = Settings.from_dict(meta["settings"])
    vocab = Vocab(meta["idx2word"])
    cats = meta["sentiment_categories"]
    b = DynamicBatcher(params["captioner"], params["senti_detector"],
                       settings=settings, ids=token_ids(vocab, cats),
                       beam_size=beam_size, max_seq_len=max_seq_len,
                       bucket_sizes=bucket_sizes, max_wait_s=max_wait_s,
                       num_cats=len(cats), compute_dtype=compute_dtype,
                       num_sentiments=num_sentiments, device=device)
    return b, vocab, cats, settings

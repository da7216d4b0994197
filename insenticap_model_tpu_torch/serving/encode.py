"""Encode stage: batched image -> features + concept top-k.

Counterpart of ``insenticap_model_tpu/serving/encode.py``'s single-device
``EncodeBatcher``, the front half of the two-stage serving pipeline: its
results (fc, att, concept ids) feed the decode stage's ``DynamicBatcher``
through ``cli.common.senti_word_ids``. The mesh branch comes with the
multi-device slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.dtypes import resolve_device
from .batching import DEFAULT_ENCODE_BUCKETS, _BatcherBase, _RequestBase

_FC_KEY = "fc"   # stats bucket label of the feature-mode concept-only rows


def make_cpt_apply(cpt_params, num_concepts: int):
    """fc [B, Ff] -> the top ``num_concepts`` concept ids [B, K], scored in
    f32 whatever the encoder's dtype (the ranking is the product; the JAX
    package's serve.py does the same)."""
    from ..models import concept_detector

    def apply(fc):
        return concept_detector.sample(cpt_params, fc.float(),
                                       num_concepts)[1]
    return apply


class _EncodeRequest(_RequestBase):
    __slots__ = ("img", "fc", "key")

    def __init__(self, img, fc, key):
        super().__init__()
        self.img = img       # uint8 [H, W, 3] (image mode) or None
        self.fc = fc         # float32 [Ff] (feature mode) or None
        self.key = key       # "{H}x{W}" or _FC_KEY: the grouping key


class EncodeBatcher(_BatcherBase):
    """Coalesce image-encode (+ concept top-k) requests into batched
    device calls, so that the encoder does not run at bs=1 under load.

    Requests group by resize bucket (only same-shape images stack; callers
    resize to ``preprocessing.DEFAULT_BUCKET_SHAPES`` first), pad up the
    ``batch_buckets`` ladder by repeating a live row, and run one
    ``enc_apply`` per shape group; the concept top-k runs on the same padded
    batch. Feature-mode requests (fc known, top-k only) form their own
    group on the same ladder.

    enc_apply: imgs uint8 [B, H, W, 3] tensor on ``device`` -> (fc [B, Ff],
        att [B, a, a, Fa]), with the encoder's params bound (``lambda x:
        encoder.forward_raw_batch(params, x)``); or None (a feature-only
        stage: image submissions raise).
    cpt_apply: fc [B, Ff] tensor -> top [B, K] concept ids
        (``make_cpt_apply``).
    shape_buckets: the resize ladder; images must arrive at one of them.
    batch_buckets: ascending batch ladder shared by every group.
    device: "cuda" by default, refused when CUDA is absent; "cpu" runs the
        plain PyTorch versions.
    Results come back as f32 numpy (fc, att) and integer numpy (top).
    """

    def __init__(self, enc_apply: Optional[Callable], cpt_apply: Callable,
                 *, fc_dim: int, shape_buckets: Sequence[Tuple[int, int]],
                 batch_buckets: Sequence[int] = DEFAULT_ENCODE_BUCKETS,
                 max_wait_s: float = 0.005, max_queue: int = 1024,
                 device="cuda"):
        if list(batch_buckets) != sorted(set(batch_buckets)):
            raise ValueError(f"batch_buckets must be ascending/unique: "
                             f"{batch_buckets}")
        self._device = resolve_device(device)
        self._enc_apply = enc_apply
        self._cpt_apply = cpt_apply
        self._fc_dim = int(fc_dim)
        self._shapes = tuple((int(h), int(w)) for h, w in shape_buckets)
        self._batch_buckets = tuple(int(b) for b in batch_buckets)
        keys = [f"{h}x{w}" for h, w in self._shapes] + [_FC_KEY]
        super().__init__(cap_n=self._batch_buckets[-1],
                         max_wait_s=max_wait_s, max_queue=max_queue,
                         bucket_keys=keys, name="isc-encode")

    # -- public API -------------------------------------------------------

    def submit_image(self, img_u8, timeout: Optional[float] = None,
                     enqueue_timeout: Optional[float] = None):
        """Encode one bucket-shaped uint8 RGB image; blocks until its batch
        completes. Returns (fc [Ff] f32, att [a, a, Fa] f32, top [K]
        concept ids)."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        if self._enc_apply is None:
            raise ValueError("image mode needs an encoder")
        img_u8 = np.asarray(img_u8)
        if (img_u8.dtype != np.uint8 or img_u8.ndim != 3
                or tuple(img_u8.shape[:2]) not in self._shapes
                or img_u8.shape[2] != 3):
            raise ValueError(
                f"image shape {img_u8.shape}/{img_u8.dtype} is not a uint8 "
                f"RGB resize bucket {self._shapes}: resize on the host "
                f"first")
        h, w = img_u8.shape[:2]
        r = _EncodeRequest(img_u8, None, f"{h}x{w}")
        return self._enqueue_and_wait(r, timeout, enqueue_timeout)

    def submit_fc(self, fc, timeout: Optional[float] = None,
                  enqueue_timeout: Optional[float] = None):
        """Concept top-k for an fc row already extracted. Returns top [K]
        concept ids."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        fc = np.asarray(fc, np.float32)
        if fc.shape != (self._fc_dim,):
            raise ValueError(f"fc shape {fc.shape} != ({self._fc_dim},)")
        r = _EncodeRequest(None, fc, _FC_KEY)
        return self._enqueue_and_wait(r, timeout, enqueue_timeout)

    # -- dispatch/finish --------------------------------------------------

    def _dispatch(self, batch: List[_EncodeRequest]) -> None:
        """Group rows by shape key, pad each group up the batch ladder and
        launch one encoder (+ top-k) call per group; all groups of one
        collect go to the completion thread as one item."""
        groups: Dict[str, List[_EncodeRequest]] = {}
        for r in batch:
            groups.setdefault(r.key, []).append(r)
        launched = []
        for key, rs in groups.items():
            n = len(rs)
            bucket = next(b for b in self._batch_buckets if b >= n)
            pad = bucket - n
            if key == _FC_KEY:
                fcs = np.stack([r.fc for r in rs] + [rs[-1].fc] * pad)
                top = self._cpt_apply(self._stage(fcs))
                launched.append((rs, key, pad, None, None, top))
            else:
                imgs = np.stack([r.img for r in rs] + [rs[-1].img] * pad)
                fc, att = self._enc_apply(self._stage(imgs))
                top = self._cpt_apply(fc)
                launched.append((rs, key, pad, fc, att, top))
        self._fq.put(launched)

    def _finish(self, launched) -> None:
        for rs, key, pad, fc, att, top in launched:
            try:
                top = top.cpu().numpy()
                if fc is not None:
                    fc = fc.float().cpu().numpy()
                    att = att.float().cpu().numpy()
            except BaseException as e:   # runtime device errors land here
                self._fail_batch(rs, e)
                continue
            self._record_batch(rs, key, pad)
            for i, r in enumerate(rs):
                r.result = top[i] if fc is None \
                    else (fc[i], att[i], top[i])
                r.done.set()

    # -- warmup -----------------------------------------------------------

    def warm(self, batch_buckets: Optional[Sequence[int]] = None) -> None:
        """Run every (shape, batch) encoder call and the feature-mode
        top-k ladder once on zero inputs, so that the first requests find
        the kernels built and the libraries initialised."""
        for b in (batch_buckets or self._batch_buckets):
            if self._enc_apply is not None:
                for h, w in self._shapes:
                    fc, _ = self._enc_apply(
                        self._stage(np.zeros((b, h, w, 3), np.uint8)))
                    self._cpt_apply(fc).cpu()
            self._cpt_apply(
                self._stage(np.zeros((b, self._fc_dim), np.float32))).cpu()

"""Dynamic-batching core: the stage-agnostic two-stage batcher.

Counterpart of ``insenticap_model_tpu/serving/batching.py``: the bucket
ladders and their rounding to a mesh, ``_BatcherBase`` (producer submit
with backpressure, the dispatch thread, the completion thread, stats with
per-bucket latency percentiles, the stall watchdog, close/drain) and
``prometheus_metrics``.

Thread model (per batcher): any number of producer threads call
``submit``; a dispatch thread stacks, stages and launches each batch on the
device, and a completion thread copies results back and fans them out, at
most two batches in flight. ``close()`` drains and joins both threads.
With a ``parallel.mesh.DeviceMesh`` a batch's rows split into one equal
block a device (``_stage``), so every bucket is a multiple of the mesh's
size; under a ``ProcessMesh`` a multiple of the devices of every process
(its ``size``), so that each process's stripe splits evenly over its own.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import Shards

AUTO = -1  # submit(forced_label=AUTO) -> use the image sentiment detector

DEFAULT_BUCKETS = (1, 8, 32, 128, 384)

# Batch ladder of the encode stage: a smaller cap than the decode ladder,
# since the encoder is compute-heavy per row.
DEFAULT_ENCODE_BUCKETS = (1, 4, 16, 32)

# per-bucket request-latency ring size for stats() percentiles
_LAT_WINDOW = 1024


def _round_ladder(buckets: Sequence[int], mesh) -> Tuple[int, ...]:
    """A bucket ladder rounded up to multiples of the mesh's size (each
    device takes an equal block; a ``ProcessMesh``'s size counts the
    devices of every process), deduped: (1,8,32,128,384) on 8 devices is
    (8,32,128,384). The ladder as it is without a mesh."""
    if mesh is None:
        return tuple(buckets)
    n = mesh.size
    return tuple(sorted({-(-b // n) * n for b in buckets}))


def _require_mesh_multiples(buckets: Sequence[int], mesh, hint: str):
    """An explicit ladder must already be multiples of the mesh's size:
    a silently rounded explicit value would serve other shapes than the
    ones asked for."""
    n = mesh.size
    bad = [b for b in buckets if b % n]
    if bad:
        raise ValueError(
            f"bucket sizes {bad} are not multiples of the mesh data "
            f"axis ({n}) — use {hint} or pass multiples")


def default_buckets(mesh=None) -> Tuple[int, ...]:
    """The default decode-stage bucket ladder (rounded to the mesh)."""
    return _round_ladder(DEFAULT_BUCKETS, mesh)


def default_encode_buckets(mesh=None) -> Tuple[int, ...]:
    """The default encode-stage batch ladder (rounded to the mesh)."""
    return _round_ladder(DEFAULT_ENCODE_BUCKETS, mesh)


def to_host(x) -> np.ndarray:
    """A device result as a host array, bfloat16 widened to float32 on the
    device first: a tensor copied back, or the blocks of ``Shards`` copied
    back and joined in row order; a host array (what the lockstep path of
    a mesh over processes returns) as it is."""
    if isinstance(x, np.ndarray):
        return x

    def one(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(x, Shards):
        return np.concatenate([one(b) for b in x])
    return one(x)


class Saturated(RuntimeError):
    """Request queue full past enqueue_timeout — shed load upstream
    (an HTTP layer maps this to 503)."""


class _RequestBase:
    __slots__ = ("done", "result", "error", "t0")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = 0.0   # set at enqueue; stats() latency = done - t0


class _BatcherBase:
    """Shared two-stage (dispatch + completion) batching machinery.

    Subclasses set ``self._device`` (and ``self._mesh``, a ``DeviceMesh``
    or None) before ``super().__init__`` and implement ``_dispatch(batch)``
    (stack/stage/launch, then ``self._fq.put(item)``) and ``_finish(item)``
    (copy back, record stats via ``_record_batch``, fan out)."""

    def __init__(self, *, cap_n: int, max_wait_s: float, max_queue: int,
                 bucket_keys: Sequence, name: str):
        self._cap_n = int(cap_n)
        self._max_wait_s = float(max_wait_s)
        self._mesh = getattr(self, "_mesh", None)
        # health watchdog state: monotonic start of the in-progress
        # dispatch/finish step, None when idle (see stalled_for)
        self._dispatch_started: Optional[float] = None
        self._finish_started: Optional[float] = None
        self._q: "queue.Queue[Optional[_RequestBase]]" = \
            queue.Queue(max_queue)
        # dispatched-but-unfinished batches: at most 2 in flight
        self._fq: "queue.Queue" = queue.Queue(2)
        self._closed = False
        # serializes the closed-check+enqueue against close()'s
        # closed-set+sentinel, so no request lands behind the sentinel;
        # saturated producers wait on the Condition, which the dispatch
        # thread notifies as it drains the queue
        self._submit_lock = threading.Lock()
        self._space = threading.Condition(self._submit_lock)
        self._stats = {"requests": 0, "batches": 0,
                       "by_bucket": {k: 0 for k in bucket_keys},
                       "padded_rows": 0,
                       "failed_requests": 0, "failed_batches": 0}
        self._lat: Dict = {k: collections.deque(maxlen=_LAT_WINDOW)
                           for k in bucket_keys}
        self._stats_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{name}-batcher")
        self._finisher = threading.Thread(target=self._finish_loop,
                                          daemon=True,
                                          name=f"{name}-finisher")
        self._worker.start()
        self._finisher.start()

    # -- producer side ------------------------------------------------------

    def _enqueue_and_wait(self, r: _RequestBase,
                          timeout: Optional[float],
                          enqueue_timeout: Optional[float]):
        """Shared submit tail: enqueue (blocking while the queue is full),
        wait for completion, deliver the result or raise."""
        # t0 stamps submit time, before any wait for queue space, so the
        # percentiles include saturation queueing delay
        r.t0 = time.monotonic()
        deadline = None if enqueue_timeout is None \
            else r.t0 + enqueue_timeout
        with self._space:
            while True:
                if self._closed:
                    raise RuntimeError("batcher is closed")
                try:
                    self._q.put_nowait(r)
                    break
                except queue.Full:
                    pass
                if deadline is None:
                    self._space.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._space.wait(remaining):
                        raise Saturated(
                            f"request queue full ({self._q.maxsize}) past "
                            f"enqueue_timeout={enqueue_timeout}s")
        if not r.done.wait(timeout):
            raise TimeoutError("serving request timed out")
        if r.error is not None:
            raise r.error
        return r.result

    def stats(self) -> Dict:
        with self._stats_lock:
            out = dict(self._stats)
            out["by_bucket"] = dict(self._stats["by_bucket"])
            lat = {}
            for k, ring in self._lat.items():
                if not ring:
                    continue
                xs = np.sort(np.asarray(ring))
                lat[k] = {
                    "n": int(xs.size),
                    "p50_ms": round(float(np.percentile(xs, 50)) * 1e3, 3),
                    "p99_ms": round(float(np.percentile(xs, 99)) * 1e3, 3),
                }
            out["latency_by_bucket"] = lat
        return out

    def close(self) -> None:
        """Drain queued requests, stop both stage threads."""
        with self._space:
            if self._closed:
                return
            self._closed = True
            self._space.notify_all()   # wake saturated producers -> closed
        # sentinel outside the lock: a full queue would otherwise block
        # close() while producers can no longer free space
        self._q.put(None)              # after any queued work
        self._worker.join()            # dispatch forwards sentinel on exit
        self._finisher.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- dispatch thread ----------------------------------------------------

    def _collect(self) -> Optional[List[_RequestBase]]:
        """Block for the first request, then coalesce co-riders until the
        batch cap fills or the oldest request has waited max_wait_s."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self._max_wait_s
        while len(batch) < self._cap_n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is None:          # close(): serve what we have, then stop
                self._q.put(None)
                break
            batch.append(r)
        with self._space:          # queue space was freed
            self._space.notify_all()
        return batch

    def _stage(self, x: np.ndarray, dtype: Optional[torch.dtype] = None):
        """Host array -> device tensor, or with a mesh ``Shards``: each
        device's block of the rows shipped straight to it. A dtype cast
        happens on the host first (bf16 halves the bytes shipped). The
        dispatch and ``warm()`` both stage through here."""
        t = torch.as_tensor(x)
        if dtype is not None:
            t = t.to(dtype)
        if self._mesh is not None:
            return self._mesh.shard_batch(t)
        return t.to(self._device)

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                self._fq.put(None)            # forward shutdown downstream
                return
            self._dispatch_started = time.monotonic()
            try:
                self._dispatch(batch)
            except BaseException as e:  # deliver, don't kill the thread
                self._fail_batch(batch, e)
            finally:
                self._dispatch_started = None

    def _finish_loop(self) -> None:
        while True:
            item = self._fq.get()
            if item is None:
                return
            self._finish_started = time.monotonic()
            try:
                self._finish(item)
            finally:
                self._finish_started = None

    def stalled_for(self) -> float:
        """Age in seconds of the oldest in-progress dispatch/finish step,
        0.0 when both threads are idle: a wedged device pins one of them."""
        now = time.monotonic()
        ages = [now - t for t in (self._dispatch_started,
                                  self._finish_started) if t is not None]
        return max(ages, default=0.0)

    def healthy(self, max_stall_s: float) -> bool:
        return self.stalled_for() < max_stall_s

    # -- bookkeeping shared by subclasses ------------------------------------

    def _fail_batch(self, batch: List[_RequestBase],
                    e: BaseException) -> None:
        """Failed traffic still shows in stats()."""
        with self._stats_lock:
            self._stats["failed_requests"] += len(batch)
            self._stats["failed_batches"] += 1
        for r in batch:
            r.error = e
            r.done.set()

    def _record_batch(self, batch: List[_RequestBase], bucket_key,
                      pad: int) -> None:
        """Stats before done-events: a caller returning from submit() must
        already see its request counted."""
        now = time.monotonic()
        with self._stats_lock:
            self._stats["requests"] += len(batch)
            self._stats["batches"] += 1
            self._stats["by_bucket"][bucket_key] += 1
            self._stats["padded_rows"] += pad
            self._lat[bucket_key].extend(now - r.t0 for r in batch)

    # -- subclass hooks -------------------------------------------------------

    def _dispatch(self, batch: List[_RequestBase]) -> None:
        raise NotImplementedError

    def _finish(self, item) -> None:
        raise NotImplementedError


def prometheus_metrics(stages: Dict[str, Dict],
                       stalled: Optional[Dict[str, float]] = None) -> str:
    """Render batcher ``stats()`` dicts as Prometheus text exposition
    (version 0.0.4). ``stages`` maps a stage label to that batcher's
    stats(); ``stalled`` optionally maps the same labels to
    ``stalled_for()`` seconds."""
    def esc(v) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    counters = ("requests", "batches", "padded_rows",
                "failed_requests", "failed_batches")
    lines = []
    for name in counters:
        lines.append(f"# TYPE isc_{name}_total counter")
        for stage, s in stages.items():
            if name in s:
                lines.append(
                    f'isc_{name}_total{{stage="{esc(stage)}"}} {s[name]}')
    lines.append("# TYPE isc_batches_by_bucket_total counter")
    for stage, s in stages.items():
        for bucket, n in sorted(s.get("by_bucket", {}).items(),
                                key=lambda kv: str(kv[0])):
            lines.append(f'isc_batches_by_bucket_total{{stage='
                         f'"{esc(stage)}",bucket="{esc(bucket)}"}} {n}')
    lines.append("# TYPE isc_request_latency_ms summary")
    for stage, s in stages.items():
        for bucket, d in sorted(s.get("latency_by_bucket", {}).items(),
                                key=lambda kv: str(kv[0])):
            tags = f'stage="{esc(stage)}",bucket="{esc(bucket)}"'
            for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
                lines.append(f'isc_request_latency_ms{{{tags},'
                             f'quantile="{q}"}} {d[key]}')
            lines.append(
                f'isc_request_latency_ms_count{{{tags}}} {d["n"]}')
    if stalled:
        lines.append("# TYPE isc_stalled_seconds gauge")
        for stage, v in stalled.items():
            lines.append(
                f'isc_stalled_seconds{{stage="{esc(stage)}"}} {v:.3f}')
    return "\n".join(lines) + "\n"

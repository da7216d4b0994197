"""Batch loaders: fixed-size batches with shuffling and background prefetch.

The port's copy of ``insenticap_model_tpu/data/loaders.py`` (:24-157): for
the same items, batch size and seed, ``Loader`` yields the JAX package's
batches in the JAX package's order (one ``numpy.random.default_rng(seed)``
shuffle a pass), collated on a background thread. Training drops the
partial last batch; eval pads it by repeating the last item and reports
``valid``. ``shard=(idx, count)`` keeps the JAX package's stripe of the
items (``items[idx::count]``, cut to ``len(items) // count`` so that
every rank takes the same number of batches): each data-parallel rank
reads its own stripe (``cli/common.host_shard``).

Three additions serve an exact resume: ``Loader.advance(passes)`` replays
the shuffles of passes already taken, ``CycleIterator.skip(n)`` passes
over n batches without assembling them, and ``Loader.iterate(limit)``
assembles no batch past a pass's first ``limit`` (the RL stage's epoch
cap), so that a run resumed at epoch e meets the batches an
uninterrupted run meets there.
``device_prefetch`` keeps batches staged ahead of the step; the
``put_fn`` the CLIs pass (``cli/common.Runtime.put``) copies from pinned
host memory without blocking, so the copy of batch i+1 overlaps step i.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Iterator, List, Optional

import numpy as np


class Loader:
    def __init__(self, items: List, batch_size: int, collate: Callable,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 shard: Optional[tuple] = None):
        if not items:
            raise ValueError("empty dataset")
        if shard is not None:
            idx, count = shard
            per = len(items) // count
            if per == 0:
                raise ValueError(f"shard {idx}/{count} is empty")
            items = items[idx::count][:per]
        self.items = items
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.items)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _index_batches(self):
        """One pass's batches of item indices (one shuffle of the
        stream); a padded last batch comes as (ids, valid)."""
        idx = np.arange(len(self.items))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        n_full = len(idx) // bs
        batches = [idx[i * bs:(i + 1) * bs] for i in range(n_full)]
        rem = len(idx) - n_full * bs
        if rem and not self.drop_last:
            tail = idx[n_full * bs:]
            pad = np.full(bs - rem, tail[-1])
            batches.append((np.concatenate([tail, pad]), rem))
        return batches

    def advance(self, passes: int) -> None:
        """Take ``passes`` passes' shuffles without assembling a batch."""
        for _ in range(passes):
            self._index_batches()

    def assemble(self, b):
        """One batch of ``_index_batches`` -> the collated dict."""
        ids, valid = b if isinstance(b, tuple) else (b, len(b))
        out = self.collate([self.items[i] for i in ids])
        out["valid"] = valid
        return out

    def __iter__(self) -> Iterator:
        return self.iterate()

    def iterate(self, limit: Optional[int] = None) -> Iterator:
        """One pass (one shuffle); with ``limit``, its first ``limit``
        batches only, none assembled past them."""
        batches = self._index_batches()[:limit]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # the consumer left the iterator

        def produce():
            try:
                for b in batches:
                    out = self.assemble(b)
                    # a put that notices the consumer leaving: a plain put
                    # would block for ever once it stops reading
                    while not stop.is_set():
                        try:
                            q.put(out, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # raised again by the consumer
                q.put(e)
                return
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a producer mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)


def device_prefetch(iterator, put_fn, depth: int = 2):
    """Keep ``depth`` batches put (``put_fn``) ahead of consumption."""
    buf = deque()
    for item in iterator:
        buf.append(put_fn(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class CycleIterator:
    """Endless round-robin over a loader, a new shuffle each pass (the
    reference restarts the seq2seq iterator on StopIteration,
    train_xe.py:170-175)."""

    def __init__(self, loader: Loader):
        if len(loader) == 0:
            raise ValueError(
                "CycleIterator over an empty loader (dataset smaller than "
                "batch size with drop_last=True)")
        self.loader = loader
        self._pending: deque = deque()

    def _take(self):
        if not self._pending:
            self._pending.extend(self.loader._index_batches())
        return self._pending.popleft()

    def next(self):
        return self.loader.assemble(self._take())

    def skip(self, n: int) -> None:
        """Pass over ``n`` batches without assembling them."""
        for _ in range(n):
            self._take()

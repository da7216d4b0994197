"""Step timing and traces: the port's copy of
``insenticap_model_tpu/utils/profiling.py`` (per-step wall timing with
JSONL records and an EMA rate; ``torch.profiler`` traces in place of
``jax.profiler``'s).

Usage in a train loop:
    prof = StepTimer(log_path="metrics.jsonl", items_per_step=bs)
    with maybe_trace(trace_dir):
        for step, batch in ...:
            with prof.step(step):
                with annotate("train_step"):
                    out = train_step(...)
                prof.sink(out)           # the step's last array

A step ends when one element of its sunk array has reached the host: a
copy that waits for the work queued before it on the array's stream, not
a device-wide synchronise.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import nn
from . import timing


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], enabled: bool = True):
    """A ``torch.profiler`` session around the region, written as a
    Chrome/Perfetto trace (``trace_<pid>_<ns>.pt.trace.json``) under
    ``trace_dir``; a no-op when ``trace_dir`` is empty or ``enabled`` is
    false. It records the host's activity, and the card's where the
    process uses one; there the session first launches ``timing.spin``'s
    spins, whose records it may lose in place of the region's."""
    if not (trace_dir and enabled):
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        if cuda:
            timing.spin()
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named region inside a trace (a span on the profiler's timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock time a step, JSONL records and an EMA rate."""

    def __init__(self, log_path: Optional[str] = None, ema: float = 0.9,
                 items_per_step: int = 0):
        self.log_path = log_path
        self.ema = ema
        self.items_per_step = items_per_step
        self._rate = None
        self._t0 = None
        self._sink_val: Any = None

    @contextlib.contextmanager
    def step(self, step_idx: int, items: Optional[int] = None):
        self._t0 = time.perf_counter()
        self._sink_val = None
        yield self
        if self._sink_val is not None:
            # the step's end: one element on the host
            v = self._sink_val
            if isinstance(v, torch.Tensor):
                v.detach().reshape(-1)[:1].cpu()
            else:
                np.asarray(v).reshape(-1)[:1]
        dt = time.perf_counter() - self._t0
        n = items if items is not None else self.items_per_step
        rate = n / dt if n and dt > 0 else None
        if rate is not None:
            self._rate = rate if self._rate is None else \
                self.ema * self._rate + (1 - self.ema) * rate
        if self.log_path:
            rec = {"step": step_idx, "step_time_s": round(dt, 6)}
            if rate is not None:
                rec["items_per_s"] = round(rate, 2)
                rec["items_per_s_ema"] = round(self._rate, 2)
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def sink(self, val: Any) -> Any:
        """Mark the array whose completion ends the step: the last leaf of
        ``val`` with a ``dtype`` (a tensor or a numpy array), dict keys
        taken in sorted order, as JAX flattens a tree."""
        leaves = [x for x in nn.tree_leaves(val) if hasattr(x, "dtype")]
        self._sink_val = leaves[-1] if leaves else None
        return val

    @property
    def rate_ema(self) -> Optional[float]:
        return self._rate

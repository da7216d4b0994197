"""Kernel timing on the card: CUDA events, and the profiler's device time."""
from __future__ import annotations

import statistics

import torch


def cuda_ms(fn, *, iters: int = 20, reps: int = 5, warm: int = 3) -> float:
    """Median over ``reps`` runs of the mean time in ms of ``iters``
    back-to-back calls of ``fn``, timed with CUDA events on the current
    stream, after ``warm`` calls. Where a call's device work is shorter
    than the host's dispatch of it (tens of us), this times the host."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def device_ms(fn, *, iters: int = 20, warm: int = 3) -> float:
    """Mean device time in ms of one call of ``fn``: the summed durations
    of the device activity (kernels, copies, fills) that ``torch.profiler``
    records over ``iters`` calls after ``warm`` calls, so the host's
    dispatch between launches is left out. Raises if the profiler records
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == cuda]
    if not us:
        raise RuntimeError("device_ms: the profiler recorded no device "
                           "activity")
    return sum(us) / iters / 1e3

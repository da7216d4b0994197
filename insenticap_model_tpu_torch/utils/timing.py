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


def _device_events(fn, iters: int, warm: int, attempts: int = 3):
    """(name, us) of every device activity (kernels, copies, fills) that
    ``torch.profiler`` records over ``iters`` calls of ``fn`` after
    ``warm`` calls. A profiling session now and then comes back with no
    device activity at all, so an empty session is taken again, up to
    ``attempts`` sessions; then it raises."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == cuda]
        if events:
            return events
    raise RuntimeError(f"device_ms: {attempts} profiler sessions recorded no "
                       "device activity")


def device_ms(fn, *, iters: int = 20, warm: int = 3) -> float:
    """Mean device time in ms of one call of ``fn``: the summed durations
    of the device activity (kernels, copies, fills) that ``torch.profiler``
    records over ``iters`` calls after ``warm`` calls, so the host's
    dispatch between launches is left out. Raises if the profiler records
    no device activity (``_device_events``)."""
    return sum(us for _, us in _device_events(fn, iters, warm)) / iters / 1e3


def device_ms_by_name(fn, parts, *, iters: int = 20,
                      warm: int = 3) -> dict:
    """``device_ms`` split by activity: {part: mean ms a call} for every
    substring in ``parts``, summed over the activities whose name holds
    it, and "total" over all of them."""
    events = _device_events(fn, iters, warm)
    out = {part: sum(us for name, us in events if part in name)
           / iters / 1e3 for part in parts}
    out["total"] = sum(us for _, us in events) / iters / 1e3
    return out


def device_ms_by_kernel(fn, *, iters: int = 20, warm: int = 3) -> dict:
    """``device_ms`` split by activity name: {name: mean ms a call}, for
    a breakdown whose kernel names are not known in advance."""
    out: dict = {}
    for name, us in _device_events(fn, iters, warm):
        out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out

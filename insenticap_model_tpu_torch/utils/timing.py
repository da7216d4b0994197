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


def instance_mismatches(events, per_call, iters: int) -> list:
    """[(part, want, got)] for each part of ``per_call`` ({name substring:
    activities one call records under it}) whose activities in ``events``
    [(name, us)] do not number ``iters * per_call[part]``: a session that
    lost launches, or recorded more than the calls made."""
    out = []
    for part, n in per_call.items():
        got = sum(part in name for name, _ in events)
        if got != iters * n:
            out.append((part, iters * n, got))
    return out


# profiler sessions taken by ``_device_events``, and of them those taken
# again because a part's instance count was off
SESSIONS = {"taken": 0, "short": 0}
# the short spins a profiler session starts with (``spin``)
SPINS = 64


def spin(n: int = SPINS) -> None:
    """``n`` short spins of the card (``torch.cuda._sleep``, some 5 us
    each; the profiler names them ``spin_kernel``): launches of its own
    for a new profiler session to lose. A session can lose the records of
    its first launches (up to 17 on an H100 in
    ``tools/profiler_session_loss.py``'s run, all else whole); a long spin
    first does not help, launches do."""
    for _ in range(n):
        torch.cuda._sleep(10_000)


def _device_events(fn, iters: int, warm: int, attempts: int = 3,
                   per_call=None):
    """(name, us) of every device activity (kernels, copies, fills) that
    ``torch.profiler`` records over ``iters`` calls of ``fn`` after
    ``warm`` calls.

    Each session starts with launches of its own to lose: ``SPINS``
    short spins of the card (``spin``, left out of the events), then the
    calls. A session
    that is empty, or whose count of a part of ``per_call`` is not
    ``iters`` times its count a call (``instance_mismatches``), is taken
    again with 4x the spins, up to ``attempts`` sessions; then it raises,
    naming the part and both counts."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    fault = "recorded no device activity"
    for attempt in range(attempts):
        SESSIONS["taken"] += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            spin(SPINS * 4 ** attempt)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == cuda and "spin_kernel" not in e.name]
        bad = instance_mismatches(events, per_call or {}, iters)
        if events and not bad:
            return events
        if events:
            SESSIONS["short"] += 1
            fault = "; ".join(f"{part!r} {got} instances, not {want}"
                              for part, want, got in bad)
    raise RuntimeError(f"device_ms: {attempts} profiler sessions of {iters} "
                       f"calls: the last {fault}")


def device_ms(fn, *, iters: int = 20, warm: int = 3) -> float:
    """Mean device time in ms of one call of ``fn``: the summed durations
    of the device activity (kernels, copies, fills) that ``torch.profiler``
    records over ``iters`` calls after ``warm`` calls, so the host's
    dispatch between launches is left out. Raises if the profiler records
    no device activity (``_device_events``)."""
    return sum(us for _, us in _device_events(fn, iters, warm)) / iters / 1e3


def launches_per_call(fn, counters) -> dict:
    """``per_call`` for ``device_ms_by_name`` from the ops' launch
    counters: {part: launches one call of ``fn`` adds to the counter
    ``counters[part]`` = (op wrapper, attribute), e.g.
    (``fused_attention.beam_content_attention``, "launches")}. Each counted
    launch records one activity under each part's kernel name."""
    before = {p: getattr(op, a) for p, (op, a) in counters.items()}
    fn()
    torch.cuda.synchronize()
    return {p: getattr(op, a) - before[p] for p, (op, a) in counters.items()}


def device_ms_by_name(fn, parts, *, per_call, iters: int = 20,
                      warm: int = 3) -> dict:
    """``device_ms`` split by activity: {part: mean ms a call} for every
    substring in ``parts``, summed over the activities whose name holds
    it, and "total" over all of them. ``per_call`` {part: activities one
    call of ``fn`` records under it} (its ops' launch counters give it;
    {} where no part is a kernel of the port's) is held to the session:
    a session short of a launch, or with one too many, is taken again,
    then refused (``_device_events``)."""
    events = _device_events(fn, iters, warm, per_call=per_call)
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

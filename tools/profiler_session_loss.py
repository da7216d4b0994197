#!/usr/bin/env python3
"""Which launches a ``torch.profiler`` session loses, late in a long process.

    python3 tools/profiler_session_loss.py

Runs ``chip_smoke.py`` (every phase, its checks on) with each profiler
session that ``utils/timing`` takes looked into: the session's kernel
launches (the runtime's ``cudaLaunchKernel``/``cuLaunchKernelEx`` records)
are matched with its kernel records by correlation id. Every session that
lost some prints how many of its launches have no kernel record, the
largest position among them, and the position of its first launch that
is not one of the spins ``_device_events`` starts a session with (a loss
below it fell on the spins, not on the calls measured). The last line
sums the sessions. Needs a CUDA card and exits non-zero without one.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def main():
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("profiler_session_loss: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    import torch.profiler as tp
    cuda = torch.autograd.DeviceType.CUDA
    tally = {"sessions": 0, "lossy": 0, "lost": 0, "lost_on_calls": 0}

    class Looked(tp.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            raw = list(self.profiler.kineto_results.events())
            launches = sorted((e.start_ns(), e.correlation_id()) for e in raw
                              if e.device_type() != cuda
                              and "aunchKernel" in e.name())
            kernels = {e.correlation_id(): e.name() for e in raw
                       if e.device_type() == cuda}
            order = [c for _, c in launches]
            lost = [i for i, c in enumerate(order) if c not in kernels]
            first_call = next((i for i, c in enumerate(order)
                               if c in kernels
                               and "spin_kernel" not in kernels[c]),
                              len(order))
            tally["sessions"] += 1
            if lost:
                on_calls = sum(i >= first_call for i in lost)
                tally["lossy"] += 1
                tally["lost"] += len(lost)
                tally["lost_on_calls"] += on_calls
                print(f"profiler session {tally['sessions']}: "
                      f"{len(lost)} of {len(order)} launches without a "
                      f"kernel record, the last at position {max(lost)}; "
                      f"the first measured launch at {first_call}; "
                      f"{on_calls} lost on the measured calls", flush=True)
            return out

    tp.profile = Looked
    import chip_smoke
    try:
        chip_smoke.main()
    finally:
        print(f"profiler sessions: {tally['sessions']} taken, "
              f"{tally['lossy']} lost launches ({tally['lost']} in all, "
              f"{tally['lost_on_calls']} of them on the measured calls)",
              flush=True)


if __name__ == "__main__":
    main()

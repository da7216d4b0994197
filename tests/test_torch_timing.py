"""``utils/timing``'s instance count on the CPU: a profiler session whose
launches of a named part are not ``iters`` times one call's is found
(``instance_mismatches``), taken again and, if it stays so, refused
(``device_ms_by_name``), on fabricated sessions of (name, us) pairs."""
import types

import pytest
import torch

from insenticap_model_tpu_torch.utils import timing

V1 = {"query_": 1, "beam_att_kernel": 1}


def _session(n_query, n_att, extra=()):
    return ([("at::native::spin_kernel(long)", 20000.0)]
            + [("query_bf16_kernel", 7.0)] * n_query
            + [("beam_att_kernel<bf16, 3, true>", 48.0)] * n_att
            + [("Memset (Device)", 1.0)] + list(extra))


@pytest.mark.parametrize("events,per_call,want", [
    (_session(4, 4), V1, []),
    (_session(4, 3), V1, [("beam_att_kernel", 4, 3)]),
    (_session(5, 4), V1, [("query_", 4, 5)]),
    (_session(0, 9), V1, [("query_", 4, 0), ("beam_att_kernel", 4, 9)]),
    # a kernel one call must not launch, launched
    (_session(4, 4, [("wino_input_kernel<bf16>", 9.0)]),
     dict(V1, wino_input_kernel=0), [("wino_input_kernel", 0, 1)])],
    ids=["whole", "short", "extra", "both", "unwanted"])
def test_instance_mismatches(events, per_call, want):
    assert timing.instance_mismatches(events, per_call, 4) == want


class _FakeProfile:
    """torch.profiler.profile that returns the next queued session."""
    sessions: list = []

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def events(self):
        cuda = torch.autograd.DeviceType.CUDA
        return [types.SimpleNamespace(
            name=n, device_type=cuda, time_range=types.SimpleNamespace(
                elapsed_us=lambda us=us: us))
            for n, us in self.sessions.pop(0)]


@pytest.fixture
def fake_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    spins = []
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    _FakeProfile.spins = spins
    return _FakeProfile


def test_short_session_taken_again(fake_profiler):
    """A session short of a launch is retaken; the whole one is read."""
    fake_profiler.sessions = [_session(2, 1), _session(2, 2)]
    calls = []
    out = timing.device_ms_by_name(lambda: calls.append(1),
                                   ("query_", "beam_att_kernel"),
                                   per_call=V1, iters=2, warm=1)
    assert not fake_profiler.sessions and len(calls) == 1 + 2 + 2
    # each session's first launches are spins of the card, 4x as many in
    # a retake
    assert len(fake_profiler.spins) == 64 + 256
    assert out["query_"] == pytest.approx(7.0e-3)
    assert out["beam_att_kernel"] == pytest.approx(48.0e-3)
    assert out["total"] == pytest.approx(55.5e-3)


def test_sessions_that_stay_short_refused(fake_profiler):
    fake_profiler.sessions = [_session(2, 1), [], _session(3, 2)]
    with pytest.raises(RuntimeError,
                       match=r"'query_' 3 instances, not 2"):
        timing.device_ms_by_name(lambda: None, ("query_",), per_call=V1,
                                 iters=2, warm=0)
    fake_profiler.sessions = [[], [], []]
    with pytest.raises(RuntimeError, match="no device activity"):
        timing.device_ms_by_name(lambda: None, (), per_call={}, iters=2,
                                 warm=0)


def test_launches_per_call_reads_the_counters(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def op():
        op.launches += 1
        op.other += 2
    op.launches, op.other = 5, 0
    assert timing.launches_per_call(op, {"a": (op, "launches"),
                                         "b": (op, "other")}) == \
        {"a": 1, "b": 2}

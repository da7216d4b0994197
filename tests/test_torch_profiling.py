"""The port's step timing and traces (``utils/profiling.py``) on the CPU:
the five cases of ``tests/test_profiling.py`` on the port, then the port
against the JAX package's module under one fixed clock (the same steps,
items and sinks give identical JSONL records and EMA rates, and the same
leaf is sunk, dict keys in JAX's sorted order), and a CPU trace that
holds the ``annotate`` spans."""
import glob
import itertools
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insenticap_model_tpu.utils import profiling as jprof
from insenticap_model_tpu_torch.utils import profiling


def test_step_timer_writes_jsonl_and_ema(tmp_path):
    log = tmp_path / "metrics.jsonl"
    t = profiling.StepTimer(log_path=str(log), ema=0.5, items_per_step=10)
    for i in range(3):
        with t.step(i):
            t.sink({"loss": torch.ones((4,)), "aux": torch.zeros((2, 2))})
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert r["step_time_s"] > 0
        assert r["items_per_s"] > 0
        assert r["items_per_s_ema"] > 0
    assert t.rate_ema is not None and t.rate_ema > 0


def test_step_timer_items_override_and_no_log():
    t = profiling.StepTimer()          # no log path, no items -> no rate
    with t.step(0):
        pass
    assert t.rate_ema is None
    with t.step(1, items=5):
        t.sink(torch.arange(3))
    assert t.rate_ema is not None


def test_sink_returns_value_and_handles_non_arrays():
    t = profiling.StepTimer()
    val = {"a": 1, "b": "x"}           # no array leaves
    assert t.sink(val) is val
    assert t._sink_val is None


def test_maybe_trace_disabled_is_noop(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(str(tmp_path), enabled=False):
        pass
    with profiling.maybe_trace(""):
        pass
    assert not any(tmp_path.rglob("*"))


def test_maybe_trace_enabled_writes_trace(tmp_path):
    with profiling.maybe_trace(str(tmp_path / "tr")):
        with profiling.annotate("gather_span"):
            x = torch.ones((8,))
        with profiling.annotate("step_span"):
            x.sum()
    [path] = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"gather_span", "step_span"} <= names


def test_maybe_trace_writes_trace_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError):
        with profiling.maybe_trace(str(tmp_path / "tr")):
            with profiling.annotate("failing_span"):
                raise ValueError("boom")
    [path] = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert "failing_span" in open(path).read()


# (items_per_step, ema, [(items or None, sink value maker or None)])
SCENARIOS = {
    "items_per_step": (10, 0.5, [(None, "dict")] * 4),
    "override": (0, 0.9, [(None, None), (5, "arange"), (None, "dict"),
                          (7, "list"), (0, "dict")]),
    "default_ema": (3, 0.9, [(None, "tuple"), (12, None), (None, "dict"),
                             (2, "nested")]),
}


def _sink_value(kind, arr):
    """The same tree in either package: ``arr`` makes its arrays."""
    return {"dict": lambda: {"loss": arr(np.ones(4)),
                             "aux": arr(np.zeros((2, 2)))},
            "arange": lambda: arr(np.arange(3.0)),
            "list": lambda: [arr(np.full(2, 3.0)), arr(np.ones(1)), "x"],
            "tuple": lambda: (arr(np.zeros(3)), 1, None),
            "nested": lambda: {"z": [arr(np.ones(2))],
                               "a": {"y": arr(np.full(5, 2.0)), "b": 4}},
            }[kind]()


def _run(mod, arr, log, items_per_step, ema, steps, monkeypatch):
    """The scenario's steps under a fixed clock; the sunk values."""
    clock = itertools.accumulate(
        itertools.cycle([0.0, 0.125, 1e-3, 0.0371, 2.5e-4, 0.3]),
        initial=100.0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = mod.StepTimer(log_path=str(log), ema=ema,
                      items_per_step=items_per_step)
    sunk = []
    for i, (items, kind) in enumerate(steps):
        with t.step(i, items=items):
            if kind:
                val = _sink_value(kind, arr)
                assert t.sink(val) is val
            sunk.append(t._sink_val)
    return t, sunk


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_step_timer_matches_jax(tmp_path, monkeypatch, scenario):
    items_per_step, ema, steps = SCENARIOS[scenario]
    jt, jsunk = _run(jprof, jnp.asarray, tmp_path / "j.jsonl",
                     items_per_step, ema, steps, monkeypatch)
    tt, tsunk = _run(profiling, torch.as_tensor, tmp_path / "t.jsonl",
                     items_per_step, ema, steps, monkeypatch)
    j = (tmp_path / "j.jsonl").read_text()
    assert (tmp_path / "t.jsonl").read_text() == j
    assert len(j.splitlines()) == len(steps)
    assert tt.rate_ema == jt.rate_ema
    for a, b in zip(jsunk, tsunk):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sink_picks_jax_leaf_not_insertion_order():
    """``{"loss": ..., "aux": ...}``: JAX sorts the keys, so its last leaf
    is "loss", where torch's pytree (insertion order) would give "aux"."""
    loss, aux = torch.ones(4), torch.zeros(2, 2)
    t = profiling.StepTimer()
    t.sink({"loss": loss, "aux": aux})
    assert t._sink_val is loss
    jt = jprof.StepTimer()
    jt.sink({"loss": jnp.ones(4), "aux": jnp.zeros((2, 2))})
    assert jt._sink_val.shape == (4,)


def test_step_end_fetches_one_element_without_device_sync(monkeypatch):
    """The step ends on the sunk leaf's first element reaching the host
    (a numpy leaf too), never on a device-wide synchronise."""
    def refuse():
        raise AssertionError("torch.cuda.synchronize called")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    fetched = []
    real_cpu = torch.Tensor.cpu

    def spy(self, *a, **k):
        fetched.append(self.numel())
        return real_cpu(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    t = profiling.StepTimer()
    with t.step(0):
        t.sink({"w": torch.ones(3, 5, requires_grad=True)})
    assert fetched == [1]
    with t.step(1):
        t.sink([np.ones(3)])
    assert fetched == [1]

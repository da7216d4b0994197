"""The port's DynamicBatcher on the CPU: mixed auto and forced rows, padded
up the bucket ladder, come back row for row equal to direct calls of the
port's serving functions (exact: each row's decode is independent of its
batch-mates, in f32 and in bf16); plus the batching core's admission,
close and metrics behaviour."""
import threading

import numpy as np
import pytest
import torch

from insenticap_model_tpu_torch import inference as tinf
from insenticap_model_tpu_torch.serving.batching import prometheus_metrics
from insenticap_model_tpu_torch.serving_daemon import (AUTO, DynamicBatcher,
                                                       Saturated)
from insenticap_model_tpu_torch.utils.dtypes import cast_bf16

from torch_parity import (TIDS, captioner_params, detector_params, features,
                          n, port_settings, t)

T = 8
M = 5


def _params(settings):
    _, cp = captioner_params(settings, seed=5, eos_bias=1.0)
    _, dp = detector_params(settings, seed=6, scale=10.0)
    return cp, dp


def _batcher(settings, cp, dp, **kw):
    return DynamicBatcher(cp, dp, settings=port_settings(settings),
                          ids=TIDS, max_seq_len=T, num_sentiments=M,
                          device="cpu", **kw)


def _submit_all(b, fc, att, sentis, forced):
    results = [None] * len(fc)
    errors = []

    def go(i):
        try:
            results[i] = b.submit(fc[i], att[i], sentis[i],
                                  forced_label=forced[i], timeout=120)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(fc))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=180)
        assert not th.is_alive()
    assert not errors, errors
    return results


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_batcher_rows_equal_direct_calls(settings, compute_dtype):
    cp, dp = _params(settings)
    ps = port_settings(settings)
    fc, att, sentis = features(settings, 11, 70, m=M)
    att = att - 0.5
    forced = [AUTO, 1, AUTO, 0, 2, AUTO, AUTO, 1, AUTO, 0, AUTO]
    with _batcher(settings, cp, dp, bucket_sizes=(1, 4, 16),
                  max_wait_s=0.2, compute_dtype=compute_dtype) as b:
        results = _submit_all(b, fc, att, sentis, forced)
        stats = b.stats()
    assert stats["requests"] == 11 and stats["failed_requests"] == 0
    assert sum(stats["by_bucket"].values()) == stats["batches"]

    dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    if dt == torch.bfloat16:
        cp, dp = cast_bf16(cp), cast_bf16(dp)
    detect = tinf.make_detect_fn(tinf.SENTI_THRESHOLD, TIDS.neutral)
    serve = tinf.make_forced_serving_fn(ps, TIDS, max_seq_len=T)
    labels_seen = set()
    for i, (seqs, scores, label) in enumerate(results):
        a = t(att[i:i + 1]).to(dt)
        want_label = int(detect(dp, a)[0]) if forced[i] == AUTO \
            else forced[i]
        assert label == want_label
        labels_seen.add(label)
        wseqs, wscores = serve(cp, t(fc[i:i + 1]).to(dt), a,
                               t(sentis[i:i + 1]).long(),
                               torch.tensor([label], dtype=torch.int32))
        np.testing.assert_array_equal(seqs, n(wseqs)[0])
        np.testing.assert_array_equal(scores, n(wscores)[0])
        assert seqs.shape == (3, T) and scores.dtype == np.float32
        if forced[i] == AUTO:   # the whole serving step, called directly
            dseqs, dscores, dlab = tinf.detect_and_decode(
                tinf.ServingParams(cp, dp), t(fc[i:i + 1]).to(dt), a,
                t(sentis[i:i + 1]).long(), settings=ps, ids=TIDS,
                max_seq_len=T)
            assert int(dlab[0]) == label
            np.testing.assert_array_equal(seqs, n(dseqs)[0])
            np.testing.assert_array_equal(scores, n(dscores)[0])
    assert len(labels_seen) >= 2


def test_batcher_pads_with_a_live_row_and_counts(settings):
    cp, dp = _params(settings)
    fc, att, sentis = features(settings, 3, 71, m=M)
    with _batcher(settings, cp, dp, bucket_sizes=(1, 8),
                  max_wait_s=0.2) as b:
        b.warm([1])
        _submit_all(b, fc, att, sentis, [AUTO, 2, 0])
        one = b.submit(fc[0], att[0], sentis[0])
        stats = b.stats()
    assert stats["by_bucket"] == {1: 1, 8: 1}
    assert stats["padded_rows"] == 5
    assert one[0].shape == (3, T)
    assert set(stats["latency_by_bucket"]) == {1, 8}


def test_batcher_validates_requests_and_closes(settings):
    cp, dp = _params(settings)
    fc, att, sentis = features(settings, 1, 72, m=M)
    b = _batcher(settings, cp, dp, bucket_sizes=(1,))
    with pytest.raises(ValueError):
        b.submit(fc[0][:3], att[0], sentis[0])
    with pytest.raises(ValueError):
        b.submit(fc[0], att[0], sentis[0], forced_label=3)
    b.close()
    b.close()                                   # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(fc[0], att[0], sentis[0])
    with pytest.raises(ValueError):
        _batcher(settings, cp, dp, bucket_sizes=(8, 1))
    with pytest.raises(ValueError):
        _batcher(settings, cp, dp, compute_dtype="float16")


def test_batcher_sheds_load_when_saturated(settings):
    """A full queue raises Saturated past enqueue_timeout, and a failing
    batch reaches its callers and the failure counters."""
    cp, dp = _params(settings)
    fc, att, sentis = features(settings, 1, 73, m=M)
    gate = threading.Event()
    b = _batcher(settings, cp, dp, bucket_sizes=(1,), max_queue=1)
    real = b._run

    def blocked(*a):
        gate.wait(30)
        raise RuntimeError("device fault")
    b._run = blocked
    try:
        waiters = [threading.Thread(
            target=lambda: pytest.raises(RuntimeError, b.submit, fc[0],
                                         att[0], sentis[0], timeout=60))
            for _ in range(2)]
        for w in waiters:
            w.start()
        deadline = threading.Event()
        while b._q.qsize() < 1 or b._dispatch_started is None:
            deadline.wait(0.01)
        with pytest.raises(Saturated):
            b.submit(fc[0], att[0], sentis[0], enqueue_timeout=0.05)
        assert b.stalled_for() > 0 and not b.healthy(0.0)
        gate.set()
        for w in waiters:
            w.join(60)
            assert not w.is_alive()
    finally:
        gate.set()
        b._run = real
        b.close()
    assert b.stats()["failed_requests"] == 2


def test_prometheus_metrics_renders_stats():
    stats = {"requests": 3, "batches": 2, "padded_rows": 1,
             "failed_requests": 0, "failed_batches": 0,
             "by_bucket": {1: 1, 8: 1},
             "latency_by_bucket": {8: {"n": 2, "p50_ms": 1.5,
                                       "p99_ms": 2.0}}}
    text = prometheus_metrics({"decode": stats}, {"decode": 0.25})
    assert 'isc_requests_total{stage="decode"} 3' in text
    assert 'isc_batches_by_bucket_total{stage="decode",bucket="8"} 1' in text
    assert ('isc_request_latency_ms{stage="decode",bucket="8",'
            'quantile="0.99"} 2.0') in text
    assert 'isc_stalled_seconds{stage="decode"} 0.250' in text
    assert text.endswith("\n")

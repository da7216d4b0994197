"""Sharded serving in one process on the CPU: the port's
``make_sharded_*`` factories over a ``DeviceMesh`` of 8 CPU slots against
the JAX package's ``shard_map`` ones over its 8 forced host devices
(``tests/conftest.py``), f32: tokens and labels identical, scores within
1e-5 (sums of up to 8 f32 log-probs in other summation orders); against
the port's one-device functions on each block bit for bit (the same
single-device body on the same rows). Then the mesh branches of the two
batchers against their one-device selves, the ladders' rounding, the
refusals, warm-up on every device, and a worker's failure reaching the
caller with no partial result."""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import inference as jinf
from insenticap_model_tpu.parallel import mesh as jmesh

from insenticap_model_tpu_torch import inference as tinf
from insenticap_model_tpu_torch import serving_daemon
from insenticap_model_tpu_torch.parallel import mesh as tmesh
from insenticap_model_tpu_torch.serving_daemon import AUTO, DynamicBatcher

from torch_parity import (JIDS, TIDS, captioner_params, detector_params,
                          features, n, port_settings, t)

BS, T, BEAM, M = 16, 8, 3, 6
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(settings, bs=BS, seed=5):
    """(fc, att, sentis), att offset a channel vector an image so that
    the detector's labels vary."""
    fc, att, sentis = features(settings, bs, seed, m=M)
    g = np.random.default_rng(seed + 100)
    att = (att + g.normal(size=(bs, 1, 1, att.shape[-1])) * 2).astype(
        np.float32)
    return fc, att, sentis


@pytest.fixture(scope="module")
def params(settings):
    jc, tc = captioner_params(settings, seed=5, eos_bias=1.0)
    jd, td = detector_params(settings, seed=1, scale=10.0)
    return (jinf.ServingParams(jc, jd), tinf.ServingParams(tc, td))


@pytest.fixture(scope="module")
def mesh8():
    with tmesh.make_device_mesh(8, "cpu") as m:
        yield m


def test_sharded_serving_fn_matches_jax_and_one_device(settings, params,
                                                       mesh8):
    jp, tp = params
    fc, att, sentis = _inputs(settings)
    m = jmesh.make_mesh((8,))
    jfn = jinf.make_sharded_serving_fn(m, settings, JIDS, beam_size=BEAM,
                                       max_seq_len=T)
    sb = jmesh.shard_batch(m, {"fc": jnp.asarray(fc), "att": jnp.asarray(att),
                               "sentis": jnp.asarray(sentis)})
    jseqs, jscores, jlabels = jfn(jmesh.replicate(m, jp), sb["fc"],
                                  sb["att"], sb["sentis"])

    ps = port_settings(settings)
    fn = tinf.make_sharded_serving_fn(mesh8, ps, TIDS, beam_size=BEAM,
                                      max_seq_len=T)
    seqs, scores, labels = fn(mesh8.replicate(tp), t(fc), t(att),
                              t(sentis))
    np.testing.assert_array_equal(n(seqs), np.asarray(jseqs))
    np.testing.assert_array_equal(n(labels), np.asarray(jlabels))
    np.testing.assert_allclose(n(scores), np.asarray(jscores), **SCORE_TOL)
    assert len(set(n(labels).tolist())) >= 2
    assert seqs.shape == (BS, BEAM, T) and seqs.device.type == "cpu"

    # the one-device fn: on the whole batch within the gate, on each
    # block of 2 rows bit for bit
    one = tinf.make_serving_fn(ps, TIDS, beam_size=BEAM, max_seq_len=T)
    wseqs, wscores, wlabels = one(tp, t(fc), t(att), t(sentis))
    np.testing.assert_array_equal(n(seqs), n(wseqs))
    np.testing.assert_array_equal(n(labels), n(wlabels))
    np.testing.assert_allclose(n(scores), n(wscores), **SCORE_TOL)
    for i in range(0, BS, BS // 8):
        r = slice(i, i + BS // 8)
        bseqs, bscores, blabels = one(tp, t(fc[r]), t(att[r]),
                                      t(sentis[r]))
        assert torch.equal(seqs[r], bseqs) and torch.equal(
            scores[r], bscores) and torch.equal(labels[r], blabels)


def test_sharded_forced_and_detect_fns_match_jax(settings, params, mesh8):
    jp, tp = params
    fc, att, sentis = _inputs(settings, seed=8)
    forced = (np.arange(BS) % 3).astype(np.int32)
    m = jmesh.make_mesh((8,))
    sb = jmesh.shard_batch(m, {"fc": jnp.asarray(fc), "att": jnp.asarray(att),
                               "sentis": jnp.asarray(sentis),
                               "labels": jnp.asarray(forced)})
    jdet = jinf.make_sharded_detect_fn(m, jinf.SENTI_THRESHOLD,
                                       JIDS.neutral)(
        jmesh.replicate(m, jp.senti_detector), sb["att"])
    jseqs, jscores = jinf.make_sharded_forced_serving_fn(
        m, settings, JIDS, beam_size=BEAM, max_seq_len=T)(
        jmesh.replicate(m, jp.captioner), sb["fc"], sb["att"],
        sb["sentis"], sb["labels"])

    ps = port_settings(settings)
    det = tinf.make_sharded_detect_fn(mesh8, tinf.SENTI_THRESHOLD,
                                      TIDS.neutral)(tp.senti_detector, t(att))
    seqs, scores = tinf.make_sharded_forced_serving_fn(
        mesh8, ps, TIDS, beam_size=BEAM, max_seq_len=T)(
        tp.captioner, t(fc), t(att), t(sentis), t(forced))
    np.testing.assert_array_equal(n(det), np.asarray(jdet))
    np.testing.assert_array_equal(n(seqs), np.asarray(jseqs))
    np.testing.assert_allclose(n(scores), np.asarray(jscores), **SCORE_TOL)
    # the one-device factories share the bodies
    np.testing.assert_array_equal(n(det), n(tinf.make_detect_fn(
        tinf.SENTI_THRESHOLD, TIDS.neutral)(tp.senti_detector, t(att))))
    wseqs, _ = tinf.make_forced_serving_fn(ps, TIDS, beam_size=BEAM,
                                           max_seq_len=T)(
        tp.captioner, t(fc), t(att), t(sentis), t(forced))
    np.testing.assert_array_equal(n(seqs), n(wseqs))


def test_sharded_fn_refuses_rows_and_fails_whole(settings, params, mesh8):
    """Rows that are not a multiple of the mesh raise ValueError; a
    worker that raises on block 1 fails the call, after every worker has
    finished, and nothing comes back; Shards in give Shards out, on the
    blocks' devices; a ServingParams replicates as one."""
    _, tp = params
    ps = port_settings(settings)
    fc, att, sentis = _inputs(settings)
    fn = tinf.make_sharded_serving_fn(mesh8, ps, TIDS, beam_size=BEAM,
                                      max_seq_len=T)
    with pytest.raises(ValueError, match="12 rows do not split into 8"):
        fn(tp, t(fc[:12]), t(att[:12]), t(sentis[:12]))

    ran, gate = [], threading.Barrier(8, timeout=60)

    def body(p, x):
        gate.wait()              # every worker is in before any raises
        ran.append(threading.current_thread().name)
        if float(x[0, 0]) == 2.0:
            raise RuntimeError("device fault on block 1")
        return x * 2
    x = torch.arange(BS, dtype=torch.float32).reshape(BS, 1)
    with pytest.raises(RuntimeError, match="block 1"):
        tmesh.shard_map(body, mesh8)({}, x)
    assert len(set(ran)) == 8

    reps = mesh8.replicate(tp)
    assert isinstance(reps.trees[0], tinf.ServingParams)
    assert mesh8.replicate(reps) is reps
    blocks = mesh8.shard_batch(x)
    out = tmesh.shard_map(lambda p, b: b + 1, mesh8)({}, blocks)
    assert isinstance(out, tmesh.Shards) and len(out) == 8
    assert torch.equal(tmesh.join(out), x + 1)


def test_make_device_mesh_never_shrinks_or_moves(monkeypatch):
    m = tmesh.make_device_mesh(3, "cpu")
    try:
        assert m.devices == (torch.device("cpu"),) * 3 and m.size == 3
    finally:
        m.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    with pytest.raises(SystemExit, match=r"needs 2 cards .* 1 is visible "
                       r"\(cuda:0 NVIDIA H100"):
        tmesh.make_device_mesh(2, "cuda")
    with pytest.raises(ValueError):
        tmesh.make_device_mesh(0, "cpu")


# ---------------------------------------------------------------------------
# the batchers' mesh branches
# ---------------------------------------------------------------------------

def _batcher(settings, tp, **kw):
    return DynamicBatcher(tp.captioner, tp.senti_detector,
                          settings=port_settings(settings), ids=TIDS,
                          max_seq_len=T, num_sentiments=M, device="cpu",
                          **kw)


def _submit_all(b, fc, att, sentis, forced):
    out = [None] * len(fc)
    errors = []

    def go(i):
        try:
            out[i] = b.submit(fc[i], att[i], sentis[i],
                              forced_label=forced[i], timeout=300)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(fc))]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=300)
        assert not th.is_alive()
    return out, errors


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mesh_batcher_matches_single_device(settings, params,
                                            compute_dtype):
    """DynamicBatcher(mesh=4 CPU slots) answers auto and forced rows token
    for token as the one-device batcher, scores and labels equal (each
    block runs the one-device body; JAX tests/test_serving_daemon.py
    :324)."""
    _, tp = params
    fc, att, sentis = _inputs(settings, bs=8, seed=6)
    forced = [AUTO, 0, 1, 2, AUTO, AUTO, 1, AUTO]

    def run(**kw):
        with _batcher(settings, tp, bucket_sizes=(4, 8), max_wait_s=0.3,
                      compute_dtype=compute_dtype, **kw) as b:
            out, errors = _submit_all(b, fc, att, sentis, forced)
            stats = b.stats()
        assert not errors, errors
        assert stats["requests"] == 8 and stats["failed_requests"] == 0
        return out

    plain = run()
    with tmesh.make_device_mesh(4, "cpu") as m:
        sharded = run(mesh=m)
    for p1, p2 in zip(plain, sharded):
        np.testing.assert_array_equal(p1[0], p2[0])
        np.testing.assert_array_equal(p1[1], p2[1])
        assert p1[2] == p2[2]
    assert {r[2] for r in sharded} >= {0, 1, 2}


def test_mesh_batcher_rejects_indivisible_buckets(settings, params):
    _, tp = params
    with tmesh.make_device_mesh(4, "cpu") as m:
        with pytest.raises(ValueError, match="not multiples of the mesh"):
            _batcher(settings, tp, bucket_sizes=(2, 4), mesh=m)
        with pytest.raises(ValueError, match="not multiples of the mesh"):
            serving_daemon.EncodeBatcher(
                None, lambda fc: fc, fc_dim=4, shape_buckets=((8, 8),),
                batch_buckets=(1, 4), device="cpu", mesh=m)


def test_default_ladders_round_up_under_mesh(settings, params):
    """bucket_sizes=None adapts the default ladders to the mesh (JAX
    tests/test_serving_daemon.py:364)."""
    _, tp = params
    assert serving_daemon.default_buckets(None) == (1, 8, 32, 128, 384)
    assert serving_daemon.default_encode_buckets(None) == (1, 4, 16, 32)
    with tmesh.make_device_mesh(8, "cpu") as m8:
        assert serving_daemon.default_buckets(m8) == (8, 32, 128, 384)
        assert serving_daemon.default_encode_buckets(m8) == (8, 16, 32)
        b = _batcher(settings, tp, mesh=m8)
        try:
            assert b._buckets == (8, 32, 128, 384)
        finally:
            b.close()
    with tmesh.make_device_mesh(4, "cpu") as m4:
        assert serving_daemon.default_encode_buckets(m4) == (4, 16, 32)


def test_mesh_warm_reaches_every_device(settings, params, monkeypatch):
    """warm() stages as the dispatch stages: the detector and the decode
    run on every device's block of every bucket, and the blocks that
    real traffic then sends are ones warm() ran (JAX :380)."""
    _, tp = params
    seen = []

    def spy(make):
        def factory(*a, **kw):
            body = make(*a, **kw)

            def fn(p, *x):
                seen.append((make.__name__, threading.current_thread().name,
                             x[0].device, tuple(x[0].shape[:1])))
                return body(p, *x)
            return fn
        return factory
    monkeypatch.setattr(tinf, "_detect_local", spy(tinf._detect_local))
    monkeypatch.setattr(tinf, "_forced_decode_local",
                        spy(tinf._forced_decode_local))
    fc, att, sentis = _inputs(settings, bs=4, seed=7)
    with tmesh.make_device_mesh(4, "cpu") as m:
        with _batcher(settings, tp, bucket_sizes=(4,), mesh=m) as b:
            b.warm()
            warmed = list(seen)
            out, errors = _submit_all(b, fc, att, sentis, [AUTO] * 4)
    assert not errors and all(o is not None for o in out)
    for name in ("_detect_local", "_forced_decode_local"):
        threads = {th for nm, th, _, _ in warmed if nm == name}
        assert len(threads) == 4, (name, threads)
    assert {(nm, d, r) for nm, _, d, r in seen} == \
        {(nm, d, r) for nm, _, d, r in warmed}


def test_encode_batcher_mesh_matches_single_device():
    """EncodeBatcher(mesh=4 CPU slots) with a tiny conv encoder on
    replicated weights: per row the one-device batcher's fc, att and
    concept ids, warm() through the same staging (JAX :561)."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(24, 3, 3, 3, generator=g)

    def make_apply(weights):
        def apply(x):
            wp = weights.on(x.device) if isinstance(
                weights, tmesh.Replicas) else weights
            h = torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2).float() / 255.0, wp, padding=1)
            h = h.permute(0, 2, 3, 1)
            return h.mean((1, 2)), h[:, :7, :7, :]
        return apply

    def cpt(fc):
        return torch.argsort(-fc, dim=-1, stable=True)[:, :3]
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, size=(16, 16, 3)).astype(np.uint8)
            for _ in range(8)]

    def run(apply, mesh=None):
        b = serving_daemon.EncodeBatcher(
            apply, cpt, fc_dim=24, shape_buckets=((16, 16),),
            batch_buckets=(4, 8), max_wait_s=0.25, device="cpu", mesh=mesh)
        try:
            b.warm()
            out = [None] * 8
            ts = [threading.Thread(target=lambda i=i: out.__setitem__(
                i, b.submit_image(imgs[i], timeout=300))) for i in range(8)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=300)
                assert not th.is_alive()
            return out, b.stats()
        finally:
            b.close()

    plain, _ = run(make_apply(w))
    with tmesh.make_device_mesh(4, "cpu") as m:
        sharded, stats = run(make_apply(m.replicate(w)), m)
    assert stats["requests"] == 8 and stats["failed_requests"] == 0
    for (fc_s, att_s, top_s), (fc_p, att_p, top_p) in zip(sharded, plain):
        np.testing.assert_allclose(fc_s, fc_p, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(att_s, att_p, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(top_s, top_p)
        assert fc_s.dtype == att_s.dtype == np.float32


def test_mesh_batch_failure_fails_only_its_requests(settings, params,
                                                    monkeypatch):
    """A worker's fault fails its batch's requests with that fault, no
    partial result; the next batch is served."""
    _, tp = params
    fc, att, sentis = _inputs(settings, bs=8, seed=9)
    faults = {"left": 1}
    real = tinf._forced_decode_local

    def flaky(*a, **kw):
        body = real(*a, **kw)

        def fn(p, f, *rest):
            if threading.current_thread().name.startswith("isc-mesh-1") \
                    and faults["left"]:
                faults["left"] -= 1
                raise RuntimeError("device fault on block 1")
            return body(p, f, *rest)
        return fn
    monkeypatch.setattr(tinf, "_forced_decode_local", flaky)
    with tmesh.make_device_mesh(2, "cpu") as m:
        with _batcher(settings, tp, bucket_sizes=(4,), max_wait_s=0.3,
                      mesh=m) as b:
            first, errors = _submit_all(b, fc[:4], att[:4], sentis[:4],
                                        [0, 1, 2, AUTO])
            assert len(errors) == 4 and all(
                "block 1" in str(e) for e in errors)
            assert first == [None] * 4
            second, errors = _submit_all(b, fc[4:], att[4:], sentis[4:],
                                         [0, 1, 2, AUTO])
            stats = b.stats()
    assert not errors and all(r is not None for r in second)
    assert stats["failed_requests"] == 4 and stats["requests"] == 4

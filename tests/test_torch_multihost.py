"""Multi-host serving on the CPU: the port's ``DynamicBatcher`` on a mesh
over processes (``parallel.mesh.ProcessMesh``, ``serving/multihost.py``),
gloo ranks spawned by ``torch_ranks.run_ranks`` through a ``file://``
group. Process 0 warms, submits 2n AUTO and forced requests from
concurrent threads and closes, while the others mirror from
``follower_loop``. The answers must be bit for bit those of the port's
one-process batcher on a ``DeviceMesh`` of the same n devices (every
process runs the same one-device body on the same one-row blocks), and,
at n = 2, those of the JAX ``DynamicBatcher`` on its ``(2,)`` mesh of
forced host devices: tokens and labels identical, scores within 1e-5.
The settings are ``tools/multihost_daemon_check.py``'s (V 30, T 8, M 6,
hidden 16, beam 2). Then the serve CLI in two processes, the refusals,
and a follower idle past its group's timeout."""
import json
import threading

import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu import serving_daemon as jdaemon
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.parallel import mesh as jmesh
from insenticap_model_tpu.training import checkpoint as jck

from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.cli import serve as tserve
from insenticap_model_tpu_torch.config import Opts
from insenticap_model_tpu_torch.parallel import mesh as tmesh
from insenticap_model_tpu_torch.serving_daemon import (DynamicBatcher,
                                                       default_buckets)

from torch_parity import JIDS, TIDS, detector_params, port_settings, to_port
from torch_ranks import (multihost_daemon, multihost_serve, numpy_tree,
                         run_ranks)

V, T, M, BEAM = 30, 8, 6, 2
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models(settings):
    """JAX captioner (V 30) and detector params and their port copies."""
    jc = jcap.init_params(jax.random.PRNGKey(0), V, 3, settings)
    jd, td = detector_params(settings, seed=1, scale=10.0)
    return (jc, jd), (to_port(jc), td)


def _requests(settings, nreq):
    """``tools/multihost_daemon_check.py``'s requests: AUTO and forced
    rows alternating."""
    g = np.random.default_rng(3)
    return [(g.normal(size=(settings.fc_feat_dim,)).astype(np.float32),
             g.normal(size=(14, 14, settings.att_feat_dim)).astype(
                 np.float32),
             g.integers(4, V, size=(M,)).astype(np.int32),
             -1 if i % 2 == 0 else i % 3) for i in range(nreq)]


def _spec(settings, models, n, **kw):
    _, (tc, td) = models
    return dict(dict(settings=port_settings(settings).to_dict(),
                     cap=numpy_tree(tc), det=numpy_tree(td),
                     ids=tuple(TIDS), beam=BEAM, T=T, M=M, n=n,
                     buckets=(n,), warm=True,
                     requests=_requests(settings, 2 * n)), **kw)


def _assert_same(got, want):
    """Tokens, scores and labels bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert not isinstance(g, Exception), g
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]


def _run_mp(spec, procs, tmp_path):
    ranks = run_ranks(multihost_daemon, procs, tmp_path, spec)
    p0 = ranks[0]
    assert p0["failed"] == 0 and p0["batches"] >= 2
    assert p0["stops"] == 1               # two closes, one STOP
    for r, f in enumerate(ranks[1:], 1):
        assert "only on process 0" in f["submit_raised"]
        assert f["closed"]                # left its loop after STOP
        assert f["stripes"] == p0["stripes"] == p0["dispatches"], r
    return ranks


def test_two_processes_one_slot_each(settings, models, tmp_path):
    """n = 2, two processes of one CPU slot: bit for bit the port's
    one-process batcher on 2 slots; against the JAX batcher on its (2,)
    mesh, tokens and labels identical, scores within 1e-5."""
    spec = _spec(settings, models, 2)
    p0 = _run_mp(spec, 2, tmp_path)[0]
    want = multihost_daemon(0, 1, spec)["answers"]
    _assert_same(p0["answers"], want)
    assert p0["buckets"] == (2,)
    assert p0["dispatches"] >= 1 + p0["batches"]   # the warm-up's too

    (jc, jd), _ = models
    jb = jdaemon.DynamicBatcher(
        jc, jd, settings=settings, ids=JIDS, beam_size=BEAM, max_seq_len=T,
        bucket_sizes=(2,), max_wait_s=0.25, num_sentiments=M,
        mesh=jmesh.make_mesh((2,)))
    try:
        jb.warm()
        out = [None] * len(spec["requests"])

        def go(i):
            r = spec["requests"][i]
            out[i] = jb.submit(r[0], r[1], r[2], forced_label=r[3],
                               timeout=300)
        ts = [threading.Thread(target=go, args=(i,))
              for i in range(len(out))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=300)
    finally:
        jb.close()
    for g, w in zip(p0["answers"], out):
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_allclose(g[1], np.asarray(w[1]), **SCORE_TOL)
        assert g[2] == int(w[2])
    assert {a[2] for a in p0["answers"]} >= {0, 1, 2}


@pytest.mark.parametrize("procs,n,dtype", [
    (2, 4, "float32"), (2, 2, "bfloat16"),
    pytest.param(4, 4, "float32", marks=pytest.mark.slow)])
def test_processes_match_one_process_mesh(settings, models, tmp_path,
                                          procs, n, dtype):
    """Two processes of two CPU slots each (n = 4); two of one slot in
    bf16 (the features cross as the bytes of bf16); four processes of one
    slot, three followers (JAX's ``test_multihost_daemon_four_followers``;
    slow: four more spawned processes): bit for bit the port's
    one-process batcher on n slots."""
    spec = _spec(settings, models, n, dtype=dtype)
    p0 = _run_mp(spec, procs, tmp_path)[0]
    _assert_same(p0["answers"], multihost_daemon(0, 1, spec)["answers"])


def test_failed_follower_fails_process_0s_batch(settings, models,
                                                tmp_path):
    """A follower whose stripe raises leaves its loop with the error, and
    process 0 does not carry on alone: every request fails through the
    collective's error, and none gets an answer."""
    spec = _spec(settings, models, 2, warm=False, fail_follower=True,
                 timeout_s=30.0)
    p0, f = run_ranks(multihost_daemon, 2, tmp_path, spec)
    assert "device fault in a follower" in f["loop_error"]
    assert f["stripes"] == 0 and not f["closed"]
    assert all(isinstance(a, RuntimeError) for a in p0["answers"]), \
        p0["answers"]
    assert p0["failed"] == len(spec["requests"]) and p0["batches"] == 0


def test_follower_survives_idleness_past_group_timeout(settings, models,
                                                       tmp_path):
    """The data group's timeout is 2 s (a wait of 2 s on a group of that
    timeout raises, the probe shows), and process 0 stays idle for 6 s
    before its first dispatch: the follower, waiting on the control
    vector the while, still mirrors every dispatch."""
    spec = _spec(settings, models, 2, idle_s=6.0, timeout_s=2.0)
    p0, f = _run_mp(spec, 2, tmp_path)
    assert f["probe_timed_out"] and f["probe_s"] >= 2.0
    assert f["loop_s"] >= 6.0 - f["probe_s"] > 2.0
    _assert_same(p0["answers"], multihost_daemon(
        0, 1, dict(spec, idle_s=0))["answers"])


def _serve_tree(tmp_path, settings):
    words = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [f"w{i}" for i in range(24)]
    concepts = words[4:12]
    comp = {"captioner": jcap.init_params(jax.random.PRNGKey(0), len(words),
                                          3, settings),
            "senti_detector": jsd.init_params(jax.random.PRNGKey(1), 3,
                                              settings)}
    jck.save(str(tmp_path / "rl.ckpt"), comp, None, {
        "epoch": 0, "settings": settings.to_dict(), "idx2word": words,
        "sentiment_categories": ["positive", "negative", "neutral"]})
    jck.save(str(tmp_path / "cpt.ckpt"),
             jcpt.init_params(jax.random.PRNGKey(2), len(concepts),
                              settings), None,
             {"epoch": 0, "settings": settings.to_dict(),
              "idx2concept": concepts})
    (tmp_path / "senti.json").write_text(json.dumps(
        {w: [[words[12 + i], 1.0], [words[20 + i], 0.5]]
         for i, w in enumerate(concepts)}))
    return ["--rl_model", str(tmp_path / "rl.ckpt"), "--concept_model",
            str(tmp_path / "cpt.ckpt"), "--sentiment_detector_json",
            str(tmp_path / "senti.json"), "--beam_size", "2",
            "--max_seq_len", "8", "--num_concepts", "3", "--device", "cpu",
            "--max_wait_ms", "5", "--warm", "--mesh_shape", "[2]"]


def test_serve_cli_two_processes(settings, tmp_path):
    """``serve --mesh_shape [2]`` over two processes: process 0's
    ``ServeApp`` answers feature requests exactly as the one-process
    ``[2]`` app does, its encode stage local (no mesh, the one-device
    ladder); the follower runs ``main``'s follower branch, prints the JAX
    package's two lines and returns after process 0's close; only process
    0 warms, and the follower runs every stripe process 0 runs."""
    argv = _serve_tree(tmp_path, settings)
    g = np.random.default_rng(5)
    payloads = {f"{i}_{s}": {
        "fc": g.normal(size=(settings.fc_feat_dim,)).tolist(),
        "att": g.normal(size=(14, 14, settings.att_feat_dim)).tolist(),
        "sentiment": s} for i, s in enumerate(["auto", "negative", "auto",
                                                "positive"])}
    p0, f = run_ranks(multihost_serve, 2, tmp_path, argv, payloads)
    app = tserve.ServeApp(tserve.build_parser().parse_args(argv))
    try:
        want = {k: app.handle_caption(p) for k, p in payloads.items()}
    finally:
        app.close()
    assert p0["answers"] == want
    assert p0["buckets"] == default_buckets(tmesh.ProcessMesh(
        tmesh.DeviceMesh(["cpu"]), 0, 2)) == (2, 8, 32, 128, 384)
    assert p0["enc_buckets"] == (1, 4, 16, 32) and p0["enc_mesh"] is None
    assert not p0["is_follower"]
    assert p0["warms"] == 1 and f["warms"] == 0
    assert f["stripes"] == p0["stripes"] >= 5 + len(payloads)
    assert f["stdout"].splitlines() == ["follower 1/2: mirroring process 0",
                                        "follower done"]


def test_ladders_round_to_the_devices_of_every_process(settings, models):
    """Under a ``ProcessMesh`` the buckets are multiples of n, all the
    devices of every process: the default ladder rounds to n, and an
    explicit ladder that only this process's devices divide is refused
    with the one-process message (nothing is sent: the check comes
    first)."""
    _, (tc, td) = models
    with tmesh.DeviceMesh(["cpu"] * 2) as local:
        pm = tmesh.ProcessMesh(local, 0, 2)
        assert pm.size == 4 and pm.devices == (torch.device("cpu"),) * 2
        assert default_buckets(pm) == (4, 8, 32, 128, 384)
        for ladder in [(2,), (4, 6)]:
            with pytest.raises(ValueError, match=r"not multiples of the mesh "
                               r"data axis \(4\)"):
                DynamicBatcher(tc, td, settings=port_settings(settings),
                               ids=TIDS, bucket_sizes=ladder, device="cpu",
                               mesh=pm)


def test_follower_and_process_0_calls(settings, models, monkeypatch):
    """On a follower ``submit`` and ``warm`` raise; ``follower_loop`` raises
    on process 0 and without a mesh over processes; process 0's first
    ``close()`` sends one STOP and its second none (the sends counted in
    place of the collective)."""
    from insenticap_model_tpu_torch.serving import multihost
    _, (tc, td) = models
    sent = []
    monkeypatch.setattr(multihost, "send_control",
                        lambda b, *ctrl: sent.append(ctrl))

    def batcher(mesh):
        return DynamicBatcher(tc, td, settings=port_settings(settings),
                              ids=TIDS, beam_size=BEAM, max_seq_len=T,
                              bucket_sizes=(2,), num_sentiments=M,
                              device="cpu", mesh=mesh)
    with tmesh.DeviceMesh(["cpu"]) as local:
        follower = batcher(tmesh.ProcessMesh(local, 1, 2))
        fc, att, sentis, _ = _requests(settings, 1)[0]
        with pytest.raises(RuntimeError, match=r"submit\(\) only on "
                           "process 0"):
            follower.submit(fc, att, sentis)
        with pytest.raises(RuntimeError, match=r"warm\(\) only on process"):
            follower.warm()
        follower.close()
        lead = batcher(tmesh.ProcessMesh(local, 0, 2))
        with pytest.raises(RuntimeError, match="follower_loop is for"):
            lead.follower_loop()
        lead.close()
        lead.close()
        assert sent == [(multihost.MP_STOP, 0, False)]
    with tmesh.DeviceMesh(["cpu"]) as m, batcher(m) as one:
        with pytest.raises(RuntimeError, match="follower_loop is for"):
            one.follower_loop()


@pytest.mark.parametrize("case", ["split", "no_mesh", "no_rank",
                                  "reproduce_table", "other_entry",
                                  "cards"])
def test_serving_mesh_refusals(monkeypatch, case):
    """Under a WORLD_SIZE above 1: a mesh that the processes do not divide,
    a missing --mesh_shape and a missing RANK exit with a message before
    any group is joined; ``reproduce_table`` (refused before its load, and
    its ``Runtime(serving=True)``) and any serving entry point but serve
    exit saying that only serve runs a mesh over processes; a process
    that sees too few cards exits naming them."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    if case == "split":
        with pytest.raises(SystemExit, match=r"\[3\] over WORLD_SIZE=2 .* "
                           "split evenly"):
            tcommon.serving_mesh([3], "cpu", processes=True)
    elif case == "no_mesh":
        with pytest.raises(SystemExit, match="no --mesh_shape"):
            tcommon.serving_mesh(None, "cpu", processes=True)
    elif case == "no_rank":
        monkeypatch.delenv("RANK")
        with pytest.raises(SystemExit, match="RANK is unset"):
            tcommon.serving_mesh([2], "cpu", processes=True)
    elif case == "reproduce_table":
        from insenticap_model_tpu_torch.cli import reproduce_table
        only = "only serve runs a mesh over processes"
        with pytest.raises(SystemExit, match=only):
            reproduce_table.reproduce(Opts(device="cpu", mesh_shape=(2,)),
                                      "no-such.ckpt")
        with pytest.raises(SystemExit, match=only):
            tcommon.Runtime(Opts(device="cpu", mesh_shape=(2,)),
                            serving=True)
    elif case == "other_entry":
        with pytest.raises(SystemExit, match="only serve runs a mesh over "
                           "processes"):
            tcommon.serving_mesh([2], "cpu")
    else:
        assert tmesh.local_devices(4, 2, 1, "cpu") == \
            [torch.device("cpu")] * 2
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i: "NVIDIA H100 80GB HBM3")
        with pytest.raises(SystemExit, match=r"LOCAL_RANK 1 drives cuda:2 "
                           r"to cuda:3, and 2 are visible \(cuda:0 NVIDIA "
                           "H100"):
            tmesh.local_devices(4, 2, 1, "cuda")
        assert tmesh.local_devices(4, 2, 0, "cuda") == [
            torch.device("cuda", 0), torch.device("cuda", 1)]
    assert not tmesh.initialized()

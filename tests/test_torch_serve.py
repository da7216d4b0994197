"""The port's serving daemon against the JAX package's on the CPU in f32.

``ServeApp.handle_caption`` of both packages, on the same checkpoints
(written by the JAX package) and the same payloads: feature mode, auto and
forced; image_b64 JPEG and PNG, a CMYK JPEG, an Adam7-interlaced PNG, a
palette GIF, a grey-ramp GIF (PIL's "L") and a palette BMP among them;
image_path. Both use the same substituted
tiny encoder, as the JAX package's own daemon test does (the encoder has
its own parity tests). Captions, sentiments and concepts must be identical
and scores within 1e-4. Then the port's server over a real socket gives
the status codes that the JAX package's daemon tests assert
(``tests/test_cli_stages.py``: 200, 400, 404, 413, /healthz 503 past
--unhealthy_after_s), 200 for a progressive and a CMYK JPEG and an
interlaced PNG, a 400 for an image that its decoders and PIL both refuse
(a 12-bit JPEG), and drains on SIGTERM in a subprocess."""
import base64
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.cli import serve as jserve
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import checkpoint as jck

from insenticap_model_tpu_torch.cli import serve as tserve

from torch_images import make_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = ["positive", "negative", "neutral"]
WORDS = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [f"w{i}" for i in range(24)]
CONCEPTS = WORDS[4:12]
BUCKETS = "[[16,16],[12,16],[16,12]]"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory, settings):
    Image = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("serve")
    comp = {"captioner": jcap.init_params(jax.random.PRNGKey(0), len(WORDS),
                                          3, settings),
            "senti_detector": jsd.init_params(jax.random.PRNGKey(1), 3,
                                              settings)}
    jck.save(str(d / "rl.ckpt"), comp, None, {
        "epoch": 0, "settings": settings.to_dict(), "idx2word": WORDS,
        "sentiment_categories": CATS})
    jck.save(str(d / "cpt.ckpt"),
             jcpt.init_params(jax.random.PRNGKey(2), len(CONCEPTS),
                              settings), None,
             {"epoch": 0, "settings": settings.to_dict(),
              "idx2concept": CONCEPTS})
    (d / "senti.json").write_text(json.dumps(
        {w: [[WORDS[12 + i], 1.0], [WORDS[20 + i], 0.5]]
         for i, w in enumerate(CONCEPTS)}))
    g = np.random.default_rng(11)
    os.makedirs(d / "imgs")
    arr = g.integers(0, 256, size=(20, 18, 3)).astype(np.uint8)
    Image.fromarray(arr).save(d / "imgs" / "ok.png")
    Image.fromarray(arr).save(d / "outside.png")
    y, x = np.mgrid[0:24, 0:31]
    smooth = np.clip(np.stack([x * 8, y * 10, (x + y) * 4], -1)
                     + g.normal(0, 10, (24, 31, 3)), 0, 255).astype(np.uint8)
    Image.fromarray(smooth).save(d / "imgs" / "photo.jpg", quality=85,
                                 subsampling=2)
    Image.fromarray(smooth[::-1]).convert("CMYK").save(
        d / "imgs" / "cmyk.jpg", quality=85)
    (d / "imgs" / "adam7.png").write_bytes(
        make_png(smooth[:, ::-1], 8, 2, interlace=1))
    Image.fromarray(smooth).quantize(64).save(d / "imgs" / "photo.gif")
    Image.fromarray(smooth[:, ::-1]).convert("1").save(d / "imgs" /
                                                       "grey.gif")
    Image.fromarray(smooth[::-1]).quantize(100).save(d / "imgs" /
                                                     "photo.bmp")
    Image.fromarray(np.dstack([smooth[:, ::-1], smooth[:, :, :1]])).save(
        d / "imgs" / "photo.webp", lossless=True, exact=True)
    Image.fromarray(smooth[::-1, ::-1]).save(d / "imgs" / "lossy.webp",
                                             quality=80)
    Image.fromarray(smooth[:, ::-1]).save(
        d / "imgs" / "photo.tif", compression="tiff_adobe_deflate",
        tiffinfo={317: 2})
    Image.fromarray(smooth[:, ::-1]).save(d / "imgs" / "twin.png")
    Image.fromarray(smooth).convert("CMYK").save(
        d / "imgs" / "turned.tif", compression="packbits",
        tiffinfo={274: 6})
    return d


def _fake_numpy(x, s):
    """Deterministic per-row features with the tiny dims, from x / 255."""
    b = x.shape[0]
    base = (np.asarray(x, np.float32) / np.float32(255.0)).reshape(b, -1)
    fc = np.stack([np.resize(base[i], (s.fc_feat_dim,)) for i in range(b)])
    att = np.stack([np.resize(base[i], (14, 14, s.att_feat_dim))
                    for i in range(b)])
    return fc, att


def _args(parser, d, port=0, extra=()):
    return parser.parse_args([
        "--rl_model", str(d / "rl.ckpt"), "--concept_model",
        str(d / "cpt.ckpt"), "--sentiment_detector_json",
        str(d / "senti.json"), "--resnet101_ckpt", "fake.ckpt",
        "--image_root", str(d / "imgs"), "--image_buckets", BUCKETS,
        "--port", str(port), "--bucket_sizes", "[1,2,4]",
        "--enc_bucket_sizes", "[1,2,4]", "--max_wait_ms", "20",
        "--beam_size", "2", "--max_seq_len", "8", "--num_concepts", "3",
        *extra])


@pytest.fixture()
def fakes(monkeypatch, settings):
    def jfake(x):
        fc, att = _fake_numpy(np.asarray(x), settings)
        return jnp.asarray(fc), jnp.asarray(att)

    def tfake(x):
        fc, att = _fake_numpy(x.cpu().numpy(), settings)
        return (torch.from_numpy(fc).to(x.device),
                torch.from_numpy(att).to(x.device))

    monkeypatch.setattr(jserve, "_load_encoder",
                        lambda ck, dt, mesh=None: jfake)
    monkeypatch.setattr(tserve, "_load_encoder",
                        lambda ck, dt, device, mesh=None: tfake)


def _payloads(d, settings):
    g = np.random.default_rng(7)

    def feats(sentiment):
        return {"fc": g.normal(size=(settings.fc_feat_dim,)).tolist(),
                "att": g.normal(size=(14, 14, settings.att_feat_dim)
                                ).tolist(), "sentiment": sentiment}

    def b64(name):
        return base64.b64encode((d / "imgs" / name).read_bytes()).decode()

    return {"fc_auto": feats("auto"), "fc_forced": feats("negative"),
            "jpeg_b64": {"image_b64": b64("photo.jpg"), "sentiment": "auto"},
            "png_b64": {"image_b64": b64("ok.png"),
                        "sentiment": "positive"},
            "cmyk_b64": {"image_b64": b64("cmyk.jpg"), "sentiment": "auto"},
            "adam7_b64": {"image_b64": b64("adam7.png"),
                          "sentiment": "neutral"},
            "gif_b64": {"image_b64": b64("photo.gif"), "sentiment": "auto"},
            "grey_gif_b64": {"image_b64": b64("grey.gif"),
                             "sentiment": "auto"},
            "bmp_b64": {"image_b64": b64("photo.bmp"),
                        "sentiment": "negative"},
            "webp_b64": {"image_b64": b64("photo.webp"), "sentiment": "auto"},
            "webp_path": {"image_path": str(d / "imgs" / "photo.webp")},
            "lossy_webp_b64": {"image_b64": b64("lossy.webp"),
                               "sentiment": "auto"},
            "lossy_webp_path": {"image_path": str(d / "imgs" /
                                                  "lossy.webp")},
            "tiff_b64": {"image_b64": b64("photo.tif"), "sentiment": "auto"},
            "tiff_path": {"image_path": str(d / "imgs" / "photo.tif")},
            "tiff_twin_png": {"image_b64": b64("twin.png"),
                              "sentiment": "auto"},
            "turned_tiff_b64": {"image_b64": b64("turned.tif"),
                                "sentiment": "positive"},
            "turned_tiff_path": {"image_path": str(d / "imgs" /
                                                   "turned.tif"),
                                 "sentiment": "positive"},
            "path": {"image_path": str(d / "imgs" / "photo.jpg")}}


def test_handle_caption_matches_jax(tree, settings, fakes):
    payloads = _payloads(tree, settings)
    japp = jserve.ServeApp(_args(jserve.build_parser(), tree))
    try:
        want = {k: japp.handle_caption(p) for k, p in payloads.items()}
    finally:
        japp.close()
    tapp = tserve.ServeApp(_args(tserve.build_parser(), tree,
                                 extra=["--device", "cpu"]))
    try:
        got = {k: tapp.handle_caption(p) for k, p in payloads.items()}
        stats = tapp.stats()
    finally:
        tapp.close()
    for k in payloads:
        g, w = got[k], want[k]
        assert (g["caption"], g["sentiment"], g["concepts"]) == \
            (w["caption"], w["sentiment"], w["concepts"]), k
        assert abs(g["score"] - w["score"]) <= 1e-4, k
        assert len(set(g["concepts"])) == 3
    assert all(g["caption"] for g in got.values())
    assert got["fc_forced"]["sentiment"] == "negative"
    assert got["png_b64"]["sentiment"] == "positive"
    assert got["jpeg_b64"] == got["path"]      # the same file, two ways
    assert got["webp_b64"] == got["webp_path"]
    assert got["lossy_webp_b64"] == got["lossy_webp_path"]
    # a Deflate TIFF (predictor 2) answers as the PNG of its pixels
    assert got["tiff_b64"] == got["tiff_path"] == got["tiff_twin_png"]
    assert got["turned_tiff_b64"] == got["turned_tiff_path"]
    assert stats["requests"] == len(payloads)
    assert stats["encode"]["by_bucket"]["12x16"] >= 1     # the JPEG


def test_serve_refuses_mesh_and_missing_card(tree, settings, fakes,
                                            monkeypatch):
    """``--mesh_shape``: a 2-D shape exits ("must be 1-D", JAX
    tests/test_cli_stages.py:548), ``[8]`` on the CPU serves in one
    process over 8 slots with the default ladder rounded to
    (8,32,128,384) and answers a feature request over HTTP as the
    one-device server does; a WORLD_SIZE above 1 without RANK exits
    naming multi-host serving (its processes join through env://,
    tests/test_torch_multihost.py); without CUDA the default device still
    refuses."""
    parser = tserve.build_parser()
    base = ["--rl_model", str(tree / "rl.ckpt"), "--concept_model",
            str(tree / "cpt.ckpt"), "--sentiment_detector_json",
            str(tree / "senti.json"), "--beam_size", "2", "--max_seq_len",
            "8", "--num_concepts", "3", "--device", "cpu", "--port", "0",
            "--max_wait_ms", "20"]
    with pytest.raises(SystemExit, match="must be 1-D"):
        tserve.ServeApp(parser.parse_args(base + ["--mesh_shape", "[2,2]"]))
    g = np.random.default_rng(5)
    payload = {"fc": g.normal(size=(settings.fc_feat_dim,)).tolist(),
               "att": g.normal(size=(14, 14, settings.att_feat_dim))
               .tolist(), "sentiment": "auto"}
    answers = {}
    for mesh_args in ([], ["--mesh_shape", "[8]"]):
        srv = tserve.make_server(parser.parse_args(base + mesh_args))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            if mesh_args:
                assert srv.app.batcher._buckets == (8, 32, 128, 384)
                assert srv.app.enc_batcher._batch_buckets == (8, 16, 32)
                assert srv.app.mesh.devices == (torch.device("cpu"),) * 8
            c = http.client.HTTPConnection("127.0.0.1",
                                           srv.server_address[1],
                                           timeout=120)
            c.request("POST", "/caption", json.dumps(payload),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            answers[bool(mesh_args)] = (r.status, json.loads(r.read()))
            c.close()
        finally:
            srv.shutdown()
            srv.app.close()
            srv.server_close()
            th.join(timeout=30)
        assert not th.is_alive()
    assert answers[True][0] == answers[False][0] == 200
    assert answers[True][1] == answers[False][1]
    assert answers[True][1]["caption"]

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="multi-host serving"):
        tserve.ServeApp(parser.parse_args(base + ["--mesh_shape", "[2]"]))
    monkeypatch.delenv("WORLD_SIZE")
    if torch.cuda.is_available():
        return
    a = _args(parser, tree)
    assert a.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.ServeApp(a)


def test_server_status_codes(tree, settings, fakes, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    port = _free_port()
    srv = tserve.make_server(_args(
        tserve.build_parser(), tree, port,
        extra=["--device", "cpu", "--max_body_mb", "0.2"]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        def post(payload, raw=None, path="/caption"):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.request("POST", path, raw or json.dumps(payload),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            body = json.loads(r.read())
            c.close()
            return r.status, body

        def get(path):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            c.request("GET", path)
            r = c.getresponse()
            ctype, body = r.getheader("Content-Type"), r.read()
            c.close()
            return r.status, ctype, body

        small = {"fc": np.zeros(settings.fc_feat_dim).tolist(),
                 "att": np.zeros((14, 14, settings.att_feat_dim)).tolist()}
        ok = base64.b64encode((tree / "imgs" / "ok.png").read_bytes())
        payloads = [{"image_b64": ok.decode(), "sentiment": "positive"},
                    {"image_path": str(tree / "imgs" / "ok.png"),
                     "sentiment": "auto"}]
        out = [None, None]
        ts = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, post(payloads[i])))
            for i in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
            assert not th.is_alive()
        for status, body in out:
            assert status == 200, body
            assert body["caption"] and body["concepts"]
        assert out[0][1]["sentiment"] == "positive"
        assert out[0][1]["concepts"] == out[1][1]["concepts"]

        status, body = post({"att": [[0.0]]})          # no fc
        assert status == 400 and "error" in body
        status, body = post({"image_path": str(tree / "outside.png")})
        assert status == 400 and "outside --image_root" in body["error"]
        status, body = post({"image_path": "/etc/passwd"})
        assert status == 400 and "outside --image_root" in body["error"]
        status, body = post({"image_b64":
                             base64.b64encode(b"nonsense").decode()})
        assert status == 400 and "image_b64" in body["error"]
        # a progressive and a CMYK JPEG and an interlaced PNG: the port
        # decodes them as PIL does
        buf = io.BytesIO()
        Image.fromarray(np.full((16, 16, 3), 90, np.uint8)).save(
            buf, "JPEG", progressive=True)
        for data in (buf.getvalue(), (tree / "imgs" / "cmyk.jpg").read_bytes(),
                     (tree / "imgs" / "adam7.png").read_bytes()):
            status, body = post({"image_b64":
                                 base64.b64encode(data).decode()})
            assert status == 200 and body["caption"] and body["concepts"], \
                body
        # a 12-bit JPEG: the port's decoder refuses it, as PIL does
        data = bytearray(buf.getvalue())
        data[data.index(b"\xff\xc2") + 4] = 12
        status, body = post({"image_b64":
                             base64.b64encode(bytes(data)).decode()})
        assert status == 400 and "image_b64" in body["error"]
        status, body = post(None, raw="x" * 300_000)   # before the read
        assert status == 413
        status, body = post(small, path="/nope")
        assert status == 404

        status, _, body = get("/healthz")
        assert status == 200 and json.loads(body) == {"ok": True}
        status, _, body = get("/stats")
        stats = json.loads(body)
        assert status == 200 and stats["encode"]["requests"] == 5
        status, ctype, body = get("/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert 'isc_stalled_seconds{stage="encode"}' in body.decode()
        status, _, _ = get("/nope")
        assert status == 404

        monkeypatch.setattr(srv.app.batcher, "stalled_for", lambda: 500.0)
        status, _, body = get("/healthz")
        assert status == 503 and json.loads(body) == {"ok": False,
                                                      "stalled_s": 500.0}
        monkeypatch.undo()

        monkeypatch.setattr(srv.app, "image_root", None)
        status, body = post({"image_path": str(tree / "imgs" / "ok.png")})
        assert status == 400 and "disabled" in body["error"]
    finally:
        srv.shutdown()
        srv.app.close()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_sigterm_drains_and_exits(tree):
    """SIGTERM on the real daemon process (feature mode, no encoder): stop
    accepting, drain, exit 0 with the drain markers."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(
        [sys.executable, "-m", "insenticap_model_tpu_torch.cli.serve",
         "--rl_model", str(tree / "rl.ckpt"), "--concept_model",
         str(tree / "cpt.ckpt"), "--sentiment_detector_json",
         str(tree / "senti.json"), "--port", str(port), "--bucket_sizes",
         "[2]", "--beam_size", "2", "--max_seq_len", "8", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 120
        up = False
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    up = r.status == 200
                    break
            except OSError:
                if p.poll() is not None:
                    break
                time.sleep(0.25)
        assert up, f"daemon never came up (rc={p.poll()})"
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=60)
        assert p.returncode == 0, out
        assert "draining" in out and "drained, exiting" in out
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()

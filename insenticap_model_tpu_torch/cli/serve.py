"""Captioning daemon: dynamic-batching HTTP serving of the full inference
DAG on the card.

Counterpart of ``insenticap_model_tpu/cli/serve.py`` (:68-464), with the
same flags, endpoints, status codes and request path:

    python -m insenticap_model_tpu_torch.cli.serve \\
        --rl_model rl.ckpt --concept_model concept.ckpt \\
        [--resnet101_ckpt resnet101.ckpt --image_root /data/imgs] \\
        [--compute_dtype bfloat16] [--port 8500] [--warm] [--device cpu] \\
        [--mesh_shape '[n]']

Endpoints (JSON over HTTP):
  POST /caption   {"fc": [...], "att": [[[...]]],          feature mode
                   "sentiment": "auto"|"positive"|...}
                  {"image_b64": "<base64 image>", ...}     image mode
                                   (JPEG, PNG, GIF, BMP, WebP or TIFF)
                  {"image_path": "/data/imgs/a.jpg", ...}  image mode,
                                   needs --resnet101_ckpt; image_path
                                   additionally needs --image_root
               -> {"caption", "sentiment", "score", "concepts"}
  GET  /stats  -> decode-batcher stats (+"encode": encode-batcher stats)
  GET  /metrics-> the same counters, per-bucket latency quantiles and stall
                  gauges in Prometheus text format
  GET  /healthz-> {"ok": true}; 503 {"ok": false, "stalled_s": N} when a
                  worker thread has been stuck on the device longer than
                  --unhealthy_after_s

Feature mode serves fc/att rows as a feature store holds them; image mode
decodes and resizes on the host (``preprocessing``: the port's own JPEG,
PNG, GIF, BMP, WebP (lossless and lossy) and TIFF (uncompressed,
PackBits, LZW, Deflate and JPEG) decoders and PIL's bilinear resize, no
PIL)
onto the static shape ladder, then rides ``EncodeBatcher`` (ResNet-101 +
concept top-k, batched) into the decode ``DynamicBatcher``. An image the
decoders refuse (12-bit JPEG, CCITT-compressed TIFF, PPM, ...) is a 400,
as any decode failure is in the JAX package.

Request bodies are size-capped (413 past --max_body_mb, before the read);
image_path is disabled unless --image_root is set, and then confined to
that directory, lexically and by realpath.

Added flag: ``--device`` (``cuda`` by default, refused where CUDA is
absent; ``cpu`` runs the plain PyTorch versions). ``--mesh_shape [n]``
serves in this one process on n devices of ``--device`` (``cuda:0`` to
``cuda:n-1``; n slots of the CPU under ``--device cpu``): both batchers
take the mesh, the captioner, the detectors, the concept MLP and the
encoder are replicated, each batch's rows split over the devices, and the
default ladders round up to multiples of n. It exits with a message where
fewer than n cards are visible and for a mesh of more than one axis.

Under a ``WORLD_SIZE`` w above 1 the mesh spans w processes (multi-host
serving), each started as torchrun starts a rank::

    torchrun --nproc_per_node w -m insenticap_model_tpu_torch.cli.serve \\
        --mesh_shape '[n]' ...        # n a multiple of w

Each process joins the gloo group through ``env://`` and drives n / w
devices (``cuda:LOCAL_RANK*(n/w)`` on), the same checkpoints loaded in
every process. Process 0 serves HTTP: its decode batcher batches, and
each dispatch runs in lockstep on every process, each on its stripe of
the batch (``serving/multihost.py``), the ladders rounded to n. The
encode stage stays local to process 0 on its first device, with no mesh
and the one-device encode ladder, since HTTP and image decoding live
there. Only process 0 warms (``--warm``); the followers warm in step. A
follower serves no HTTP: it prints ``follower r/w: mirroring process
0``, mirrors process 0's dispatches until process 0 closes, closes its
encode batcher and its mesh, and prints ``follower done``. SIGTERM or
SIGINT to process 0 drains it as in one process, and its close releases
the followers, so every process exits with 0. Under a ``WORLD_SIZE``
above 1 it exits with a message without a ``--mesh_shape``, without a
``RANK``, and where w does not divide n.
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import preprocessing, serving_daemon
from ..parallel.mesh import ProcessMesh
from ..serving.encode import make_cpt_apply
from ..training import checkpoint as ckpt
from ..utils.dtypes import cast_bf16, resolve_device
from . import common


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--rl_model", type=str, required=True,
                   help="composite RL checkpoint (captioner + detectors)")
    p.add_argument("--concept_model", type=str, required=True)
    p.add_argument("--resnet101_ckpt", type=str, default="",
                   help="converted encoder checkpoint; enables image mode")
    p.add_argument("--image_root", type=str, default="",
                   help="directory that image_path requests are confined "
                        "to (realpath prefix). UNSET = image_path mode "
                        "disabled (clients send image_b64 instead); never "
                        "expose a path-mode daemon on a non-loopback host "
                        "without this")
    p.add_argument("--sentiment_detector_json", type=str,
                   default="./data/corpus/part/sentiment_detector.json")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--max_seq_len", type=int, default=16)
    p.add_argument("--num_concepts", type=int, default=5)
    p.add_argument("--num_sentiments", type=int, default=10)
    p.add_argument("--bucket_sizes", type=str, default="",
                   help="ascending batch-bucket ladder, default "
                        "[1,8,32,128,384] (under --mesh_shape the default "
                        "ladder rounds each bucket up to a multiple of the "
                        "data-axis size; explicit values must already be "
                        "multiples)")
    p.add_argument("--enc_bucket_sizes", type=str, default="",
                   help="encode-stage batch ladder, default [1,4,16,32] "
                        "(under --mesh_shape the default rounds up to "
                        "data-axis multiples; explicit values must "
                        "already be multiples); one XLA compile per "
                        "(resize-shape, batch) pair")
    p.add_argument("--image_buckets", type=str, default="",
                   help="resize-shape ladder for image mode as JSON "
                        "[[h,w],...], default the production "
                        "DEFAULT_BUCKET_SHAPES (must match the ladder the "
                        "feature store was extracted with for "
                        "store-consistent captions)")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--queue_timeout_ms", type=float, default=100.0,
                   help="how long a request waits for queue space when "
                        "the daemon is saturated before it is shed with "
                        "HTTP 503")
    p.add_argument("--unhealthy_after_s", type=float, default=120.0,
                   help="/healthz flips to 503 when a dispatch or "
                        "completion step has been stuck on the device "
                        "longer than this (a dead backend link wedges "
                        "worker threads forever)")
    p.add_argument("--max_body_mb", type=float, default=64.0,
                   help="reject request bodies above this with 413 before "
                        "reading (a full fc+att JSON payload is ~5 MB)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = the measured TPU serving policy; "
                        "also halves request host->device bytes")
    p.add_argument("--mesh_shape", type=str, default="",
                   help="e.g. '[8]': data-parallel serving in this process "
                        "over n devices of --device (each device runs the "
                        "one-device programs on its block of every batch; "
                        "every bucket size must be a multiple of n). Under "
                        "a WORLD_SIZE w above 1 (torchrun) the mesh spans "
                        "the w processes, n / w devices each, process 0 "
                        "serving HTTP and the others mirroring it")
    p.add_argument("--warm", action="store_true",
                   help="pre-compile every bucket before accepting "
                        "traffic (first full-size TPU compile is "
                        "minutes-slow)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu (the plain PyTorch "
                        "versions of every kernel)")
    return p


def _load_encoder(resnet101_ckpt: str, compute_dtype: str, device,
                  mesh=None):
    """Converted-ResNet checkpoint -> the raw-uint8 batch apply (uint8
    [B,H,W,3] on ``device`` -> (fc [B,2048], att [B,14,14,2048])), its
    params held on the device once, cast to bf16 for that policy
    (``EncodeBatcher`` hands results back as f32). Under a ``mesh`` the
    params are replicated (then cast, on each copy) and each call takes
    the copy on its batch's device. A separate function so that tests can
    substitute a settings-matched tiny encoder."""
    from ..models import encoder
    params, _ = ckpt.load(resnet101_ckpt, device=device)
    cast = cast_bf16 if compute_dtype == "bfloat16" else (lambda t: t)
    if mesh is None:
        params = cast(params)
        return lambda x: encoder.forward_raw_batch(params, x)
    reps = mesh.replicate(params).map(cast)
    return lambda x: encoder.forward_raw_batch(reps.on(x.device), x)


class ServeApp:
    """Model state + request handling, independent of the HTTP layer
    (tests drive handle_caption directly or over a real socket)."""

    def __init__(self, a):
        device = resolve_device(a.device)
        self.mesh = mesh = common.serving_mesh(
            json.loads(a.mesh_shape) if a.mesh_shape else None, device,
            processes=True)
        # a mesh over processes: the encode stage stays on process 0's
        # first device, with no mesh (HTTP and image decoding live there)
        multi = isinstance(mesh, ProcessMesh)
        self.is_follower = multi and mesh.rank != 0
        enc_mesh = None if multi else mesh
        if mesh is not None:
            device = mesh.devices[0]
        try:
            batcher, vocab, cats, settings = \
                serving_daemon.make_batcher_from_checkpoint(
                    a.rl_model, beam_size=a.beam_size,
                    max_seq_len=a.max_seq_len,
                    bucket_sizes=(tuple(json.loads(a.bucket_sizes))
                                  if a.bucket_sizes else None),
                    max_wait_s=a.max_wait_ms / 1e3,
                    compute_dtype=a.compute_dtype,
                    num_sentiments=a.num_sentiments, device=device,
                    mesh=mesh)
        except BaseException:
            if mesh is not None:
                mesh.close()
            raise
        self.batcher = batcher
        self.vocab = vocab
        self.cats = list(cats)
        self.settings = settings
        self.num_concepts = a.num_concepts
        self.num_sentiments = a.num_sentiments
        self.queue_timeout_s = a.queue_timeout_ms / 1e3
        self.unhealthy_after_s = a.unhealthy_after_s
        self.image_root = os.path.realpath(a.image_root) \
            if a.image_root else None
        self.image_shapes = (tuple(
            (int(h), int(w)) for h, w in json.loads(a.image_buckets))
            if a.image_buckets else preprocessing.DEFAULT_BUCKET_SHAPES)
        try:
            self.cpt_params, self.idx2concept, _ = \
                common.load_concept_model(a.concept_model, device=device)
            if enc_mesh is not None:
                self.cpt_params = enc_mesh.replicate(self.cpt_params)
            # f32 scoring whatever the serving dtype (the ranking is the
            # product; bf16 fc rows from the encoder cast up in the apply)
            cpt_apply = make_cpt_apply(self.cpt_params, self.num_concepts)
            enc_apply = _load_encoder(a.resnet101_ckpt, a.compute_dtype,
                                      device, enc_mesh) \
                if a.resnet101_ckpt else None
            # the encode batcher exists even without an encoder: feature-
            # mode concept top-k batches through it instead of running bs=1
            self.enc_batcher = serving_daemon.EncodeBatcher(
                enc_apply, cpt_apply, fc_dim=settings.fc_feat_dim,
                shape_buckets=self.image_shapes,
                batch_buckets=(tuple(json.loads(a.enc_bucket_sizes))
                               if a.enc_bucket_sizes
                               else serving_daemon.default_encode_buckets(
                                   enc_mesh)),
                max_wait_s=a.max_wait_ms / 1e3, device=device,
                mesh=enc_mesh)
        except BaseException:
            self.batcher.close()
            if mesh is not None:
                mesh.close()
            raise
        try:
            self.senti_table = common.load_json(a.sentiment_detector_json)
            if a.warm and not self.is_follower:
                self.batcher.warm()     # the followers warm in step
                self.enc_batcher.warm()
        except BaseException:
            self.close()
            raise

    # -- request path -----------------------------------------------------

    def _load_image_u8(self, payload) -> np.ndarray:
        """Decode the request's image to uint8 RGB. image_b64 carries the
        pixels in-band; image_path is confined to --image_root."""
        b64 = payload.get("image_b64")
        if b64 is not None:
            try:
                data = base64.b64decode(b64, validate=True)
                arr = preprocessing.load_image_bytes(data)
            except (ValueError, TypeError):     # binascii.Error included
                raise ValueError("image_b64 did not decode to an image")
            return preprocessing.to_rgb_uint8(arr)
        path = payload.get("image_path")
        if not path:
            raise ValueError("need 'fc'+'att', 'image_b64', or "
                             "'image_path'")
        if self.image_root is None:
            raise ValueError("image_path mode is disabled: start the "
                             "daemon with --image_root, or send "
                             "image_b64")
        # lexical containment first (no filesystem contact for a plainly
        # outside path), then realpath, so that a symlink inside the root
        # cannot escape it; both refusals share one message
        lexical = os.path.abspath(path)
        if lexical != self.image_root and \
                not lexical.startswith(self.image_root + os.sep):
            raise ValueError("image_path outside --image_root")
        real = os.path.realpath(lexical)
        if real != self.image_root and \
                not real.startswith(self.image_root + os.sep):
            raise ValueError("image_path outside --image_root")
        return preprocessing.to_rgb_uint8(preprocessing.load_image(real))

    def handle_caption(self, payload: dict) -> dict:
        timeout = payload.get("timeout", 300.0)
        try:                       # client-supplied: validate and clamp
            timeout = min(max(float(timeout), 0.001), 3600.0)
        except (TypeError, ValueError):
            raise ValueError(f"bad timeout {timeout!r}")
        # one budget across both pipeline stages
        deadline = time.monotonic() + timeout

        if "fc" in payload:
            fc = np.asarray(payload["fc"], np.float32)
            att = np.asarray(payload["att"], np.float32)
            top = self.enc_batcher.submit_fc(
                fc, timeout=timeout, enqueue_timeout=self.queue_timeout_s)
        else:
            # the static shape ladder: any client image size resizes to
            # one of a few bucket shapes
            u8 = self._load_image_u8(payload)
            bucket = preprocessing.bucket_for_shape(
                *u8.shape[:2], self.image_shapes)
            x = preprocessing.resize_to_bucket(u8, bucket)
            fc, att, top = self.enc_batcher.submit_image(
                x, timeout=timeout, enqueue_timeout=self.queue_timeout_s)
        concepts = [self.idx2concept[k] for k in top]
        sentis = common.senti_word_ids(concepts, self.senti_table,
                                       self.vocab, self.num_sentiments)

        want = payload.get("sentiment", "auto")
        forced = serving_daemon.AUTO if want == "auto" \
            else self.cats.index(want)
        seqs, scores, label = self.batcher.submit(
            fc, att, sentis, forced_label=forced,
            timeout=max(0.001, deadline - time.monotonic()),
            enqueue_timeout=self.queue_timeout_s)
        return {"caption": self.vocab.decode_to_text(seqs[0]),
                "sentiment": self.cats[label],
                "score": float(scores[0]),
                "concepts": concepts}

    def stats(self) -> dict:
        out = self.batcher.stats()        # decode stats stay top-level
        out["encode"] = self.enc_batcher.stats()
        return out

    def metrics_text(self) -> str:
        """Prometheus exposition of both batchers (GET /metrics)."""
        return serving_daemon.prometheus_metrics(
            {"decode": self.batcher.stats(),
             "encode": self.enc_batcher.stats()},
            {"decode": self.batcher.stalled_for(),
             "encode": self.enc_batcher.stalled_for()})

    def close(self):
        self.enc_batcher.close()
        self.batcher.close()
        if self.mesh is not None:
            self.mesh.close()


def make_server(a, app=None) -> ThreadingHTTPServer:
    """The HTTP server over ``app`` (a ``ServeApp(a)`` built here by
    default)."""
    app = app or ServeApp(a)
    max_body = int(a.max_body_mb * 1e6)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stalled = max(app.batcher.stalled_for(),
                              app.enc_batcher.stalled_for())
                if stalled >= app.unhealthy_after_s:
                    # a wedged device pins a worker thread: tell the load
                    # balancer to stop routing here
                    self._send(503, {"ok": False,
                                     "stalled_s": round(stalled, 1)})
                else:
                    self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, app.stats())
            elif self.path == "/metrics":
                body = app.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/caption":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body:
                    # refused before the read: one oversized body must not
                    # exhaust the daemon's memory
                    self._send(413, {"error":
                                     f"body {n} B > --max_body_mb "
                                     f"{a.max_body_mb}"})
                    return
                payload = json.loads(self.rfile.read(n) or b"{}")
                self._send(200, app.handle_caption(payload))
            except serving_daemon.Saturated as e:
                self._send(503, {"error": str(e)})     # shed load
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
            except (ValueError, KeyError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:       # keep the daemon alive
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet; /stats has the data
            pass

    try:
        srv = ThreadingHTTPServer((a.host, a.port), Handler)
    except BaseException:
        app.close()
        raise
    srv.app = app  # type: ignore[attr-defined]
    return srv


def main(argv=None):
    import signal
    import threading

    a = build_parser().parse_args(argv)
    app = ServeApp(a)
    if app.is_follower:
        # a mesh over processes: mirror process 0's dispatches until it
        # closes; no HTTP here
        print(f"follower {app.mesh.rank}/{app.mesh.world}: mirroring "
              "process 0", flush=True)
        try:
            app.batcher.follower_loop()
        finally:
            app.close()      # the encode batcher and the mesh
        print("follower done", flush=True)
        return
    srv = make_server(a, app)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(buckets {srv.app.batcher._buckets}, wait {a.max_wait_ms} ms, "
          f"device {a.device}, mesh {srv.app.mesh})", flush=True)

    # graceful drain on SIGTERM/SIGINT: stop accepting, let in-flight
    # handler threads finish against still-live batchers (server_close
    # joins them), then close the batchers. shutdown() must run off the
    # serve_forever thread or it deadlocks.
    def _drain(signum, frame):
        print(f"signal {signum}: draining", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()     # joins in-flight handler threads
        srv.app.close()        # then drains and stops the batchers
    print("drained, exiting", flush=True)


if __name__ == "__main__":
    main()

"""The port's EncodeBatcher (``serving/encode.py``) on the CPU: the JAX
package's EncodeBatcher tests (coalescing, grouping by shape and padding,
validation and the image-mode gate, warm, errors delivered, the stall
watchdog) written against the port with stand-in apply functions; then the
real chain, the port's ResNet-101 and concept detector behind the batcher,
against the JAX package's forward_raw_batch + concept_detector.sample
(features within 1e-5 of scale, identical concept ids)."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import encoder as jenc

from insenticap_model_tpu_torch import serving_daemon
from insenticap_model_tpu_torch.models import encoder as tenc
from insenticap_model_tpu_torch.serving.encode import make_cpt_apply

from torch_parity import encoder_params, to_port


class _FakeEncode:
    """Deterministic stand-in for the encoder: row values depend only on
    the row's pixels, so batching and padding must be invisible. Records
    every batch shape it was called with."""

    def __init__(self, fc_dim=24, att_hw=(7, 7), att_dim=24):
        self.fc_dim, self.att_hw, self.att_dim = fc_dim, att_hw, att_dim
        self.calls = []

    def __call__(self, imgs):
        assert imgs.dtype == torch.uint8 and imgs.device.type == "cpu"
        self.calls.append(tuple(imgs.shape))
        b = imgs.shape[0]
        base = imgs.reshape(b, -1).float().numpy()
        fc = np.stack([np.resize(r, (self.fc_dim,)) for r in base])
        att = np.stack([np.resize(r, self.att_hw + (self.att_dim,))
                        for r in base])
        return torch.from_numpy(fc), torch.from_numpy(att)


class _FakeTopK:
    def __init__(self, k=3):
        self.k = k
        self.calls = []

    def __call__(self, fc):
        self.calls.append(tuple(fc.shape))
        return torch.argsort(-fc.float(), dim=-1, stable=True)[:, :self.k]


SHAPES = ((16, 16), (12, 16), (16, 12))


def _enc_batcher(**kw):
    enc = kw.pop("enc", _FakeEncode())
    cpt = kw.pop("cpt", _FakeTopK())
    kw.setdefault("batch_buckets", (1, 2, 4))
    kw.setdefault("max_wait_s", 0.25)
    b = serving_daemon.EncodeBatcher(enc, cpt, fc_dim=24,
                                     shape_buckets=SHAPES, device="cpu",
                                     **kw)
    return b, enc, cpt


def _run_threads(fns):
    out = [None] * len(fns)
    ts = [threading.Thread(target=lambda i=i, f=f: out.__setitem__(i, f()))
          for i, f in enumerate(fns)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=300)
        assert not th.is_alive()
    return out


def test_encode_batcher_coalesces_and_matches_direct():
    """Concurrent same-shape images ride one batched encoder call, and
    each row's result equals the direct per-row computation."""
    g = np.random.default_rng(0)
    imgs = [g.integers(0, 256, size=(16, 16, 3)).astype(np.uint8)
            for _ in range(4)]
    b, enc, cpt = _enc_batcher()
    try:
        out = _run_threads([lambda i=i: b.submit_image(imgs[i], timeout=300)
                            for i in range(4)])
        direct_enc, direct_cpt = _FakeEncode(), _FakeTopK()
        for i in range(4):
            fc, att, top = out[i]
            assert fc.dtype == att.dtype == np.float32
            fce, atte = direct_enc(torch.from_numpy(imgs[i][None]))
            np.testing.assert_array_equal(fc, fce[0].numpy())
            np.testing.assert_array_equal(att, atte[0].numpy())
            np.testing.assert_array_equal(top, direct_cpt(fce)[0].numpy())
        assert all(s[0] == 4 for s in enc.calls)     # all four coalesced
        st = b.stats()
        assert st["requests"] == 4 and st["by_bucket"]["16x16"] >= 1
        lat = st["latency_by_bucket"]["16x16"]
        assert lat["n"] == 4 and lat["p50_ms"] <= lat["p99_ms"]
    finally:
        b.close()


def test_encode_batcher_groups_by_shape_and_pads():
    """Mixed shapes split into one encoder call per shape, each padded up
    the ladder by repeating a live row; feature-mode rows form their own
    top-k group in the same collect window."""
    g = np.random.default_rng(1)
    img_sq = g.integers(0, 256, size=(16, 16, 3)).astype(np.uint8)
    img_ls = g.integers(0, 256, size=(12, 16, 3)).astype(np.uint8)
    img_ls2 = g.integers(0, 256, size=(12, 16, 3)).astype(np.uint8)
    img_ls3 = g.integers(0, 256, size=(12, 16, 3)).astype(np.uint8)
    fc_row = g.normal(size=(24,)).astype(np.float32)
    b, enc, cpt = _enc_batcher(batch_buckets=(1, 2, 4, 8))  # cap 8 >= 5
    try:
        out = _run_threads([
            lambda: b.submit_image(img_sq, timeout=300),
            lambda: b.submit_image(img_ls, timeout=300),
            lambda: b.submit_image(img_ls2, timeout=300),
            lambda: b.submit_image(img_ls3, timeout=300),
            lambda: b.submit_fc(fc_row, timeout=300)])
        # one call per shape: 1 -> bucket 1, 3 -> bucket 4 (one pad row)
        assert sorted(enc.calls) == [(1, 16, 16, 3), (4, 12, 16, 3)]
        np.testing.assert_array_equal(
            out[4], _FakeTopK()(torch.from_numpy(fc_row[None]))[0].numpy())
        for i, img in ((1, img_ls), (3, img_ls3)):
            fce, _ = _FakeEncode()(torch.from_numpy(img[None]))
            np.testing.assert_array_equal(out[i][0], fce[0].numpy())
        st = b.stats()
        assert st["by_bucket"]["fc"] == 1 and st["by_bucket"]["12x16"] == 1
        assert st["padded_rows"] == 1 and st["requests"] == 5
    finally:
        b.close()


def test_encode_batcher_validates_and_gates_image_mode():
    b, enc, cpt = _enc_batcher()
    try:
        with pytest.raises(ValueError, match="resize bucket"):
            b.submit_image(np.zeros((9, 9, 3), np.uint8))
        with pytest.raises(ValueError, match="resize bucket"):
            b.submit_image(np.zeros((16, 16, 3), np.float32))
        with pytest.raises(ValueError, match="resize bucket"):
            b.submit_image(np.zeros((16, 16, 4), np.uint8))
        with pytest.raises(ValueError, match="fc shape"):
            b.submit_fc(np.zeros((7,), np.float32))
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit_fc(np.zeros((24,), np.float32))
    with pytest.raises(ValueError, match="ascending"):
        serving_daemon.EncodeBatcher(None, _FakeTopK(), fc_dim=24,
                                     shape_buckets=SHAPES,
                                     batch_buckets=(4, 2), device="cpu")
    # a feature-only stage: no encoder, image submissions refused
    b2 = serving_daemon.EncodeBatcher(None, _FakeTopK(), fc_dim=24,
                                      shape_buckets=SHAPES, device="cpu")
    try:
        with pytest.raises(ValueError, match="image mode needs"):
            b2.submit_image(np.zeros((16, 16, 3), np.uint8))
        np.testing.assert_array_equal(
            b2.submit_fc(np.zeros((24,), np.float32), timeout=300),
            _FakeTopK()(torch.zeros(1, 24))[0].numpy())
    finally:
        b2.close()


def test_encode_batcher_warm_touches_the_ladder():
    b, enc, cpt = _enc_batcher()
    try:
        b.warm()
        seen = {(s[0], s[1:3]) for s in enc.calls}
        assert seen == {(n, hw) for n in (1, 2, 4) for hw in SHAPES}
        assert {s[0] for s in cpt.calls if s[1] == 24} == {1, 2, 4}
        enc.calls.clear()
        b.warm([2])
        assert {s[0] for s in enc.calls} == {2}
    finally:
        b.close()
    assert serving_daemon.default_encode_buckets() == (1, 4, 16, 32)


def test_encode_batcher_errors_delivered_not_fatal():
    class Boom(_FakeEncode):
        def __call__(self, imgs):
            raise RuntimeError("device on fire")

    b, enc, cpt = _enc_batcher(enc=Boom())
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            b.submit_image(np.zeros((16, 16, 3), np.uint8), timeout=300)
        st = b.stats()
        assert st["failed_requests"] == 1 and st["failed_batches"] == 1
        # the fc path is unaffected (its own group, the same machinery)
        b.submit_fc(np.zeros((24,), np.float32), timeout=300)
    finally:
        b.close()


def test_encode_stall_watchdog():
    """stalled_for() ages while a dispatch step is wedged and drops back
    to 0 once it completes."""
    release = threading.Event()

    class Wedged(_FakeEncode):
        def __call__(self, imgs):
            release.wait(30)
            return super().__call__(imgs)

    b, enc, cpt = _enc_batcher(enc=Wedged())
    try:
        assert b.stalled_for() == 0.0 and b.healthy(0.05)
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "r", b.submit_image(np.zeros((16, 16, 3), np.uint8),
                                timeout=60)))
        th.start()
        deadline = time.monotonic() + 10
        while b.stalled_for() < 0.1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b.stalled_for() >= 0.1 and not b.healthy(0.05)
        release.set()
        th.join(timeout=30)
        assert "r" in out
        assert b.stalled_for() == 0.0
    finally:
        release.set()
        b.close()


# ---------------------------------------------------------------------------
# the real chain against the JAX package
# ---------------------------------------------------------------------------

def test_real_encoder_and_concepts_match_jax_chain(settings):
    jep, tep = encoder_params(1)
    s = dataclasses.replace(settings, fc_feat_dim=2048)
    jcp = jcpt.init_params(jax.random.PRNGKey(4), 40, s)
    tcp = to_port(jcp)
    shapes = ((64, 64), (48, 64))
    g = np.random.default_rng(3)
    imgs = [g.integers(0, 256, size=(*shapes[i % 2], 3)).astype(np.uint8)
            for i in range(5)]
    b = serving_daemon.EncodeBatcher(
        lambda x: tenc.forward_raw_batch(tep, x), make_cpt_apply(tcp, 5),
        fc_dim=2048,
        shape_buckets=shapes, batch_buckets=(1, 2, 4), max_wait_s=0.5,
        device="cpu")
    try:
        out = _run_threads([lambda i=i: b.submit_image(imgs[i], timeout=300)
                            for i in range(5)]
                           + [lambda: b.submit_fc(
                               np.ones(2048, np.float32), timeout=300)])
        st = b.stats()
    finally:
        b.close()
    assert st["requests"] == 6 and st["failed_requests"] == 0
    for shape in shapes:
        rows = [i for i in range(5) if imgs[i].shape[:2] == shape]
        jfc, jatt = jenc.forward_raw_batch(
            jep, jnp.asarray(np.stack([imgs[i] for i in rows])))
        _, jtop, _ = jcpt.sample(jcp, jfc, 5)
        for k, i in enumerate(rows):
            fc, att, top = out[i]
            for got, want in ((fc, jfc[k]), (att, jatt[k])):
                want = np.asarray(want)
                assert np.abs(got - want).max() <= \
                    1e-5 * np.abs(want).max()
            np.testing.assert_array_equal(top, np.asarray(jtop[k]))
    _, jtop1, _ = jcpt.sample(jcp, jnp.ones((1, 2048)), 5)
    np.testing.assert_array_equal(out[5], np.asarray(jtop1[0]))

"""The port's native feature-store gather (``csrc/fstore.cc`` through
``utils/native.FStoreReader``) on the CPU, against three other readers of
the same file: the port's numpy reader (``reader="numpy"``), the JAX
package's ``NativeFeatureStore`` through ``native/build/libfstore.so``
(which the conftest builds) and its numpy fallback. All four agree bit
for bit on ``get`` and ``batch``, fp16 specials included (subnormals,
+-inf, NaN payloads quiet and signalling, -0): every comparison is on
the float32 output's bits."""
import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

from insenticap_model_tpu.data import feature_store as jfs
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.cli import train_xe as ttrain_xe
from insenticap_model_tpu_torch.config import Opts, Settings
from insenticap_model_tpu_torch.data import feature_store as tfs
from insenticap_model_tpu_torch.models import sent_senti_cls as tss
from insenticap_model_tpu_torch.ops import _build
from insenticap_model_tpu_torch.training import checkpoint as tck
from insenticap_model_tpu_torch.utils import native

F16_SPECIALS = np.array([
    0x0000, 0x8000,                  # +0, -0
    0x0001, 0x8001, 0x0200, 0x03FF,  # subnormals
    0x0400, 0x7BFF, 0xFBFF,          # least normal, +-max
    0x7C00, 0xFC00,                  # +-inf
    0x7E00, 0xFE00, 0x7FFF,          # quiet NaNs with payloads
    0x7C01, 0xFD55,                  # signalling NaNs with payloads
    0x3C00, 0xB555], np.uint16).view(np.float16)
F32_SPECIALS = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00800000,
    0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC12345,
    0x7F800001, 0x3F800000], np.uint32).view(np.float32)
N_REC = 11


def _records(dtype, shape, seed=0):
    """N_REC records of ``shape``: normals, and every special value of the
    dtype spread over the records."""
    g = np.random.default_rng(seed)
    n = int(np.prod(shape))
    specials = F16_SPECIALS if dtype == "float16" else F32_SPECIALS
    out = {}
    for i in range(N_REC):
        rec = g.normal(size=n).astype(dtype)
        pos = g.permutation(n)[:min(n, len(specials))]
        rec[pos] = np.roll(specials, i)[:len(pos)]
        out[f"img{i}"] = rec.reshape(shape)
    return out


def _bits(a):
    assert a.dtype == np.float32
    return np.ascontiguousarray(a).view(np.uint32)


def _readers(path, num_threads=8):
    """{name: store} for the four readers of ``path``."""
    j_native = jfs.NativeFeatureStore(path, num_threads=num_threads)
    assert j_native._native is not None, "the JAX library is not built"
    j_numpy = jfs.NativeFeatureStore(path, num_threads=num_threads)
    j_numpy._native = None
    return {"port_native": tfs.NativeFeatureStore(path, num_threads),
            "port_numpy": tfs.NativeFeatureStore(path, reader="numpy"),
            "jax_native": j_native, "jax_numpy": j_numpy}


@pytest.fixture(params=[("float16", (7,)), ("float16", (2, 3, 4)),
                        ("float32", (7,)), ("float32", (2, 3, 4))],
                ids=lambda p: f"{p[0]}-{len(p[1])}d")
def store(request, tmp_path):
    dtype, shape = request.param
    recs = _records(dtype, shape)
    path = str(tmp_path / "s.isc")
    tfs.write_native_store(path, recs.items(), shape, dtype=dtype)
    return path, recs, shape


@pytest.mark.parametrize("fns,threads", [
    (["img3", "img0", "img3", "img10", "img3"], 8),   # duplicates
    (["img5"], 8),                                    # a single record
    (["img1", "img9", "img2"], 16),                   # threads > records
    ([f"img{i}" for i in range(N_REC)][::-1], 1),     # one thread
    ([f"img{i % N_REC}" for i in range(40)], 3)],
    ids=["duplicates", "single", "threads_gt_records", "one_thread",
         "many"])
def test_four_readers_bit_for_bit(store, fns, threads):
    path, recs, shape = store
    readers = _readers(path, threads)
    want = np.stack([np.asarray(recs[fn], np.float32) for fn in fns])
    for name, r in readers.items():
        got = r.batch(fns)
        assert got.shape == (len(fns),) + shape, name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        for fn in set(fns):
            np.testing.assert_array_equal(_bits(r.get(fn)),
                                          _bits(want[fns.index(fn)]),
                                          err_msg=f"{name} get {fn}")


def test_f16_specials_widen_exactly(tmp_path):
    """Every one of the 65,536 fp16 bit patterns widens in the port's
    native reader to numpy's float32 of it, bit for bit."""
    rec = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
        np.float16).reshape(256, 256)
    path = str(tmp_path / "all.isc")
    tfs.write_native_store(path, [("all", rec), ("again", rec[::-1])],
                           (256, 256), dtype="float16")
    got = tfs.NativeFeatureStore(path).batch(["all", "again"])
    np.testing.assert_array_equal(_bits(got[0]),
                                  _bits(rec.astype(np.float32)))
    np.testing.assert_array_equal(_bits(got[1]),
                                  _bits(rec[::-1].astype(np.float32)))


def test_reader_and_out_dtype(store):
    path, recs, shape = store
    s = tfs.open_store(path)
    assert s.reader == "native"
    assert isinstance(s._native, native.FStoreReader) and s._mm is None
    n = tfs.NativeFeatureStore(path, reader="numpy")
    assert n._native is None and n._mm is not None
    with pytest.raises(ValueError, match="reader"):
        tfs.NativeFeatureStore(path, reader="h5")
    with np.errstate(invalid="ignore"):    # signalling NaNs, quieted
        f64 = tfs.NativeFeatureStore(path, out_dtype=np.float64).batch(
            ["img2"])
        np.testing.assert_array_equal(
            f64, n.batch(["img2"]).astype(np.float64))
    assert f64.dtype == np.float64
    assert s.batch([]).shape == (0,) + shape
    s.close()
    s.close()


def test_concurrent_batches_agree(store):
    """``batch`` from 8 Python threads at once on one store: every result
    equals the numpy reader's."""
    path, recs, _ = store
    s = tfs.NativeFeatureStore(path, num_threads=4)
    ref = tfs.NativeFeatureStore(path, reader="numpy")
    g = np.random.default_rng(1)
    jobs = [[f"img{int(i)}" for i in g.integers(0, N_REC, int(k))]
            for k in g.integers(1, 30, 64)]
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(s.batch, jobs))
    for fns, a in zip(jobs, got):
        np.testing.assert_array_equal(_bits(a), _bits(ref.batch(fns)))


def test_unknown_name_raises_key_error(store):
    path, _, _ = store
    for reader in ("native", "numpy"):
        s = tfs.NativeFeatureStore(path, reader=reader)
        with pytest.raises(KeyError):
            s.get("nope.jpg")
        with pytest.raises(KeyError):
            s.batch(["img0", "nope.jpg"])


def test_truncated_store_raises_ioerror(store):
    """A store whose data region was cut short: the native reader raises
    IOError for a record it cannot read whole, and still reads the
    records before the cut."""
    path, recs, shape = store
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)
    s = tfs.NativeFeatureStore(path)
    last = f"img{N_REC - 1}"
    with pytest.raises(IOError):
        s.batch(["img0", last])
    with pytest.raises(IOError):
        s.get(last)
    np.testing.assert_array_equal(
        _bits(s.batch(["img0"])[0]),
        _bits(np.asarray(recs["img0"], np.float32)))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback to numpy: a source that does not compile, or no
    compiler, makes the store raise."""
    path = str(tmp_path / "s.isc")
    tfs.write_native_store(path, _records("float16", (4,)).items(), (4,))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fstore.cc").write_text("this is not C++\n")
    libs = {k: v for k, v in _build._libs.items() if k != "fstore"}
    monkeypatch.setattr(_build, "_libs", libs)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="host library build failed"):
        tfs.NativeFeatureStore(path)

    def no_compiler():
        raise RuntimeError("no host C++ compiler")
    monkeypatch.setattr(_build, "_cxx", no_compiler)
    monkeypatch.setattr(_build, "_host_key", b"")
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tfs.open_store(path)
    assert tfs.NativeFeatureStore(path, reader="numpy").get("img0").shape \
        == (4,)


def test_fstore_library_interface():
    """Every entry point returns an int (``_build.load_host``'s
    contract); a bad handle is refused, closing one twice is harmless."""
    lib = native._lib()
    for fn in native._SIGS:
        assert getattr(lib, fn).restype is _build.ctypes.c_int
    out = np.empty(4, np.float32)
    idx = np.zeros(1, np.int64)
    assert lib.fstore_gather(10 ** 9, idx.ctypes.data, 1, out.ctypes.data,
                             0, 1) == -1
    assert lib.fstore_close(10 ** 9) == 0
    with pytest.raises(OSError):
        native.FStoreReader("/nonexistent/store.isc", 0, np.float16, 4)


def test_train_xe_same_outputs_with_either_reader(tmp_path, monkeypatch):
    """The port's XE stage on the tiny tree, its stores rewritten in fp16
    (the widening path), once through the native reader (``open_store``)
    and once through the numpy reader: the same losses, captions and
    params."""
    settings = Settings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                        feat_emb_dim=16, rnn_hid_dim=16, att_hid_dim=16,
                        concept_mid_dim=24)
    root = tmp_path / "tree"
    synthetic.build_tree(str(root), settings, seed=0)
    synthetic.write_det_concepts(str(root))
    coco = root / "data/features/coco"
    for kind in ("fc", "att"):
        p = str(coco / f"coco_{kind}.isc")
        src = tfs.NativeFeatureStore(p, reader="numpy")
        recs = [(fn, src.get(fn)) for fn in src.keys()]
        tfs.write_native_store(p, recs, src.shape, dtype="float16")
    idx2word = json.loads(
        (root / "data/captions/coco/part/idx2word.json").read_text())
    cls = tss.init_params(torch.Generator().manual_seed(1), len(idx2word),
                          3, settings, device="cpu")
    meta = {"settings": settings.to_dict(), "idx2word": idx2word,
            "sentiment_categories": ["positive", "negative", "neutral"],
            "dataset_name": "coco", "corpus_type": "part"}
    gathers = []
    real_gather = native.FStoreReader.gather

    def counting_gather(self, idxs):
        gathers.append(len(idxs))
        return real_gather(self, idxs)
    monkeypatch.setattr(native.FStoreReader, "gather", counting_gather)

    def run(who):
        d = root / f"ck_{who}" / "sent_senti_cls" / "coco" / "part"
        d.mkdir(parents=True)
        tck.save(str(d / "model-best.ckpt"), cls, None, meta)
        opt = Opts(settings=settings, num_concepts=3, max_seq_len=8, seed=0,
                   xe_epochs=1, xe_bs=6, beam_size=2, device="cpu",
                   captions_dir=str(root / "data/captions"),
                   feats_dir=str(root / "data/features"),
                   checkpoint=str(root / f"ck_{who}"),
                   result_dir=str(root / f"res_{who}"))
        params = ttrain_xe.train(opt)
        stage = root / f"ck_{who}" / "xe" / "coco" / "part"
        metrics = [json.loads(x) for x in
                   (stage / "metrics.jsonl").read_text().splitlines()]
        res = (root / f"res_{who}" / "xe" / "coco" / "part" /
               "result_0.json").read_text()
        return params, metrics, res

    p_nat, m_nat, r_nat = run("native")
    assert gathers, "the native reader gathered nothing"
    n_native = len(gathers)
    monkeypatch.setattr(tcommon, "open_store",
                        lambda p: tfs.NativeFeatureStore(p, reader="numpy"))
    p_np, m_np, r_np = run("numpy")
    assert len(gathers) == n_native, "the numpy run went through the reader"
    assert m_nat == m_np
    assert r_nat == r_np and json.loads(r_nat)
    for a, b in zip(tnn.tree_leaves(p_nat), tnn.tree_leaves(p_np)):
        assert torch.equal(a, b)

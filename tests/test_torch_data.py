"""The port's data path against the JAX package's on the CPU: collate,
the loaders' batch order, the native feature store read and written both
ways, the synthetic tree, and the CLI runtime's batch placement. All
comparisons are exact."""
import json
import os

import numpy as np
import pytest
import torch

from insenticap_model_tpu import synthetic as jsyn
from insenticap_model_tpu.data import collate as jcol
from insenticap_model_tpu.data import feature_store as jfs
from insenticap_model_tpu.data import loaders as jld
from insenticap_model_tpu_torch import synthetic as tsyn
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.config import Opts
from insenticap_model_tpu_torch.data import collate as tcol
from insenticap_model_tpu_torch.data import feature_store as tfs
from insenticap_model_tpu_torch.data import loaders as tld
from torch_parity import port_settings


def _assert_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _caption_items(n=23, seed=0):
    g = np.random.default_rng(seed)
    items = []
    for i in range(n):
        L = int(g.integers(2, 14))
        cap = [2] + list(map(int, g.integers(4, 30, L))) + [3]
        items.append((f"img{i % 9}", cap,
                      list(map(int, g.integers(4, 30, int(g.integers(
                          1, 8)))))))
    return items


def _stores(seed=0):
    g = np.random.default_rng(seed)
    fc = {f"img{i}": g.normal(size=(6,)).astype(np.float32)
          for i in range(9)}
    att = {f"img{i}": g.normal(size=(2, 2, 6)).astype(np.float32)
           for i in range(9)}
    return fc, att


def _caption_collate(mod, store_mod):
    fc, att = _stores()
    return lambda items: mod.caption_batch(
        items, max_seq_len=8, num_concepts=5, pad_id=0,
        fc_store=store_mod.MemoryFeatureStore(fc),
        att_store=store_mod.MemoryFeatureStore(att))


def test_collate_matches_jax():
    items = _caption_items()
    _assert_batch(_caption_collate(tcol, tfs)(items),
                  _caption_collate(jcol, jfs)(items))
    g = np.random.default_rng(3)
    scs = [([2] + list(map(int, g.integers(4, 30, 12))) + [3],
            [5, 6, 7, 8, 9, 10], [11, 12], int(g.integers(0, 3)))
           for _ in range(7)]
    kw = dict(max_seq_len=8, num_concepts=5, num_sentiments=4, pad_id=0)
    _assert_batch(tcol.scs_batch(scs, **kw), jcol.scs_batch(scs, **kw))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True),
                                               (False, False)])
def test_loader_order_matches_jax(shuffle, drop_last):
    """Three passes, the same batches in the same order (the eval form
    pads its last batch and reports valid)."""
    items = _caption_items()
    tl = tld.Loader(items, 5, _caption_collate(tcol, tfs), shuffle=shuffle,
                    drop_last=drop_last, seed=7)
    jl = jld.Loader(items, 5, _caption_collate(jcol, jfs), shuffle=shuffle,
                    drop_last=drop_last, seed=7)
    assert len(tl) == len(jl)
    for _ in range(3):
        got, want = list(tl), list(jl)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_batch(a, b)
    if not drop_last:
        assert got[-1]["valid"] == len(items) % 5


def test_cycle_iterator_matches_jax_and_skips():
    items = _caption_items(n=17)

    def loaders():
        return (tld.Loader(items, 4, _caption_collate(tcol, tfs), seed=3),
                jld.Loader(items, 4, _caption_collate(jcol, jfs), seed=3))
    tl, jl = loaders()
    tc, jc = tld.CycleIterator(tl), jld.CycleIterator(jl)
    seq = [tc.next() for _ in range(11)]          # almost three passes
    for a in seq:
        _assert_batch(a, jc.next())
    # skip(n) then next() is the (n+1)-th batch, across pass boundaries
    for n in (0, 3, 4, 9):
        skipping = tld.CycleIterator(loaders()[0])
        skipping.skip(n)
        _assert_batch(skipping.next(), seq[n])
    # advance(k) replays k passes' shuffles
    fresh, _ = loaders()
    passes = [list(fresh) for _ in range(3)]
    replay, _ = loaders()
    replay.advance(2)
    for a, b in zip(list(replay), passes[2]):
        _assert_batch(a, b)


def test_device_prefetch_keeps_order():
    out = list(tld.device_prefetch(iter(range(7)), lambda x: x * 2,
                                   depth=3))
    assert out == [0, 2, 4, 6, 8, 10, 12]


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_native_store_both_ways(tmp_path, dtype):
    """A store the JAX package wrote reads exactly here, a store the port
    wrote reads exactly there, and the two files are byte for byte equal."""
    fc, att = _stores(5)
    jpath, tpath = str(tmp_path / "j.isc"), str(tmp_path / "t.isc")
    jfs.write_native_store(jpath, att.items(), (2, 2, 6), dtype=dtype)
    tfs.write_native_store(tpath, att.items(), (2, 2, 6), dtype=dtype)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    fns = ["img3", "img0", "img3", "img8"]
    want = jfs.NativeFeatureStore(jpath, num_threads=0).batch(fns)
    for path in (jpath, tpath):
        got = tfs.open_store(path)
        assert isinstance(got, tfs.NativeFeatureStore)
        np.testing.assert_array_equal(got.batch(fns), want)
        assert got.batch(fns).dtype == np.float32
        np.testing.assert_array_equal(got.get("img8"), want[3])
        assert sorted(got.keys()) == sorted(att)
    np.testing.assert_array_equal(jfs.open_store(tpath).batch(fns), want)


def test_open_store_refuses_hdf5(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "coco_fc.h5")
    with h5py.File(path, "w") as f:
        f["a.jpg"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match=r"HDF5.*\.isc|\.isc.*HDF5"):
        tfs.open_store(path)
    other = tmp_path / "x.bin"
    other.write_bytes(b"not a store at all")
    with pytest.raises(ValueError, match="not a feature store"):
        tfs.open_store(str(other))


def test_synthetic_tree_matches_jax(tmp_path, settings):
    """The same JSON artefacts as the JAX package's build_tree for the
    same seed, and the same feature values (there in HDF5, here .isc)."""
    h5py = pytest.importorskip("h5py")
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jsyn.build_tree(str(jroot), settings, seed=3)
    tsyn.build_tree(str(troot), port_settings(settings), seed=3)
    jsons = sorted(p.relative_to(jroot) for p in jroot.rglob("*.json"))
    assert jsons == sorted(p.relative_to(troot)
                           for p in troot.rglob("*.json"))
    assert len(jsons) == 6
    for rel in jsons:
        assert (jroot / rel).read_bytes() == (troot / rel).read_bytes(), rel
    for sub, stem in (("coco", "coco"), ("sentiment", "feats")):
        for kind in ("fc", "att"):
            d = f"data/features/{sub}"
            with h5py.File(jroot / d / f"{stem}_{kind}.h5", "r") as f:
                store = tfs.open_store(str(troot / d / f"{stem}_{kind}.isc"))
                assert sorted(store.keys()) == sorted(f.keys())
                for fn in f.keys():
                    np.testing.assert_array_equal(store.get(fn),
                                                  np.asarray(f[fn]))
    tsyn.write_det_concepts(str(troot))
    det = json.loads((troot / "data/captions/coco/img_det_concepts.json")
                     .read_text())
    concepts = json.loads((troot / "data/captions/coco/img_concepts.json")
                          .read_text())
    assert det == {fn: w for split in concepts.values()
                   for fn, w in split.items()}


def test_runtime_places_batches_and_refuses_a_mesh():
    opt = Opts(device="cpu", compute_dtype="bfloat16")
    rt = tcommon.Runtime(opt)
    out = rt.put({"fns": ["a"], "valid": np.int64(3),
                  "fc": np.ones((2, 3), np.float32),
                  "caps": np.zeros((2, 4), np.int32)})
    assert set(out) == {"valid", "fc", "caps"}
    assert out["valid"] == 3 and isinstance(out["valid"], int)
    assert out["fc"].dtype == torch.bfloat16
    assert out["caps"].dtype == torch.int32
    cast = rt.cast({"w": torch.ones(2), "i": torch.arange(2)})
    assert cast["w"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int64
    assert tcommon.Runtime(Opts(device="cpu", mesh_shape=(1,))).round_bs(
        6) == 6
    with pytest.raises(SystemExit, match="mesh_shape"):
        tcommon.Runtime(Opts(device="cpu", mesh_shape=(2,)))


def test_feature_paths_prefer_isc(tmp_path):
    opt = Opts(feats_dir=str(tmp_path), device="cpu")
    d = tmp_path / "coco"
    d.mkdir()
    (d / "coco_fc.h5").write_bytes(b"")
    (d / "coco_att.isc").write_bytes(b"")
    (d / "coco_att.h5").write_bytes(b"")
    fc, att = tcommon.feature_paths(opt)
    assert fc.endswith("coco_fc.h5") and att.endswith("coco_att.isc")
    assert os.path.dirname(fc) == str(d)

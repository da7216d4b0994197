"""The port's checkpoint writer on the CPU: ``training.checkpoint.save``
read back by the JAX package's ``checkpoint.load`` and ``load_metadata``
with every leaf identical in value, dtype and shape (f32 and bf16, a
captioner + detector composite, a concept tree, a ResNet-101 tree); a
JAX-written file read by the port and written again by it reads back the
same; the msgpack encoder byte for byte against the ``msgpack`` package and
flax (chunked leaves included); and the refusal of an optimizer state."""
import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu.utils.dtypes import cast_bf16

from insenticap_model_tpu_torch.training import checkpoint as tck
from insenticap_model_tpu_torch.utils import msgpack as tmsgpack
from insenticap_model_tpu_torch.utils.dtypes import cast_bf16 as tcast_bf16

from torch_parity import V, encoder_params, to_port

CATS = ["positive", "negative", "neutral"]
WORDS = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [f"w{i}" for i in range(V - 4)]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


def _assert_identical(got, want):
    """Same leaf paths, dtypes, shapes and bits."""
    a, b = _leaves(got), _leaves(want)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _composite(settings, bf16):
    tree = {"captioner": jcap.init_params(jax.random.PRNGKey(0), V, 3,
                                          settings),
            "senti_detector": jsd.init_params(jax.random.PRNGKey(1), 3,
                                              settings)}
    return cast_bf16(tree) if bf16 else tree


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_composite_read_by_jax(tmp_path, settings, bf16):
    jtree = _composite(settings, bf16)
    meta = {"epoch": 3, "settings": settings.to_dict(), "idx2word": WORDS,
            "sentiment_categories": CATS, "max_seq_len": 8}
    path = str(tmp_path / "rl.ckpt")
    tck.save(path, to_port(jtree), None, meta)
    got, opt, jmeta = jck.load(path, _composite(settings, False))
    assert opt is None and jmeta == meta == jck.load_metadata(path)
    _assert_identical(got, jtree)
    # the JAX package writes the same tree to the same bytes
    other = str(tmp_path / "jax.ckpt")
    jck.save(other, jtree, None, meta)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_concept_tree_read_by_jax(tmp_path, settings, bf16):
    concepts = [f"c{i}" for i in range(7)]
    jtree = jcpt.init_params(jax.random.PRNGKey(2), len(concepts), settings)
    jtree = cast_bf16(jtree) if bf16 else jtree
    path = str(tmp_path / "cpt.ckpt")
    meta = {"epoch": 0, "settings": settings.to_dict(),
            "idx2concept": concepts}
    tck.save(path, to_port(jtree), None, meta)
    got, _, jmeta = jck.load(path, jcpt.init_params(
        jax.random.PRNGKey(9), len(concepts), settings))
    assert jmeta == meta
    _assert_identical(got, jtree)


def test_resnet_tree_read_by_jax(tmp_path):
    """The full-depth encoder tree (lists of blocks) in bf16, as the
    serving smoke run writes it: JAX reads the bf16 rounding of the JAX
    tree, and the port reads back what it wrote."""
    jtree, port = encoder_params(seed=1)
    port16 = tcast_bf16(port)
    path = str(tmp_path / "resnet.ckpt")
    tck.save(path, port16, None, {"epoch": -1})
    got, _, meta = jck.load(path, jtree)
    assert meta == {"epoch": -1}
    _assert_identical(got, cast_bf16(jtree))
    again, _ = tck.load(path, device="cpu")
    flat_a = jax.tree_util.tree_leaves(again)
    flat_b = jax.tree_util.tree_leaves(port16)
    assert len(flat_a) == len(flat_b) > 300
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_jax_file_rewritten_by_port(tmp_path, settings):
    """A JAX-written composite, read by the port and written again by it,
    reads back (by JAX) the same leaves and metadata."""
    jtree = _composite(settings, False)
    meta = {"epoch": 1, "settings": settings.to_dict(), "idx2word": WORDS,
            "sentiment_categories": CATS}
    first = str(tmp_path / "first.ckpt")
    jck.save(first, jtree, None, meta)
    params, pmeta = tck.load(first, device="cpu")
    second = str(tmp_path / "second.ckpt")
    tck.save(second, params, None, pmeta)
    got, _, jmeta = jck.load(second, _composite(settings, False))
    assert jmeta == meta
    _assert_identical(got, jtree)
    again, _ = tck.load(second, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)


def test_opt_state_refused(tmp_path, settings):
    """An optimizer state that is not optax's tree (the JAX package could
    not restore it) is refused, and no file is written."""
    port = to_port(_composite(settings, False))
    with pytest.raises(ValueError, match="optimizer state"):
        tck.save(str(tmp_path / "x.ckpt"), port, {"mu": 1}, {})
    assert not (tmp_path / "x.ckpt").exists()


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32769, -2 ** 31 - 1, -2 ** 63,
    0.5, -1e300, "", "a" * 31, "a" * 32, "é" * 200, "x" * 70000, b"",
    b"x" * 300, b"y" * 70000, [], [1] * 15, [1] * 16, [0] * 70000, {},
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    (1, "a")], ids=lambda o: type(o).__name__)
def test_packb_matches_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    assert tmsgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert tmsgpack.unpackb(tmsgpack.packb(obj), _arrays=False) == (
        list(obj) if isinstance(obj, tuple) else obj)


def test_packb_arrays_match_flax(monkeypatch):
    """Array leaves byte for byte as flax packs them: f32, int, bool, an
    empty shape, bf16 (a tensor against JAX's ml_dtypes array), and a
    leaf over the chunk limit (the limit lowered in both)."""
    import jax.numpy as jnp
    from flax import serialization
    g = np.random.default_rng(0)
    # keys in sorted order: flax's tree_map sorts them
    tree = {"a": g.standard_normal((3, 5)).astype(np.float32),
            "b": {"e": np.zeros((0, 4), np.float32),
                  "i": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "m": np.array([True, False])},
            "big": g.standard_normal(100).astype(np.float32)}
    bf = g.standard_normal(9).astype(np.float32)
    tree["bf"] = np.asarray(jnp.asarray(bf, jnp.bfloat16))
    port = {"a": torch.from_numpy(tree["a"]),
            "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
            "bf": torch.from_numpy(bf).bfloat16(),
            "big": tree["big"]}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 96)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 96)
    blob = tmsgpack.packb(port)
    assert blob == serialization.msgpack_serialize(tree)
    back = tmsgpack.unpackb(blob)
    assert torch.equal(back["big"], torch.from_numpy(tree["big"]))
    assert torch.equal(back["bf"].view(torch.int16),
                       port["bf"].view(torch.int16))


def test_packb_refuses_objects():
    with pytest.raises(TypeError):
        tmsgpack.packb({"x": object()})
    with pytest.raises(TypeError):
        tmsgpack.packb({"x": np.array([object()])})

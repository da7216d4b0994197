"""The PyTorch port's primitives, weight bridge, settings and dtype policy
against the JAX package on the CPU (tolerance 1e-6: the same f32 math in
another summation order), plus the port's independence from JAX and its
refusal to run on a missing card unless asked for the CPU."""
import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import nn as jnn
from insenticap_model_tpu.config import Settings as JSettings

from insenticap_model_tpu_torch import convert
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.config import SENTIMENT_CATEGORIES, Settings
from insenticap_model_tpu_torch.utils.dtypes import cast_bf16, cast_f32

from torch_parity import captioner_params, detector_params, n, t

TOL = dict(rtol=1e-6, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(tree):
    return convert.from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


def test_linear_and_log_softmax():
    g = np.random.default_rng(0)
    p = jnn.linear_init(jax.random.PRNGKey(0), 7, 5)
    x = g.normal(size=(4, 7)).astype(np.float32)
    want = jnn.linear(p, jnp.asarray(x))
    got = tnn.linear(_port(p), t(x))
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(tnn.log_softmax(got)),
                               n(jnn.log_softmax(want)), **TOL)


def test_embed_zeroes_pad_rows():
    p = jnn.embedding_init(jax.random.PRNGKey(1), 9, 4)
    ids = np.array([[0, 3, 8], [5, 0, 0]], np.int32)
    want = jnn.embed(p, jnp.asarray(ids), pad_id=0)
    got = tnn.embed(_port(p), t(ids), pad_id=0)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    assert not n(got)[ids == 0].any()


def test_lstm_cell_gate_order():
    g = np.random.default_rng(2)
    p = jnn.lstm_cell_init(jax.random.PRNGKey(2), 6, 5)
    x, h, c = (g.normal(size=(3, d)).astype(np.float32) for d in (6, 5, 5))
    wh, wc = jnn.lstm_cell(p, jnp.asarray(x), (jnp.asarray(h),
                                               jnp.asarray(c)))
    th, tc = tnn.lstm_cell(_port(p), t(x), (t(h), t(c)))
    np.testing.assert_allclose(n(th), n(wh), **TOL)
    np.testing.assert_allclose(n(tc), n(wc), **TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_conv2d_nhwc_hwio(k):
    g = np.random.default_rng(3)
    p = jnn.conv2d_init(jax.random.PRNGKey(3), 6, 4, k, k)
    x = g.normal(size=(2, 7, 9, 6)).astype(np.float32)
    want = jnn.conv2d(p, jnp.asarray(x), padding="SAME")
    got = tnn.conv2d(_port(p), t(x), padding="SAME")
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=2e-6)


def test_initialisers_are_torch_defaults():
    """Shapes follow the port's layouts; bounds are torch's defaults."""
    gen = torch.Generator().manual_seed(0)
    lin = tnn.linear_init(gen, 64, 8)
    assert lin["weight"].shape == (8, 64)
    assert lin["weight"].abs().max() <= 1 / 8
    emb = tnn.embedding_init(gen, 10, 4, pad_id=0)
    assert not emb["weight"][0].any()
    conv = tnn.conv2d_init(gen, 4, 2, 3, 3)
    assert conv["weight"].shape == (3, 3, 4, 2)
    assert conv["weight"].abs().max() <= 1 / 6
    again = tnn.linear_init(torch.Generator().manual_seed(0), 64, 8)
    assert torch.equal(again["weight"], lin["weight"])


def test_weight_bridge_round_trip(settings):
    """JAX pytree -> port -> JAX pytree is the identity (1e-6; the bridge
    only transposes and renames)."""
    for jp in (captioner_params(settings)[0], detector_params(settings)[0]):
        src = jax.tree_util.tree_map(np.asarray, jp)
        back = convert.to_jax_numpy(convert.from_jax_numpy(src,
                                                           device="cpu"))
        flat_a, tree_a = jax.tree_util.tree_flatten(src)
        flat_b, tree_b = jax.tree_util.tree_flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_allclose(b, a, **TOL)


def test_settings_copy_matches_jax_package():
    assert Settings().to_dict() == JSettings().to_dict()
    assert SENTIMENT_CATEGORIES == ("positive", "negative", "neutral")
    s = Settings.from_dict({"concept_mid_him": 7, "unknown": 1})
    assert s.concept_mid_dim == 7


def test_cast_policy_touches_float_leaves_only():
    tree = {"w": torch.ones(2), "ids": torch.arange(3),
            "l": [torch.zeros(1, dtype=torch.float64)]}
    b = cast_bf16(tree)
    assert b["w"].dtype == torch.bfloat16 and b["ids"].dtype == torch.int64
    assert b["l"][0].dtype == torch.bfloat16
    f = cast_f32(b)
    assert f["w"].dtype == torch.float32 and f["ids"].dtype == torch.int64


# ---------------------------------------------------------------------------
# Independence and device policy
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(REPO, "insenticap_model_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "profile_torch_serving.py")
    yield os.path.join(REPO, "tools", "profile_torch_encoder.py")
    yield os.path.join(REPO, "tools", "bench_torch_int8.py")
    yield os.path.join(REPO, "tools", "bench_torch_megacell.py")


def test_port_imports_no_jax():
    """No module of the port, not chip_smoke.py and not the port's tools
    (the profilers and the int8 and decode-cell studies) imports jax, flax,
    msgpack (the card's machine has none: the port decodes checkpoints
    itself), PIL or h5py (neither is there either) or the JAX package (the
    port keeps its own copies)."""
    banned = ("jax", "flax", "msgpack", "PIL", "h5py",
              "insenticap_model_tpu")
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in banned:
                    offenders.append(f"{path}:{node.lineno} {name}")
    assert not offenders, offenders


def test_entry_points_refuse_a_missing_card(monkeypatch, settings, vocab,
                                            tmp_path):
    """Entry points default to CUDA and raise when it is absent; the CPU
    is used only when the caller asks for it."""
    from insenticap_model_tpu.models import concept_detector as jcpt
    from insenticap_model_tpu.training import checkpoint as jck
    from insenticap_model_tpu_torch.cli.common import load_concept_model
    from insenticap_model_tpu_torch.models import captioner as tcap
    from insenticap_model_tpu_torch.models import concept_detector as tcpt
    from insenticap_model_tpu_torch.models import encoder as tenc
    from insenticap_model_tpu_torch.models import sentiment_detector as tsd
    from insenticap_model_tpu_torch.serving_daemon import (
        DynamicBatcher, EncodeBatcher, make_batcher_from_checkpoint)
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from torch_parity import TIDS, captioner_params, port_settings

    path = str(tmp_path / "model.ckpt")
    jp, _ = captioner_params(settings)
    jck.save(path, {"captioner": jp}, None, {
        "settings": settings.to_dict(), "idx2word": vocab.idx2word,
        "sentiment_categories": ["positive", "negative", "neutral"]})
    cpath = str(tmp_path / "concept.ckpt")
    jck.save(cpath, jcpt.init_params(jax.random.PRNGKey(0), 6, settings),
             None, {"settings": settings.to_dict(),
                    "idx2concept": [f"c{i}" for i in range(6)]})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = port_settings(settings)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcap.init_params(gen, 24, 3, s)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsd.init_params(gen, 3, s)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_jax_numpy({"w": np.ones((2, 2), np.float32),
                                "b": np.ones(2, np.float32)})
    cp = tcap.init_params(gen, 24, 3, s, device="cpu")
    dp = tsd.init_params(gen, 3, s, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DynamicBatcher(cp, dp, settings=s, ids=TIDS)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batcher_from_checkpoint(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.init_params(gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.convert_torch_state_dict({})
    with pytest.raises(RuntimeError, match="CUDA"):
        tcpt.init_params(gen, 6, s)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_concept_model(cpath)
    with pytest.raises(RuntimeError, match="CUDA"):
        EncodeBatcher(None, lambda fc: fc, fc_dim=4, shape_buckets=())
    assert cp["classifier"]["weight"].device.type == "cpu"
    assert tck.load(path, device="cpu")[0]["captioner"]["classifier"][
        "weight"].device.type == "cpu"
    assert load_concept_model(cpath, device="cpu")[0]["fc3"][
        "weight"].device.type == "cpu"

"""The port's concept detector (serving parts) and the concepts ->
sentiment-word step against the JAX package on the CPU: the same top-k
indices, scores within 1e-6 (f32 MLP, sums in another order), the lower
index first where sigmoid scores tie at exactly 1.0, and identical id rows
from ``senti_word_ids`` where summed word scores tie."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.cli import common as jcommon
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.vocab import Vocab as JVocab

from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.models import concept_detector as tcpt
from insenticap_model_tpu_torch.vocab import Vocab

from torch_parity import n, port_settings, t, to_port

C = 40          # concepts
K = 5           # top-k


def _params(settings, seed=0):
    jp = jcpt.init_params(jax.random.PRNGKey(seed), C, settings)
    return jp, to_port(jp)


def test_sample_matches_jax(settings):
    jp, tp = _params(settings)
    g = np.random.default_rng(0)
    fc = g.standard_normal((6, settings.fc_feat_dim)).astype(np.float32)
    js, ji, jt = jcpt.sample(jp, jnp.asarray(fc), K)
    ts, ti, tt = tcpt.sample(tp, t(fc), K)
    np.testing.assert_allclose(n(ts), n(js), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(ti), n(ji))
    np.testing.assert_allclose(n(tt), n(jt), rtol=0, atol=1e-6)
    assert ti.shape == (6, K) and tt.shape == (6, K)


def test_sample_breaks_saturated_ties_to_the_lower_index(settings):
    """fc3's bias lifts six concepts to logits near 40, where the f32
    sigmoid is exactly 1.0: jax.lax.top_k takes the lowest five of them in
    index order, and so must the port."""
    jp, _ = _params(settings, seed=1)
    hot = [30, 7, 12, 3, 25, 18]
    b = np.array(jp["fc3"]["b"])
    b[hot] = 40.0
    jp = dict(jp, fc3=dict(jp["fc3"], b=jnp.asarray(b)))
    tp = to_port(jp)
    fc = np.random.default_rng(2).standard_normal(
        (4, settings.fc_feat_dim)).astype(np.float32)
    js, ji, _ = jcpt.sample(jp, jnp.asarray(fc), K)
    ts, ti, tt = tcpt.sample(tp, t(fc), K)
    assert (n(ts)[:, hot] == 1.0).all() and (n(js)[:, hot] == 1.0).all()
    assert (n(ji) == [3, 7, 12, 18, 25]).all()
    np.testing.assert_array_equal(n(ti), n(ji))
    assert (tt == 1.0).all()


def test_senti_word_ids_match_jax_with_tied_sums():
    words = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [f"s{i}" for i in
                                                    range(12)]
    table = {  # s1 and s3 tie at 0.5, s2 and s5 at 0.25; s99 is not a word
        "dog": [["s1", 0.25], ["s2", 0.25], ["s3", 0.5]],
        "cat": [["s1", 0.25], ["s5", 0.125], ["s99", 0.9]],
        "sky": [["s5", 0.125], ["s7", 0.0625], ["s4", 0.5]],
        "car": [["s6", 0.75]],
    }
    for concepts, m in [(["dog", "cat", "sky"], 5), (["car", "dog"], 3),
                        (["tree"], 4), (["sky", "dog", "cat", "car"], 10)]:
        want = jcommon.senti_word_ids(concepts, table, JVocab(words), m)
        got = tcommon.senti_word_ids(concepts, table, Vocab(words), m)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_forward_runs_in_the_features_dtype(settings):
    """bf16 features on bf16 params score in bf16 (the encode stage casts
    to f32 before it scores; serving/encode.make_cpt_apply)."""
    _, tp = _params(settings)
    bf = {k: {kk: v.bfloat16() for kk, v in p.items()} for k, p in
          tp.items()}
    fc = torch.randn(3, settings.fc_feat_dim)
    assert tcpt.forward(bf, fc.bfloat16()).dtype == torch.bfloat16
    assert tcpt.forward(tp, fc).dtype == torch.float32


def test_init_params_shapes(settings):
    s = port_settings(settings)
    p = tcpt.init_params(torch.Generator().manual_seed(0), C, s,
                         device="cpu")
    jp = jcpt.init_params(jax.random.PRNGKey(0), C, settings)
    for k in ("fc1", "fc2", "fc3"):
        assert tuple(p[k]["weight"].shape) == jp[k]["w"].shape[::-1]
        assert tuple(p[k]["bias"].shape) == jp[k]["b"].shape

"""The port's reward modules against the JAX package's on the CPU: the host
CIDEr-D scorer and reward twins (``rewards/``), the device CIDEr-D
(``ops/ciderd_device.py``) and the device LM reward (``ops/lm_device.py``).

Tolerances: the host scorers are the same float64 Python, held to 1e-12
relative; tables, hashes and canonical sequences exactly (the port keeps
uint32 hashes in int64 tensors); device scores within 1e-6 relative of
the JAX package's device scores (both f32, summed in other orders) and
within rtol 2e-5 of the host scorer (the JAX package's own tolerance,
tests/test_ciderd_device.py); LM scores within 1e-6 relative of JAX's and
the LM reward's signs identical.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.ops import ciderd_device as jcd
from insenticap_model_tpu.ops import lm_device as jlm
from insenticap_model_tpu.rewards import ciderd as jcider
from insenticap_model_tpu.rewards import rewards as jrw
from insenticap_model_tpu_torch.ops import ciderd_device as tcd
from insenticap_model_tpu_torch.ops import lm_device as tlm
from insenticap_model_tpu_torch.rewards import ciderd as tcider
from insenticap_model_tpu_torch.rewards import rewards as trw

SOS, EOS = 2, 3
MAXLEN = 16
NATIVE = os.path.join(os.path.dirname(__file__), "..", "native", "build")


def u32(a):
    """A JAX or numpy uint32 array as int64 numpy (the port's form)."""
    return np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module")
def corpus():
    g = np.random.default_rng(42)
    return {f"img{i}": [
        [SOS] + list(map(int, g.integers(4, 25, size=int(g.integers(3, 20)))))
        + [EOS] for _ in range(int(g.integers(3, 6)))] for i in range(30)}


@pytest.fixture(scope="module")
def scorers(corpus):
    split = {"train": dict(list(corpus.items())[:20]),
             "val": dict(list(corpus.items())[20:])}
    return (jcider.build_scorer(split, SOS, EOS),
            tcider.build_scorer(split, SOS, EOS))


@pytest.fixture(scope="module")
def tables(scorers, corpus):
    order = sorted(corpus)
    truncated = {fn: [c[:MAXLEN + 1] for c in caps]
                 for fn, caps in corpus.items()}
    jt, jrow = jcd.build_tables(scorers[0], truncated, order, MAXLEN, SOS,
                                EOS)
    tt, trow = tcd.build_tables(scorers[1], truncated, order, MAXLEN, SOS,
                                EOS)
    assert jrow == trow
    return jt, tt, trow, order


def _rollouts(g, bs):
    """forward_rl-like output: ids, then EOS and zeros; some rows never
    emit EOS, some emit it first."""
    seq = np.zeros((bs, MAXLEN), np.int32)
    for i in range(bs):
        L = int(g.integers(1, MAXLEN + 1))
        seq[i, :L] = g.integers(4, 25, size=L)
        if L < MAXLEN or g.random() < 0.5:
            if g.random() < 0.8:
                seq[i, L - 1] = EOS
    seq[0] = 0
    seq[0, 0] = EOS
    return seq


def test_host_scorer_matches_jax(scorers, corpus):
    js, ts = scorers
    assert dict(ts.document_frequency) == dict(js.document_frequency)
    assert ts.ref_len == js.ref_len
    g = np.random.default_rng(1)
    gts, res = {}, []
    for i, (fn, caps) in enumerate(corpus.items()):
        gts[fn] = [tcider.seq_from_ids(c, SOS, EOS) for c in caps]
        hyp = [SOS] + list(map(int, g.integers(4, 25, size=9))) + [EOS, 0]
        if i % 4 == 0:
            hyp = caps[0]
        res.append({"image_id": fn,
                    "caption": [tcider.seq_from_ids(hyp, SOS, EOS)]})
    jm, jsc = js.compute_score(gts, res)
    tm, tsc = ts.compute_score(gts, res)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-12, atol=0)
    assert tm == pytest.approx(jm, rel=1e-12)
    assert tsc.max() > 1.0      # the exact matches score high
    for arr in ([SOS, 5, 6, EOS, 0], [5, 6, 7], [SOS, EOS], []):
        assert tcider.seq_from_ids(arr, SOS, EOS) == \
            jcider.seq_from_ids(arr, SOS, EOS)


def test_build_tables_match_jax(tables):
    jt, tt, _, _ = tables
    assert tt._fields == jt._fields
    for name, a, b in zip(jt._fields, jt, tt):
        a = np.asarray(a)
        want = u32(a) if a.dtype == np.uint32 else a
        assert b.numpy().dtype == want.dtype, name
        assert np.array_equal(b.numpy(), want), name
    assert tt.nbytes() == sum(t.numel() * t.element_size() for t in tt)


def test_mul_u32_is_uint32_arithmetic():
    g = np.random.default_rng(0)
    h = np.concatenate([g.integers(0, 2 ** 32, size=1000, dtype=np.uint64)
                        .astype(np.uint32),
                        np.array([0, 1, 2 ** 32 - 1, 2 ** 31], np.uint32)])
    for m in (tcd.M1, tcd.M2):
        with np.errstate(over="ignore"):
            want = (h * m).astype(np.int64)
        got = tcd.mul_u32(torch.from_numpy(h.astype(np.int64)), m)
        assert np.array_equal(got.numpy(), want)


def test_canonicalize_and_hashes_exact():
    g = np.random.default_rng(3)
    seq = _rollouts(g, 24)
    jid, jl = jax.vmap(lambda s: jcd.canonicalize(s, EOS, MAXLEN + 1))(
        jnp.asarray(seq))
    tid, tl = tcd.canonicalize(torch.from_numpy(seq), EOS, MAXLEN + 1)
    assert np.array_equal(tid.numpy(), np.asarray(jid))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert tl.min() == 1 and tl.max() == MAXLEN + 1
    jh = jax.vmap(jcd._ngram_hashes)(jid, jl)
    th = tcd._ngram_hashes(tid, tl)
    for a, b in zip(jh, th):
        a = np.asarray(a)
        assert np.array_equal(b.numpy(), u32(a) if a.dtype == np.uint32
                              else a)


def test_cider_d_matches_jax_and_the_host(scorers, tables, corpus):
    js, _ = scorers
    jt, tt, fn2row, order = tables
    g = np.random.default_rng(7)
    bs = 16
    fns = [order[int(g.integers(0, len(order)))] for _ in range(bs)]
    seq = _rollouts(g, bs)
    # two rows are a reference itself
    for i in (3, 9):
        ref = corpus[fns[i]][0][1:MAXLEN + 1]
        seq[i] = 0
        seq[i, :len(ref)] = ref
    rows = np.asarray([fn2row[fn] for fn in fns], np.int32)
    jid, jl = jax.vmap(lambda s: jcd.canonicalize(s, EOS, MAXLEN + 1))(
        jnp.asarray(seq))
    want = np.asarray(jcd.cider_d(jt, jid, jl, jnp.asarray(rows)))
    tid, tl = tcd.canonicalize(torch.from_numpy(seq), EOS, MAXLEN + 1)
    got = tcd.cider_d(tt, tid, tl, torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    gts = {str(i): [jcider.seq_from_ids(c[:MAXLEN + 1], SOS, EOS)
                    for c in corpus[fn]] for i, fn in enumerate(fns)}
    res = [{"image_id": str(i),
            "caption": [jcider.seq_from_ids(seq[i], SOS, EOS)]}
           for i in range(bs)]
    _, host = js.compute_score(gts, res)
    np.testing.assert_allclose(got, host, rtol=2e-5)
    assert got[3] > 1.0 and got[9] > 1.0


def test_self_critical_reward_matches_jax_and_the_host(scorers, tables,
                                                       corpus):
    _, ts = scorers
    jt, tt, fn2row, order = tables
    g = np.random.default_rng(11)
    bs = 8
    fns = [order[int(g.integers(0, len(order)))] for _ in range(bs)]
    sample, greedy = _rollouts(g, bs), _rollouts(g, bs)
    rows = np.asarray([fn2row[fn] for fn in fns], np.int32)
    want = np.asarray(jcd.self_critical_reward(
        jt, jnp.asarray(sample), jnp.asarray(greedy), jnp.asarray(rows),
        EOS))
    got = tcd.self_critical_reward(tt, torch.from_numpy(sample),
                                   torch.from_numpy(greedy),
                                   torch.from_numpy(rows), EOS).numpy()
    assert got.shape == (bs, MAXLEN)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    gt = {fn: [c[:MAXLEN + 1] for c in corpus[fn]] for fn in fns}
    host = trw.get_self_critical_reward(sample, greedy, fns, gt, SOS, EOS,
                                        ts)
    np.testing.assert_array_equal(host, jrw.get_self_critical_reward(
        sample, greedy, fns, gt, SOS, EOS, scorers[0]))
    np.testing.assert_allclose(got, host, rtol=2e-5, atol=1e-5)
    with pytest.raises(TypeError):
        trw.get_self_critical_reward(sample, greedy, fns, gt, SOS, EOS,
                                     object())


def test_host_reward_twins_match_jax():
    g = np.random.default_rng(5)
    pred = g.integers(0, 3, size=6)
    labels = g.integers(0, 3, size=6)
    w = g.random((6, 5)).astype(np.float32)
    for max_len in (4, 5, 8):
        np.testing.assert_array_equal(
            trw.cls_reward_from_outputs(pred, w, labels, max_len),
            jrw.cls_reward_from_outputs(pred, w, labels, max_len))
    table = {0: {7: 0.5, 9: 1.5}, 1: {8: 2.0}}
    caps = np.array([[7, 4, 9, 7], [8, 8, 5, 0], [7, 8, 9, 5]])
    got = trw.get_senti_words_reward(caps, np.array([0, 1, 2]), table)
    want = jrw.get_senti_words_reward(caps, np.array([0, 1, 2]), table)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# ---------------------------------------------------------------------------
# The LM reward
# ---------------------------------------------------------------------------

V = 40


def _handwritten_arpas(d):
    """Three trigram ARPAs over ids 4..V-1 written by hand: every unigram
    with a backoff, some bigrams (with backoffs) and trigrams, the third
    with an <unk> entry (kenlm's OOV fill) and ids left out."""
    paths = []
    for s in range(3):
        ids = [i for i in range(4, V) if s < 2 or i % 5]
        uni = [f"{-0.5 - 0.03 * ((i * (s + 2)) % 17):.3f} {i} "
               f"{-0.1 - 0.01 * (i % 7):.3f}" for i in ids]
        uni += ["-1.2 </s>", "-99 <s> -0.4"]
        if s == 2:
            uni.append("-2.5 <unk>")
        bi = [f"{-0.2 - 0.01 * k:.3f} {a} {b} -0.05"
              for k, (a, b) in enumerate(zip(ids[::3], ids[1::3]))]
        bi += [f"-0.3 <s> {ids[s]} -0.1", f"-0.25 {ids[1]} </s>"]
        tri = [f"{-0.1 - 0.01 * k:.3f} {a} {b} {c}" for k, (a, b, c) in
               enumerate(zip(ids[::3], ids[1::3], ids[2::3]))]
        tri.append(f"-0.05 <s> {ids[s]} {ids[s + 1]}")
        text = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(bi)}",
                f"ngram 3={len(tri)}", "", "\\1-grams:", *uni, "",
                "\\2-grams:", *bi, "", "\\3-grams:", *tri, "", "\\end\\"]
        p = d / f"hand{s}_id.sri"
        p.write_text("\n".join(text) + "\n")
        paths.append(str(p))
    return paths


def _isclm_arpas(d):
    """Three tiny id-form trigram LMs trained with the repo's isclm, as
    tests/test_lm_device.py trains them (lines of ids, the EOS id
    appended; a band of ids a sentiment)."""
    g = np.random.default_rng(0)
    paths = []
    for s in range(3):
        lines = []
        for _ in range(400):
            ids = list(4 + (s * 12 + g.integers(0, 12, size=int(
                g.integers(3, 9)))) % (V - 4))
            lines.append(" ".join(map(str, ids + [EOS])))
        txt = d / f"s{s}_id.txt"
        txt.write_text("\n".join(lines))
        sri = d / f"s{s}_id.sri"
        subprocess.run([os.path.join(NATIVE, "isclm"), "train", str(txt),
                        str(sri)], check=True)
        paths.append(str(sri))
    return paths


@pytest.fixture(scope="module", params=["handwritten", "isclm"])
def lm_paths(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"lm_{request.param}")
    if request.param == "handwritten":
        return _handwritten_arpas(d)
    if not os.path.exists(os.path.join(NATIVE, "isclm")):
        subprocess.run(["make", "-C", os.path.dirname(NATIVE)],
                       capture_output=True)
    assert os.path.exists(os.path.join(NATIVE, "isclm")), \
        "native/build/isclm could not be built"
    return _isclm_arpas(d)


def _lm_seqs(g, bs, T):
    seqs = g.integers(4, V, size=(bs, T)).astype(np.int32)
    for i in range(0, bs, 3):
        cut = int(g.integers(0, T - 1))
        seqs[i, cut] = EOS
        seqs[i, cut + 1:] = 0
    return seqs


def test_lm_tables_and_scores_match_jax(lm_paths):
    jt = jlm.build_lm_tables(lm_paths, V)
    tt = tlm.build_lm_tables(lm_paths, V)
    assert tt.vocab_size == jt.vocab_size == V
    for name in jt._fields[:-1]:
        a = np.asarray(getattr(jt, name))
        want = u32(a) if a.dtype == np.uint32 else a
        assert np.array_equal(getattr(tt, name).numpy(), want), name
    jhost = [jrw.ArpaTrigramLM(p) for p in lm_paths]
    thost = [trw.ArpaTrigramLM(p) for p in lm_paths]
    for a, b in zip(thost, jhost):
        assert a.lp == b.lp and a.bo == b.bo
    g = np.random.default_rng(1)
    bs, T = 18, 10
    seqs = _lm_seqs(g, bs, T)
    labels = g.integers(0, 3, size=(bs,)).astype(np.int32)
    want = np.asarray(jlm.score_batch(jt, jnp.asarray(seqs),
                                      jnp.asarray(labels), EOS))
    got = tlm.score_batch(tt, torch.from_numpy(seqs),
                          torch.from_numpy(labels), EOS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    host = np.array([thost[labels[i]].score(
        tcider.seq_from_ids(seqs[i], SOS, EOS)) for i in range(bs)])
    np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-4)


def test_lm_reward_signs_match_jax(lm_paths):
    jt = jlm.build_lm_tables(lm_paths, V)
    tt = tlm.build_lm_tables(lm_paths, V)
    g = np.random.default_rng(2)
    bs, T = 16, 8
    sample, greedy = _lm_seqs(g, bs, T), _lm_seqs(g, bs, T)
    greedy[:3] = sample[:3]                  # equal scores: sign 0
    labels = g.integers(0, 3, size=(bs,)).astype(np.int32)
    want = np.asarray(jlm.lm_reward(jt, jnp.asarray(sample),
                                    jnp.asarray(greedy),
                                    jnp.asarray(labels), EOS))
    got = tlm.lm_reward(tt, torch.from_numpy(sample),
                        torch.from_numpy(greedy), torch.from_numpy(labels),
                        EOS).numpy()
    assert got.shape == (bs, T)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got[:, 0])) == {-1.0, 0.0, 1.0}
    host = trw.get_lm_reward(sample, greedy, labels, SOS, EOS,
                             [trw.ArpaTrigramLM(p) for p in lm_paths])
    np.testing.assert_array_equal(got, host)

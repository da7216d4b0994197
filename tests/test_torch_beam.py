"""The port's batched beam search and serving entry points against the JAX
package on the CPU in f32: tokens identical, scores within 1e-4 (sums of
up to 16 f32 log-probs computed in other summation orders), attention
weights within 1e-5, over several seeds, with and without early exit.
An EOS bias on the classifier (the same in both) makes captions end at
varied steps, so the ended-candidate and early-exit paths are exercised."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from insenticap_model_tpu import inference as jinf
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.ops import beam as jbeam

from insenticap_model_tpu_torch import inference as tinf
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.ops import beam as tbeam

from torch_parity import (JIDS, TIDS, captioner_params, detector_params,
                          features, n, port_settings, t)

SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
T = 10
BS = 5


@functools.partial(jax.jit, static_argnames=("settings", "mode",
                                             "early_exit", "B"))
def _jax_search(params, fc, att, sentis, labels, *, settings, mode,
                early_exit, B):
    ctx, _ = jcap.build_visual_context(
        params, fc, att, settings.dropout_p, jax.random.PRNGKey(0), True,
        senti_words=sentis, senti_labels=labels)
    return jbeam.beam_search_batched(params, ctx, settings=settings,
                                     ids=JIDS, beam_size=B, max_seq_len=T,
                                     mode=mode, early_exit=early_exit)


def _inputs(settings, seed, mode):
    fc, att, sentis = features(settings, BS, seed)
    labels = (np.arange(BS) % 3).astype(np.int32)
    if mode == "xe":
        sentis = labels = None
    return fc, att, sentis, labels


def _opt(a, f):
    return None if a is None else f(a)


@pytest.mark.parametrize("mode", ["xe", "rl"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_beam_search_matches_jax(settings, mode, early_exit):
    ps = port_settings(settings)
    ended_early = 0
    for seed in range(3):
        jp, tp = captioner_params(settings, seed=seed, eos_bias=2.0 * seed)
        fc, att, sentis, labels = _inputs(settings, 10 + seed, mode)
        jseqs, jscores = _jax_search(
            jp, jnp.asarray(fc), jnp.asarray(att),
            _opt(sentis, jnp.asarray), _opt(labels, jnp.asarray),
            settings=settings, mode=mode, early_exit=early_exit, B=3)
        ctx = tcap.build_visual_context(tp, t(fc), t(att),
                                        senti_words=_opt(sentis, t),
                                        senti_labels=_opt(labels, t))
        tseqs, tscores = tbeam.beam_search_batched(
            tp, ctx, settings=ps, ids=TIDS, beam_size=3, max_seq_len=T,
            mode=mode, early_exit=early_exit)
        assert n(tseqs).dtype == n(jseqs).dtype == np.int32
        np.testing.assert_array_equal(n(tseqs), n(jseqs), err_msg=str(seed))
        np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)
        ended_early += int((n(tseqs)[:, :, -1] == JIDS.eos).all())
    assert ended_early >= 1     # the EOS-biased seeds end before T


@pytest.mark.parametrize("B", [1, 2, 4, 9])
def test_beam_sizes_match_jax(settings, B):
    ps = port_settings(settings)
    jp, tp = captioner_params(settings, seed=4, eos_bias=2.0)
    fc, att, sentis, labels = _inputs(settings, 20 + B, "rl")
    jseqs, jscores = _jax_search(
        jp, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(sentis),
        jnp.asarray(labels), settings=settings, mode="rl", early_exit=True,
        B=B)
    ctx = tcap.build_visual_context(tp, t(fc), t(att),
                                    senti_words=t(sentis),
                                    senti_labels=t(labels))
    tseqs, tscores = tbeam.beam_search_batched(
        tp, ctx, settings=ps, ids=TIDS, beam_size=B, max_seq_len=T,
        mode="rl")
    np.testing.assert_array_equal(n(tseqs), n(jseqs))
    np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)


def test_beam_semantics(settings):
    """Scores descend; banned ids never appear; the last word is never
    repeated; sequences end in EOS padding once EOS appears."""
    ps = port_settings(settings)
    _, tp = captioner_params(settings, seed=1, eos_bias=3.0)
    fc, att, sentis, labels = _inputs(settings, 30, "rl")
    ctx = tcap.build_visual_context(tp, t(fc), t(att),
                                    senti_words=t(sentis),
                                    senti_labels=t(labels))
    seqs, scores = tbeam.beam_search_batched(
        tp, ctx, settings=ps, ids=TIDS, beam_size=3, max_seq_len=T,
        mode="rl")
    s, sq = n(scores), n(seqs)
    assert (np.diff(s, axis=1) <= 0).all()
    assert not np.isin(sq, [TIDS.pad, TIDS.sos, TIDS.unk]).any()
    for row in sq.reshape(-1, T):
        live = row[:np.argmax(row == TIDS.eos)] if (row == TIDS.eos).any() \
            else row
        assert (np.diff(live) != 0).all()
        if (row == TIDS.eos).any():
            assert (row[np.argmax(row == TIDS.eos):] == TIDS.eos).all()


def test_topk_argmax_first_index_wins_ties():
    import torch
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = tbeam._topk_argmax(x, 4)
    assert i.tolist() == [[1, 2, 4, 3]]
    assert v.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def _serving(settings, seed):
    jcp, tcp = captioner_params(settings, seed=seed, eos_bias=1.5)
    jdp, tdp = detector_params(settings, seed=seed + 1, scale=10.0)
    return (jinf.ServingParams(jcp, jdp), tinf.ServingParams(tcp, tdp))


@pytest.mark.parametrize("threshold", [0.7, 0.0])
def test_detect_and_decode_matches_jax(settings, threshold):
    """Both label regimes: the confidence fallback to neutral (0.7, mixed
    with confident rows) and every row's own argmax (0.0)."""
    ps = port_settings(settings)
    jfn = jax.jit(functools.partial(
        jinf.detect_and_decode, settings=settings, ids=JIDS, beam_size=3,
        max_seq_len=T, senti_threshold=threshold))
    for seed in range(2):
        jparams, tparams = _serving(settings, seed)
        fc, att, sentis = features(settings, BS + 3, 40 + seed)
        att = att - 0.5
        jseqs, jscores, jlab = jfn(jparams, jnp.asarray(fc),
                                   jnp.asarray(att), jnp.asarray(sentis))
        tseqs, tscores, tlab = tinf.detect_and_decode(
            tparams, t(fc), t(att), t(sentis), settings=ps, ids=TIDS,
            beam_size=3, max_seq_len=T, senti_threshold=threshold)
        np.testing.assert_array_equal(n(tlab), n(jlab))
        np.testing.assert_array_equal(n(tseqs), n(jseqs))
        np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)


def test_return_weights_match_jax(settings):
    ps = port_settings(settings)
    jparams, tparams = _serving(settings, 2)
    fc, att, sentis = features(settings, 4, 50)
    jout = jinf.detect_and_decode(
        jparams, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(sentis),
        settings=settings, ids=JIDS, beam_size=3, max_seq_len=6,
        return_weights=True)
    tout = tinf.detect_and_decode(
        tparams, t(fc), t(att), t(sentis), settings=ps, ids=TIDS,
        beam_size=3, max_seq_len=6, return_weights=True)
    np.testing.assert_array_equal(n(tout[0]), n(jout[0]))
    np.testing.assert_allclose(n(tout[1]), n(jout[1]), **SCORE_TOL)
    assert set(tout[3]) == set(jout[3]) == {"cont", "senti", "fuse"}
    for k in jout[3]:
        assert tout[3][k].shape == jout[3][k].shape
        np.testing.assert_allclose(n(tout[3][k]), n(jout[3][k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_decode_xe_and_forced_serving_match_jax(settings):
    ps = port_settings(settings)
    jparams, tparams = _serving(settings, 3)
    fc, att, sentis = features(settings, BS, 60)
    labels = np.array([0, 1, 2, 1, 0], np.int32)
    jx = jinf.decode_xe(jparams.captioner, jnp.asarray(fc),
                        jnp.asarray(att), settings=settings, ids=JIDS,
                        max_seq_len=T)
    tx = tinf.decode_xe(tparams.captioner, t(fc), t(att), settings=ps,
                        ids=TIDS, max_seq_len=T)
    np.testing.assert_array_equal(n(tx[0]), n(jx[0]))
    np.testing.assert_allclose(n(tx[1]), n(jx[1]), **SCORE_TOL)
    jf = jinf.make_forced_serving_fn(settings, JIDS, max_seq_len=T)(
        jparams.captioner, jnp.asarray(fc), jnp.asarray(att),
        jnp.asarray(sentis), jnp.asarray(labels))
    tf = tinf.make_forced_serving_fn(ps, TIDS, max_seq_len=T)(
        tparams.captioner, t(fc), t(att), t(sentis), t(labels))
    np.testing.assert_array_equal(n(tf[0]), n(jf[0]))
    np.testing.assert_allclose(n(tf[1]), n(jf[1]), **SCORE_TOL)
    jd = jinf.make_detect_fn(0.7, 2)(jparams.senti_detector,
                                     jnp.asarray(att - 0.5))
    td = tinf.make_detect_fn(0.7, 2)(tparams.senti_detector, t(att - 0.5))
    np.testing.assert_array_equal(n(td), n(jd))
    ts = tinf.make_serving_fn(ps, TIDS, max_seq_len=T)(
        tparams, t(fc), t(att), t(sentis))
    assert [x.shape for x in ts] == [(BS, 3, T), (BS, 3), (BS,)]

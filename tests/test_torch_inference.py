"""The port's serving entry points of the second slice against the JAX
package on the CPU, f32: the full detector variant selected through
``module_for``, ``sweep_sentiments``, the beam under the two kernel
switches, and the trained checkpoint decoded at full width. Tokens and
labels identical, scores within 1e-4 (sums of up to 16 f32 log-probs in
other summation orders)."""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import inference as jinf
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.models import sentiment_detector_full as jsdf

from insenticap_model_tpu_torch import inference as tinf
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.models import sentiment_detector_full as tsdf
from insenticap_model_tpu_torch.ops import fused_topk
from insenticap_model_tpu_torch.serving_daemon import DynamicBatcher

from torch_parity import (JIDS, TIDS, captioner_params, features, n,
                          port_settings, t, to_port)

SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
T = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "assets", "bench_trained.ckpt")


def _full(settings, k=2, seed=1, scale=20.0):
    """A full-variant Settings and JAX detector params (the cls head
    scaled, its bias zeroed, so that labels vary and some images clear the
    threshold) with their port copy."""
    s = dataclasses.replace(settings, num_kernels_per_sentiment=k)
    p = jsdf.init_params(jax.random.PRNGKey(seed), 3, s)
    p = dict(p, cls={"w": p["cls"]["w"] * scale, "b": p["cls"]["b"] * 0})
    return s, p, to_port(p)


def _spread(att, seed=1):
    """A per-image channel offset, so that images differ after the
    detector's spatial pooling."""
    g = np.random.default_rng(seed)
    off = g.normal(size=(att.shape[0], 1, 1, att.shape[-1])) * 2
    return (att + off).astype(np.float32)


def test_module_for_selects_the_variant(settings):
    s, _, _ = _full(settings)
    assert tsd.module_for(port_settings(settings)) is tsd
    assert tsd.module_for(port_settings(s)) is tsdf
    assert tsd.module_for(None) is tsd


@pytest.mark.parametrize("threshold", [0.7, 0.0])
def test_full_variant_detect_and_decode_matches_jax(settings, threshold):
    """Under num_kernels_per_sentiment > 0 the serving step runs the full
    detector, as the JAX package's does (inference.py:51)."""
    s, jdp, tdp = _full(settings)
    ps = port_settings(s)
    jcp, tcp = captioner_params(s, seed=3, eos_bias=1.5)
    fc, att, sentis = features(s, 8, 80)
    att = _spread(att)
    jfn = jax.jit(functools.partial(
        jinf.detect_and_decode, settings=s, ids=JIDS, beam_size=3,
        max_seq_len=T, senti_threshold=threshold))
    jseqs, jscores, jlab = jfn(jinf.ServingParams(jcp, jdp),
                               jnp.asarray(fc), jnp.asarray(att),
                               jnp.asarray(sentis))
    tseqs, tscores, tlab = tinf.detect_and_decode(
        tinf.ServingParams(tcp, tdp), t(fc), t(att), t(sentis), settings=ps,
        ids=TIDS, beam_size=3, max_seq_len=T, senti_threshold=threshold)
    np.testing.assert_array_equal(n(tlab), n(jlab))
    np.testing.assert_array_equal(n(tseqs), n(jseqs))
    np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)
    assert len(set(n(tlab).tolist())) >= 2


def test_full_variant_forward_matches_jax(settings):
    s, jdp, tdp = _full(settings, k=3)
    _, att, _ = features(s, 5, 81)
    att = _spread(att)
    jdet, jcls, jsp = jsdf.forward_full(jdp, jnp.asarray(att), dropout_p=0.0)
    tdet, tcls, tsp = tsdf.forward_full(tdp, t(att))
    for a, b in ((tdet, jdet), (tcls, jcls), (tsp, jsp)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5)


def test_full_variant_batcher_detects_like_jax(settings):
    """The DynamicBatcher's AUTO rows detect through module_for too."""
    s, jdp, tdp = _full(settings)
    ps = port_settings(s)
    _, tcp = captioner_params(s, seed=4)
    fc, att, sentis = features(s, 5, 82)
    att = _spread(att)
    want = np.asarray(jsdf.sample(jdp, jnp.asarray(att), jinf.SENTI_THRESHOLD,
                                  JIDS.neutral)[0])
    with DynamicBatcher(tcp, tdp, settings=ps, ids=TIDS, max_seq_len=T,
                        num_sentiments=5, bucket_sizes=(8,), max_wait_s=0.2,
                        device="cpu") as b:
        got = [b.submit(fc[i], att[i], sentis[i])[2] for i in range(5)]
    assert got == want.tolist()
    det = tinf.make_detect_fn(0.7, TIDS.neutral, ps)(tdp, t(att))
    np.testing.assert_array_equal(n(det), want)


def test_sweep_sentiments_matches_jax(settings):
    ps = port_settings(settings)
    jcp, tcp = captioner_params(settings, seed=6, eos_bias=1.5)
    fc, att, _ = features(settings, 4, 83)
    g = np.random.default_rng(84)
    by_label = g.integers(4, 24, size=(3, 4, 5)).astype(np.int32)
    jseqs, jscores = jinf.sweep_sentiments(
        jcp, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(by_label),
        settings=settings, ids=JIDS, max_seq_len=T)
    tseqs, tscores = tinf.sweep_sentiments(
        tcp, t(fc), t(att), t(by_label), settings=ps, ids=TIDS,
        max_seq_len=T)
    assert tuple(tseqs.shape) == (3, 4, 3, T)
    np.testing.assert_array_equal(n(tseqs), n(jseqs))
    np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)
    # each label's slice is that label's own forced decode
    serve = tinf.make_forced_serving_fn(ps, TIDS, max_seq_len=T)
    for lab in range(3):
        s1, _ = serve(tcp, t(fc), t(att), t(by_label[lab]),
                      torch.full((4,), lab, dtype=torch.int32))
        np.testing.assert_array_equal(n(tseqs[lab]), n(s1))


def test_beam_with_both_switches_matches_jax_and_default(settings,
                                                         monkeypatch):
    """ISC_FUSED_TOPK=1 and ISC_ATT_KERNEL=v2 on the CPU: the port's beam
    goes through classifier_topk (its plain version here) and stays
    token-identical to the JAX package's beam and to its own default."""
    ps = port_settings(settings)
    from insenticap_model_tpu.ops import beam as jbeam
    from insenticap_model_tpu_torch.models import captioner as tcap
    from insenticap_model_tpu_torch.ops import beam as tbeam
    calls = []
    real = fused_topk.classifier_topk

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    for seed in range(2):
        jp, tp = captioner_params(settings, seed=seed, eos_bias=2.0 * seed)
        fc, att, sentis = features(settings, 5, 85 + seed)
        labels = (np.arange(5) % 3).astype(np.int32)
        for dc in (True, False):
            ctx, _ = jcap.build_visual_context(
                jp, jnp.asarray(fc), jnp.asarray(att), settings.dropout_p,
                jax.random.PRNGKey(0), True, senti_words=jnp.asarray(sentis),
                senti_labels=jnp.asarray(labels))
            jseqs, jscores = jbeam.beam_search_batched(
                jp, ctx, settings=settings, ids=JIDS, beam_size=3,
                max_seq_len=T, mode="rl", decoding_constraint=dc)
            tctx = tcap.build_visual_context(tp, t(fc), t(att),
                                             senti_words=t(sentis),
                                             senti_labels=t(labels))
            kw = dict(settings=ps, ids=TIDS, beam_size=3, max_seq_len=T,
                      mode="rl", decoding_constraint=dc)
            dseqs, dscores = tbeam.beam_search_batched(tp, tctx, **kw)
            with monkeypatch.context() as m:
                m.setenv("ISC_FUSED_TOPK", "1")
                m.setenv("ISC_ATT_KERNEL", "v2")
                m.setattr(fused_topk, "classifier_topk", spy)
                before = len(calls)
                tseqs, tscores = tbeam.beam_search_batched(tp, tctx, **kw)
                assert len(calls) > before
            np.testing.assert_array_equal(n(tseqs), n(jseqs))
            np.testing.assert_array_equal(n(tseqs), n(dseqs))
            np.testing.assert_array_equal(n(tscores), n(dscores))
            np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)


def test_trained_checkpoint_decodes_and_ends_early(monkeypatch):
    """The committed trained captioner (bf16 on disk) decodes in f32 at full
    width on 4 standard-normal feature rows: every caption ends, the loop
    stops before its 16th step, and the tokens equal the JAX package's."""
    from insenticap_model_tpu.training import checkpoint as jck
    from insenticap_model_tpu.utils.dtypes import cast_bf16, cast_f32
    from insenticap_model_tpu_torch.training import checkpoint as tck
    s = JSettings()
    ps = port_settings(s)
    params, meta = tck.load(TRAINED, device="cpu", dtype=torch.float32)
    assert meta["vocab_size"] == 10_000 and set(params) == {"captioner"}
    jdp = jsd.init_params(jax.random.PRNGKey(1), 3, s)
    g = np.random.default_rng(0)
    fc = g.normal(size=(4, s.fc_feat_dim)).astype(np.float32)
    att = g.normal(size=(4, 14, 14, s.att_feat_dim)).astype(np.float32)
    sentis = g.integers(4, 10_000, size=(4, 10)).astype(np.int32)
    steps = []
    real = fused_topk.classifier_topk_plain

    def counting(*a, **kw):
        steps.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(fused_topk, "classifier_topk_plain", counting)
    tseqs, tscores, tlab = tinf.detect_and_decode(
        tinf.ServingParams(params["captioner"], to_port(jdp)), t(fc), t(att),
        t(sentis), settings=ps, ids=TIDS, beam_size=3, max_seq_len=16)
    seqs = n(tseqs)
    first_eos = np.where((seqs == TIDS.eos).any(-1),
                         (seqs == TIDS.eos).argmax(-1), 16)
    assert first_eos.max() < 15 and len(steps) < 16, (first_eos, len(steps))
    assert 5 <= first_eos[:, 0].mean() <= 13

    tmpl = {"captioner": cast_bf16(jcap.init_params(jax.random.PRNGKey(0),
                                                    10_000, 3, s))}
    loaded, _, _ = jck.load(TRAINED, tmpl)
    jcp = cast_f32(jax.tree_util.tree_map(jnp.asarray, loaded["captioner"]))
    jseqs, jscores, jlab = jinf.detect_and_decode(
        jinf.ServingParams(jcp, jdp), jnp.asarray(fc), jnp.asarray(att),
        jnp.asarray(sentis), settings=s, ids=JIDS, beam_size=3,
        max_seq_len=16)
    np.testing.assert_array_equal(n(tlab), n(jlab))
    np.testing.assert_array_equal(seqs, n(jseqs))
    np.testing.assert_allclose(n(tscores), n(jscores), **SCORE_TOL)


def test_forced_rows_skip_detection(settings):
    """A batch of forced rows only: the full-variant batcher never runs its
    detector, and the rows decode under the caller's labels."""
    s, _, tdp = _full(settings)
    _, tcp = captioner_params(s, seed=7)
    fc, att, sentis = features(s, 2, 86)
    with DynamicBatcher(tcp, tdp, settings=port_settings(s), ids=TIDS,
                        max_seq_len=T, num_sentiments=5, bucket_sizes=(2,),
                        max_wait_s=0.2, device="cpu") as b:
        b._detect = None     # any detection would fail
        out = [b.submit(fc[i], att[i], sentis[i], forced_label=i)
               for i in range(2)]
    assert [o[2] for o in out] == [0, 1]
    serve = tinf.make_forced_serving_fn(port_settings(s), TIDS,
                                        max_seq_len=T)
    for i, (seqs, _, _) in enumerate(out):
        want, _ = serve(tcp, t(fc[i:i + 1]), t(att[i:i + 1]),
                        t(sentis[i:i + 1]), torch.tensor([i],
                                                         dtype=torch.int32))
        np.testing.assert_array_equal(seqs, n(want)[0])

"""The captioner's training half in the port against the JAX package on the
CPU, in f32 at the conftest widths: the teacher-forced and rollout
forwards, the criteria, the gradients against ``jax.grad``, dropout's
placement and scale, scheduled sampling and ``decode_greedy``.

Tolerances: forwards, losses and criteria within 1e-5 (relative and
absolute); gradients within 1e-4 relative plus 1e-6 absolute (the two
attention-score biases have a gradient that is zero up to rounding);
tokens identical.

The two packages draw different random streams, so dropout is held by a
test double that replaces ``nn.dropout`` in both with masks made by numpy
from the call's index: the context sites (drawn once a forward) match
call for call. JAX traces its scan body once, so the per-step output
dropout is one traced call there and T calls here: the double leaves
those sites unchanged, and the port's are held by count, placement and
the real dropout's statistics (keep rate, the 1/(1-p) scale).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import inference as jinf
from insenticap_model_tpu import nn as jnn
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu_torch import inference as tinf
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.models import captioner as tcap
from torch_parity import (JIDS, TIDS, V, caption_batches, captioner_params,
                          jax_flat, jax_numpy, n, port_settings, t)

TOL = dict(rtol=1e-5, atol=1e-5)
T = 8


def _inputs(settings, bs=6, seed=0):
    b, scs = caption_batches(settings, bs, seed=seed, maxlen=T)
    labels = np.random.default_rng(seed + 100).integers(
        0, 3, size=(bs,)).astype(np.int32)
    return b, scs, labels


def _xe(jp, tp, settings, b, labels, *, deterministic, ss_prob=0.0,
        gen=None):
    jout = jcap.forward_xe(jp, b["fc"], b["att"], b["cpts"], b["caps"],
                           labels, settings=settings,
                           rng=jax.random.PRNGKey(0), ss_prob=ss_prob,
                           deterministic=deterministic)
    tout = tcap.forward_xe(tp, t(b["fc"]), t(b["att"]), t(b["cpts"]),
                           t(b["caps"]), t(labels),
                           settings=port_settings(settings), gen=gen,
                           ss_prob=ss_prob, deterministic=deterministic)
    return jout, tout


def _assert_xe(jout, tout):
    (jlp, jaux), (tlp, taux) = jout, tout
    assert tuple(tlp.shape) == tuple(jlp.shape)
    np.testing.assert_allclose(n(tlp), np.asarray(jlp), **TOL)
    for k in ("fc_emb", "cpt_feats"):
        np.testing.assert_allclose(n(taux[k]), np.asarray(jaux[k]), **TOL)


def _s2s(jp, tp, settings, scs, *, deterministic, gen=None):
    j = jcap.forward_seq2seq(jp, scs["caps"], scs["cpts"], scs["sentis"],
                             scs["senti_labels"], settings=settings,
                             rng=jax.random.PRNGKey(0),
                             deterministic=deterministic)
    p = tcap.forward_seq2seq(tp, t(scs["caps"]), t(scs["cpts"]),
                             t(scs["sentis"]), t(scs["senti_labels"]),
                             settings=port_settings(settings), gen=gen,
                             deterministic=deterministic)
    return j, p


def _rl(jp, tp, settings, b, scs, *, sample_max, deterministic=True,
        gen=None):
    j = jcap.forward_rl(jp, b["fc"], b["att"], b["cpts"], scs["sentis"],
                        scs["senti_labels"], settings=settings, ids=JIDS,
                        max_seq_len=T, sample_max=sample_max,
                        rng=jax.random.PRNGKey(0),
                        deterministic=deterministic)
    p = tcap.forward_rl(tp, t(b["fc"]), t(b["att"]), t(b["cpts"]),
                        t(scs["sentis"]), t(scs["senti_labels"]),
                        settings=port_settings(settings), ids=TIDS,
                        max_seq_len=T, sample_max=sample_max, gen=gen,
                        deterministic=deterministic)
    return j, p


def _assert_rl(j, p):
    np.testing.assert_array_equal(n(p[0]), np.asarray(j[0]))
    assert p[0].dtype == torch.int32
    np.testing.assert_allclose(n(p[1]), np.asarray(j[1]), **TOL)
    np.testing.assert_array_equal(n(p[2]), np.asarray(j[2]))
    for k in ("fc_emb", "cpt_feats"):
        np.testing.assert_allclose(n(p[3][k]), np.asarray(j[3][k]), **TOL)


# ---------------------------------------------------------------------------
# Forwards in eval mode
# ---------------------------------------------------------------------------

def test_forward_xe_matches_jax(settings):
    jp, tp = captioner_params(settings)
    b, _, labels = _inputs(settings)
    _assert_xe(*_xe(jp, tp, settings, b, labels, deterministic=True))


def test_forward_seq2seq_matches_jax(settings):
    jp, tp = captioner_params(settings)
    _, scs, _ = _inputs(settings, seed=1)
    j, p = _s2s(jp, tp, settings, scs, deterministic=True)
    np.testing.assert_allclose(n(p), np.asarray(j), **TOL)


@pytest.mark.parametrize("eos_bias", [0.0, 3.0])
def test_forward_rl_greedy_matches_jax(settings, eos_bias):
    """Greedy rollout, with and without captions that end early (the
    masks and the pad after EOS)."""
    jp, tp = captioner_params(settings, eos_bias=eos_bias)
    b, scs, _ = _inputs(settings, seed=2)
    j, p = _rl(jp, tp, settings, b, scs, sample_max=True)
    _assert_rl(j, p)
    if eos_bias:
        assert (n(p[2]) == 0).any()


def test_decode_greedy_matches_jax(settings):
    jp, tp = captioner_params(settings, eos_bias=2.0)
    b, scs, _ = _inputs(settings, bs=5, seed=3)
    js, jm = jinf.decode_greedy(jp, b["fc"], b["att"], scs["sentis"][:5],
                                scs["senti_labels"][:5], settings=settings,
                                ids=JIDS, max_seq_len=T)
    ts, tm = tinf.decode_greedy(tp, t(b["fc"]), t(b["att"]),
                                t(scs["sentis"][:5]),
                                t(scs["senti_labels"][:5]),
                                settings=port_settings(settings), ids=TIDS,
                                max_seq_len=T)
    np.testing.assert_array_equal(n(ts), np.asarray(js))
    np.testing.assert_array_equal(n(tm), np.asarray(jm))


def test_eval_context_is_the_deterministic_train_context(settings):
    """The serving entries take the train-mode code with nothing drawn:
    the eval context equals the deterministic train context exactly, and
    an eval decode step equals a deterministic one at dropout 0.5."""
    _, tp = captioner_params(settings)
    b, scs, labels = _inputs(settings, seed=4)
    kw = dict(senti_words=t(scs["sentis"]), senti_labels=t(labels))
    ev = tcap.build_visual_context(tp, t(b["fc"]), t(b["att"]), **kw)
    tr, aux = tcap.build_visual_context_train(tp, t(b["fc"]), t(b["att"]),
                                              0.5, None, True, **kw)
    for a, c in zip(ev, tr):
        assert torch.equal(a, c)
    assert torch.equal(aux["fc_emb"], ev.fc)
    state = tcap.init_state(b["fc"].shape[0], settings.rnn_hid_dim)
    it = t(b["caps"][:, 0])
    lp_eval = tcap.decode_step(tp, ev, state, it, mode="rl")[0]
    lp_det = tcap.decode_step(tp, ev, state, it, mode="rl", dropout_p=0.5,
                              deterministic=True)[0]
    assert torch.equal(lp_eval, lp_det)


# ---------------------------------------------------------------------------
# Criteria and gradients
# ---------------------------------------------------------------------------

def test_criteria_match_jax():
    g = np.random.default_rng(7)
    bs, T_ = 5, 6
    logits = g.normal(size=(bs, T_, V)).astype(np.float32)
    logprobs = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    targets = g.integers(0, V, size=(bs, T_)).astype(np.int32)
    lengths = np.asarray([0, 1, 3, 6, 4], np.int32)
    np.testing.assert_array_equal(
        n(tcap.length_mask(t(lengths), T_)),
        np.asarray(jcap.length_mask(lengths, T_)))
    for fn in ("xe_criterion", "xe_criterion_sums"):
        got = getattr(tcap, fn)(t(logprobs), t(targets), t(lengths))
        want = getattr(jcap, fn)(logprobs, targets, lengths)
        np.testing.assert_allclose(n(torch.stack(got) if isinstance(
            got, tuple) else got), np.asarray(want), **TOL)
    seq_lp = g.normal(size=(bs, T_)).astype(np.float32)
    masks = (g.random((bs, T_)) < 0.7).astype(np.float32)
    rewards = g.normal(size=(bs, 1)).astype(np.float32)
    for fn in ("reward_criterion", "reward_criterion_sums"):
        got = getattr(tcap, fn)(t(seq_lp), t(masks), t(rewards))
        want = getattr(jcap, fn)(seq_lp, masks, rewards)
        np.testing.assert_allclose(n(torch.stack(got) if isinstance(
            got, tuple) else got), np.asarray(want), **TOL)
    a = g.normal(size=(bs, 16)).astype(np.float32)
    c = g.normal(size=(bs, 16)).astype(np.float32)
    rm = np.asarray([1, 1, 0, 1, 0], np.float32)
    np.testing.assert_allclose(
        n(tcap.domain_alignment_loss(t(a), t(c))),
        np.asarray(jcap.domain_alignment_loss(a, c)), **TOL)
    np.testing.assert_allclose(
        n(torch.stack(tcap.domain_alignment_sums(t(a), t(c), t(rm)))),
        np.asarray(jcap.domain_alignment_sums(a, c, rm)), **TOL)


def test_domain_alignment_detaches_the_image_side():
    a = torch.randn(3, 4, requires_grad=True)
    c = torch.randn(3, 4, requires_grad=True)
    tcap.domain_alignment_loss(a, c).backward()
    assert a.grad is not None and c.grad is None


def test_gradients_match_jax_grad(settings):
    """d(xe + da + seq2seq)/d(params), eval-mode forwards, against
    ``jax.grad``."""
    jp, tp = captioner_params(settings)
    b, scs, labels = _inputs(settings, seed=5)

    def jloss(p):
        lp, aux = jcap.forward_xe(p, b["fc"], b["att"], b["cpts"],
                                  b["caps"], labels, settings=settings,
                                  rng=jax.random.PRNGKey(0),
                                  deterministic=True)
        s2s = jcap.forward_seq2seq(p, scs["caps"], scs["cpts"],
                                   scs["sentis"], scs["senti_labels"],
                                   settings=settings,
                                   rng=jax.random.PRNGKey(0),
                                   deterministic=True)
        return (jcap.xe_criterion(lp, b["caps"][:, 1:], b["lengths"])
                + jcap.domain_alignment_loss(aux["cpt_feats"],
                                             aux["fc_emb"])
                + jcap.xe_criterion(s2s, scs["caps"][:, 1:],
                                    scs["lengths"]))
    jg = jax.grad(jloss)(jp)

    tp = tnn.tree_map(lambda x: x.requires_grad_(True), tp)
    ps = port_settings(settings)
    lp, aux = tcap.forward_xe(tp, t(b["fc"]), t(b["att"]), t(b["cpts"]),
                              t(b["caps"]), t(labels), settings=ps,
                              deterministic=True)
    s2s = tcap.forward_seq2seq(tp, t(scs["caps"]), t(scs["cpts"]),
                               t(scs["sentis"]), t(scs["senti_labels"]),
                               settings=ps, deterministic=True)
    loss = (tcap.xe_criterion(lp, t(b["caps"][:, 1:]), t(b["lengths"]))
            + tcap.domain_alignment_loss(aux["cpt_feats"], aux["fc_emb"])
            + tcap.xe_criterion(s2s, t(scs["caps"][:, 1:]),
                                t(scs["lengths"])))
    loss.backward()
    # the fusion gate is not on these paths: no grad here, zeros in JAX
    tg = tnn.tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                      else x.grad, tp)
    got, want = jax_numpy(tg), jax_flat(jg)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, w) in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-6,
                                   err_msg=path)
    # unseen words' embedding rows get exactly zero gradient in both
    seen = set(b["caps"].ravel()) | set(b["cpts"].ravel()) | \
        set(scs["caps"].ravel()) | set(scs["cpts"].ravel()) | \
        set(scs["sentis"].ravel())
    unseen = [i for i in range(V) if i not in seen]
    assert unseen
    emb = dict(got)["['word_embed']['table']"]
    assert not emb[unseen].any()
    assert not np.asarray(jg["word_embed"]["table"])[unseen].any()


# ---------------------------------------------------------------------------
# Dropout and scheduled sampling
# ---------------------------------------------------------------------------

class _NumpyDropout:
    """``nn.dropout`` stand-in: the i-th drawing call (not deterministic,
    rate > 0) with i < ``sites`` gets the mask numpy draws from seed
    1000 + i; later calls (the per-step sites) return x unchanged. Records
    every drawing call's (shape, rate)."""

    def __init__(self, where, sites):
        self.where, self.sites, self.calls = where, sites, []

    def __call__(self, key, x, rate, deterministic):
        if deterministic or rate == 0.0:
            return x
        i = len(self.calls)
        self.calls.append((tuple(x.shape), rate))
        if i >= self.sites:
            return x
        keep = 1.0 - rate
        mask = np.random.default_rng(1000 + i).random(tuple(x.shape)) < keep
        if self.where == "torch":
            return torch.where(torch.from_numpy(mask), x / keep,
                               torch.zeros((), dtype=x.dtype))
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


def _doubles(monkeypatch, sites):
    jd, td = _NumpyDropout("jax", sites), _NumpyDropout("torch", sites)
    monkeypatch.setattr(jnn, "dropout", jd)
    monkeypatch.setattr(tnn, "dropout", td)
    return jd, td


def test_dropout_placement_forward_xe(settings, monkeypatch):
    """fc, att and the label embedding: three context masks in that
    order, then one output dropout a step of [bs, H]."""
    jp, tp = captioner_params(settings)
    b, _, labels = _inputs(settings, seed=6)
    jd, td = _doubles(monkeypatch, sites=3)
    _assert_xe(*_xe(jp, tp, settings, b, labels, deterministic=False))
    bs, H = b["fc"].shape[0], settings.rnn_hid_dim
    assert td.calls[:3] == jd.calls[:3]
    assert [c[0] for c in td.calls[:3]] == [
        (bs, settings.feat_emb_dim), (bs, 9, settings.feat_emb_dim),
        (bs, settings.word_emb_dim)]
    assert td.calls[3:] == [((bs, H), settings.dropout_p)] * T
    assert jd.calls[3:] == [((bs, H), settings.dropout_p)]   # traced once


def test_dropout_placement_forward_seq2seq(settings, monkeypatch):
    jp, tp = captioner_params(settings)
    _, scs, _ = _inputs(settings, seed=7)
    jd, td = _doubles(monkeypatch, sites=3)
    j, p = _s2s(jp, tp, settings, scs, deterministic=False)
    np.testing.assert_allclose(n(p), np.asarray(j), **TOL)
    assert td.calls[:3] == jd.calls[:3] and len(td.calls) == 3 + T


def test_dropout_placement_forward_rl(settings, monkeypatch):
    """fc, att, sentiment words and label: four context masks."""
    jp, tp = captioner_params(settings, eos_bias=1.0)
    b, scs, _ = _inputs(settings, seed=8)
    jd, td = _doubles(monkeypatch, sites=4)
    _assert_rl(*_rl(jp, tp, settings, b, scs, sample_max=True,
                    deterministic=False))
    assert td.calls[:4] == jd.calls[:4] and len(td.calls) == 4 + T


def test_dropout_statistics_match_jax():
    """Keep rate within 0.005 of 1 - p on 200,000 elements, kept values
    exactly x / (1 - p), in both packages; two draws differ."""
    x = np.linspace(0.5, 2.0, 200_000).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for p in (0.5, 0.2):
        tout = tnn.dropout(gen, t(x), p, False).numpy()
        jout = np.asarray(jnn.dropout(jax.random.PRNGKey(0), x, p, False))
        for out in (tout, jout):
            kept = out != 0
            assert abs(kept.mean() - (1 - p)) < 0.005
            np.testing.assert_array_equal(
                out[kept], (x / np.float32(1 - p))[kept])
    again = tnn.dropout(gen, t(x), 0.5, False).numpy()
    assert not np.array_equal(again != 0, tout != 0)
    assert torch.equal(tnn.dropout(None, t(x), 0.5, True), t(x))


def test_step_dropout_draws_a_fresh_mask_each_step(settings, monkeypatch):
    """The port's per-step output dropout (the real one, recorded) masks
    [bs, H] with a new mask at every step and the 1/(1-p) scale."""
    _, tp = captioner_params(settings)
    b, _, labels = _inputs(settings, seed=9)
    real, masks = tnn.dropout, []

    def record(gen, x, rate, deterministic):
        out = real(gen, x, rate, deterministic)
        if x.dim() == 2 and x.shape[1] == settings.rnn_hid_dim:
            masks.append((out != 0).numpy())
            kept = out != 0
            assert torch.allclose(out[kept], (x / (1 - rate))[kept])
        return out
    monkeypatch.setattr(tnn, "dropout", record)
    tcap.forward_xe(tp, t(b["fc"]), t(b["att"]), t(b["cpts"]),
                    t(b["caps"]), t(labels),
                    settings=port_settings(settings),
                    gen=torch.Generator().manual_seed(0),
                    deterministic=False)
    # fc and the label embedding (2-d at these widths too), then the steps
    assert len(masks) == 2 + T
    assert len({m.tobytes() for m in masks[2:]}) == T


def _force_argmax(monkeypatch):
    """Both packages' categorical draws replaced by the argmax."""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw:
                        jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(tcap, "_categorical",
                        lambda gen, logprobs: logprobs.argmax(dim=-1))


def test_scheduled_sampling_matches_jax_with_a_forced_draw(settings,
                                                           monkeypatch):
    """ss_prob = 1 feeds every row the previous step's draw from t = 1 on
    (the ground truth at t = 0); with the draw forced to the argmax both
    packages give the same logprobs, which differ from teacher forcing.
    ss_prob = 0 is teacher forcing in train mode too."""
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    jp, tp = captioner_params(nodrop)
    b, _, labels = _inputs(nodrop, seed=10)
    _force_argmax(monkeypatch)
    jout, tout = _xe(jp, tp, nodrop, b, labels, deterministic=False,
                     ss_prob=1.0, gen=torch.Generator().manual_seed(0))
    _assert_xe(jout, tout)
    teacher = _xe(jp, tp, nodrop, b, labels, deterministic=True)[1][0]
    np.testing.assert_allclose(n(tout[0][:, :1]), n(teacher[:, :1]), **TOL)
    assert not np.allclose(n(tout[0]), n(teacher), atol=1e-3)
    zero = _xe(jp, tp, nodrop, b, labels, deterministic=False, ss_prob=0.0,
               gen=torch.Generator().manual_seed(0))[1][0]
    assert torch.equal(zero, teacher)


def test_scheduled_sampling_rate(settings, monkeypatch):
    """At ss_prob = 0.5 about half the rows take the draw at each step
    (the port's real draws, counted through the embedded input ids)."""
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    _, tp = captioner_params(nodrop)
    b, _, labels = _inputs(nodrop, bs=64, seed=11)
    seen = []
    real = tcap.embed_word

    def spy(params, ids):
        seen.append(ids.clone())
        return real(params, ids)
    monkeypatch.setattr(tcap, "embed_word", spy)
    tcap.forward_xe(tp, t(b["fc"]), t(b["att"]), t(b["cpts"]), t(b["caps"]),
                    t(labels), settings=port_settings(nodrop),
                    gen=torch.Generator().manual_seed(0), ss_prob=0.5,
                    deterministic=False)
    steps = seen[-T:]          # the decode steps' inputs, after the context
    gt = b["caps"]
    assert np.array_equal(steps[0].numpy(), gt[:, 0])
    differ = np.mean([(steps[i].numpy() != gt[:, i]).mean()
                      for i in range(1, T)])
    # a drawn word equals the ground truth with probability about 1/V
    assert 0.35 < differ < 0.6


def test_forward_rl_sampled_matches_jax_with_a_forced_draw(settings,
                                                           monkeypatch):
    """The multinomial branch with the draw forced to the argmax: the
    greedy result, and each token's log-prob gathered."""
    jp, tp = captioner_params(settings, eos_bias=1.5)
    b, scs, _ = _inputs(settings, seed=12)
    _force_argmax(monkeypatch)
    j, p = _rl(jp, tp, settings, b, scs, sample_max=False)
    _assert_rl(j, p)
    greedy = _rl(jp, tp, settings, b, scs, sample_max=True)[1]
    assert torch.equal(p[0], greedy[0])

"""The port's RL train and eval steps against the JAX package's on the CPU,
in f32 at the conftest widths.

The two packages draw different tokens from one distribution
(``jax.random.categorical`` against ``torch.multinomial``), so the tests
force both draws to argmax(logprobs + G), G one fixed Gumbel array from
numpy shared by both (plain argmax would make the sample the greedy
rollout, and the CIDEr-D advantage zero); dropout is 0 and the two
scheduled-sampling probabilities of the RL step are 0 on both sides.

Tolerances: losses within 1e-5 relative at each of 3 steps; params within
1e-6 absolute after them, the two softmax-invariant attention-score
biases within lr * steps (``torch_parity.SOFTMAX_INVARIANT``); eval
(sums, counts) within 1e-5 relative of JAX's and unmoved by a scrambled
padding row.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.ops import ciderd_device as jcd
from insenticap_model_tpu.rewards.ciderd import build_scorer as jbuild
from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.training import steps as jsteps
from insenticap_model_tpu_torch import nn
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.ops import ciderd_device as tcd
from insenticap_model_tpu_torch.rewards.ciderd import build_scorer
from insenticap_model_tpu_torch.training import optim as topt
from insenticap_model_tpu_torch.training import steps as tsteps
from torch_parity import (JIDS, TIDS, V, assert_params_match,
                          caption_batches, captioner_params,
                          classifier_params, detector_params, port_settings,
                          t)

LR = 4e-4
STEPS = 3
BS = 8
MAXLEN = 8
# one Gumbel array for every forced draw (rows x vocab; a draw of r rows
# takes the first r)
GUMBEL = np.random.default_rng(123).gumbel(size=(64, V)).astype(np.float32)


@pytest.fixture
def nodrop(settings):
    return dataclasses.replace(settings, dropout_p=0.0)


@pytest.fixture
def forced(monkeypatch):
    """Both packages' categorical draws forced to argmax(logprobs + G); the
    RL step's scheduled-sampling probabilities 0 on both sides."""
    g_j, g_t = jnp.asarray(GUMBEL), torch.from_numpy(GUMBEL)

    def jdraw(key, logits, axis=-1, **kw):
        return jnp.argmax(logits + g_j[:logits.shape[0]], axis=axis)

    def tdraw(gen, logprobs):
        return (logprobs.float() + g_t[:logprobs.shape[0]]).argmax(dim=-1)
    monkeypatch.setattr(jax.random, "categorical", jdraw)
    monkeypatch.setattr(tcap, "_categorical", tdraw)
    for m in (jsteps, tsteps):
        monkeypatch.setattr(m, "RL_XE_SS_PROB", 0.0)
        monkeypatch.setattr(m, "RL_SEQ_SS_PROB", 0.0)


def _corpus(g, fns):
    return {fn: [[JIDS.sos] + list(map(int, g.integers(4, V, size=5)))
                 + [JIDS.eos] for _ in range(int(g.integers(2, 5)))]
            for fn in fns}


def _tables(corpus, fns):
    """The JAX and the port's CIDEr-D tables of one corpus."""
    jt, fn2row = jcd.build_tables(jbuild({"train": corpus}, JIDS.sos,
                                         JIDS.eos), corpus, fns, MAXLEN,
                                  JIDS.sos, JIDS.eos)
    tt, _ = tcd.build_tables(build_scorer({"train": corpus}, JIDS.sos,
                                          JIDS.eos), corpus, fns, MAXLEN,
                             JIDS.sos, JIDS.eos)
    return jt, tt, fn2row


def _batches(settings, seed, fn2row, fns):
    """(fact batch, senti batch, scs batch) as numpy: 14 x 14 att grids for
    the detector, each image's channels shifted by its own offsets (so
    that the detector's pooled features, and labels, differ between
    images), the fact rows' images in the tables."""
    b, scs = caption_batches(settings, BS, seed, maxlen=MAXLEN)
    g = np.random.default_rng(100 + seed)
    C = settings.att_feat_dim
    b["att"] = (g.normal(size=(BS, 14, 14, C))
                + 2.0 * g.normal(size=(BS, 1, 1, C))).astype(np.float32)
    b["sentis"] = g.integers(4, V, size=(BS, 6)).astype(np.int32)
    b["img_rows"] = np.asarray([fn2row[fn] for fn in fns], np.int32)
    senti = {k: b[k] for k in ("fc", "att", "cpts", "sentis")}
    senti["senti_labels"] = g.integers(0, 3, size=(BS,)).astype(np.int32)
    return b, senti, scs


def _frozen(settings):
    jd, td = detector_params(settings, scale=30.0)
    jc, tc = classifier_params(settings)
    return (jsteps.RLModels(senti_detector=jd, sent_senti_cls=jc),
            tsteps.RLModels(senti_detector=td, sent_senti_cls=tc))


def _tensors(batch):
    return {k: t(v) for k, v in batch.items()}


def _rl_pair(nodrop, tables):
    """The JAX steps with their params and state, the port's with its
    Adam, from the same initial weights."""
    jt, tt = tables
    jp, tp = captioner_params(nodrop, eos_bias=1.5)
    tx = jopt.make_optimizer(LR)
    jrl = jsteps.make_rl_steps(nodrop, tx, JIDS, MAXLEN, jt)
    tp = nn.tree_map(lambda x: x.requires_grad_(True), tp)
    adam = topt.Adam(tp, LR)
    trl = tsteps.make_rl_steps(port_settings(nodrop), adam, TIDS, MAXLEN,
                               tt)
    return (jp, tx.init(jp), jrl), (tp, adam, trl)


@pytest.mark.parametrize("data_type", ["fact", "senti"])
def test_rl_train_step_matches_jax(nodrop, forced, data_type):
    g = np.random.default_rng(2)
    fns = [f"img{i}" for i in range(BS)]
    jt, tt, fn2row = _tables(_corpus(g, fns), fns)
    (jp, state, jrl), (tp, adam, trl) = _rl_pair(nodrop, (jt, tt))
    jfrozen, tfrozen = _frozen(nodrop)
    keys = {"fact": ("fc", "att", "caps", "lengths", "cpts", "sentis",
                     "img_rows"),
            "senti": ("fc", "att", "cpts", "sentis", "senti_labels")}
    seen = set()
    for i in range(STEPS):
        fact, senti, scs = _batches(nodrop, i, fn2row, fns)
        b = {k: (fact if data_type == "fact" else senti)[k]
             for k in keys[data_type]}
        jp, state, jl = jrl[(data_type, True)](jp, state, jfrozen, b, scs,
                                               jax.random.PRNGKey(i))
        tl = trl[(data_type, True)](tfrozen, _tensors(b), _tensors(scs),
                                    torch.Generator().manual_seed(i))
        assert set(tl) == set(jl)
        for k in jl:
            assert float(tl[k]) == pytest.approx(float(jl[k]), rel=1e-5,
                                                 abs=1e-7), (i, k)
        seen.add(float(tl.get("fact_reward", 0.0)))
    want = {"cap_loss", "da_loss", "cls_reward", "all_rewards",
            "seq2seq_loss"}
    if data_type == "fact":
        want |= {"xe_loss", "fact_reward"}
        # the forced draw is not the greedy rollout: the advantage moves
        assert seen != {0.0}
    assert set(tl) == want
    assert_params_match(tp, jp, STEPS, LR)
    assert adam.count == STEPS


def test_rl_eval_step_matches_jax_and_ignores_padding(nodrop, forced):
    """The fact eval step's (sums, counts) against JAX's; a scrambled last
    row, past ``valid``, moves neither."""
    g = np.random.default_rng(3)
    fns = [f"img{i}" for i in range(BS)]
    jt, tt, fn2row = _tables(_corpus(g, fns), fns)
    (jp, _, jrl), (_, _, trl) = _rl_pair(nodrop, (jt, tt))
    jfrozen, tfrozen = _frozen(nodrop)
    fact, _, _ = _batches(nodrop, 7, fn2row, fns)
    b = {k: v for k, v in fact.items()}
    js, jc = jrl[("fact", False)](jp, jfrozen, b, jax.random.PRNGKey(0))
    ts, tc = trl[("fact", False)](tfrozen, _tensors(b),
                                  torch.Generator().manual_seed(0))
    assert set(ts) == set(js) and set(tc) == set(jc)
    for k in js:
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=1e-5,
                                             abs=1e-7), k
        assert float(tc[k]) == pytest.approx(float(jc[k]), rel=1e-6), k

    a = dict(_tensors(b), valid=BS - 1)
    scrambled = {k: v.copy() for k, v in b.items()}
    g2 = np.random.default_rng(99)
    scrambled["fc"][-1] = g2.normal(size=scrambled["fc"][-1].shape)
    scrambled["att"][-1] = g2.normal(size=scrambled["att"][-1].shape)
    scrambled["caps"][-1] = 0
    scrambled["caps"][-1, 0] = JIDS.sos
    scrambled["caps"][-1, 1:4] = [5, 6, JIDS.eos]
    scrambled["lengths"][-1] = 3
    c = dict(_tensors(scrambled), valid=BS - 1)
    sa, ca = trl[("fact", False)](tfrozen, a,
                                  torch.Generator().manual_seed(7))
    sb, cb = trl[("fact", False)](tfrozen, c,
                                  torch.Generator().manual_seed(7))
    for k in sa:
        assert float(sb[k]) == pytest.approx(float(sa[k]), rel=1e-5,
                                             abs=1e-7), k
        assert float(cb[k]) == float(ca[k]), k
    assert float(ca["da_loss"]) == BS - 1


def test_detector_labels_mixed_and_clear_of_the_threshold(nodrop):
    """The frozen detector of these tests labels the batches with more than
    the neutral fallback, and no score lies within 1e-4 of the 0.7
    threshold (so the two packages' f32 rounding cannot part a label)."""
    g = np.random.default_rng(2)
    fns = [f"img{i}" for i in range(BS)]
    _, _, fn2row = _tables(_corpus(g, fns), fns)
    _, tfrozen = _frozen(nodrop)
    labels = []
    for i in range(STEPS):
        fact, _, _ = _batches(nodrop, i, fn2row, fns)
        lab, _, scores = tsd.sample(tfrozen.senti_detector,
                                    t(fact["att"]), 0.7, TIDS.neutral)
        assert float((scores - 0.7).abs().min()) > 1e-4
        labels += lab.tolist()
    assert len(set(labels)) > 1


def test_lm_reward_changes_the_cap_loss(nodrop, forced, tmp_path):
    """With ``lm_flag`` > 0 the LM reward joins the rewards: ``lm_reward``
    appears among the losses and ``cap_loss`` moves; at 0 the losses are
    the plain step's."""
    from insenticap_model_tpu_torch.ops import lm_device
    g = np.random.default_rng(4)
    fns = [f"img{i}" for i in range(BS)]
    _, tt, fn2row = _tables(_corpus(g, fns), fns)
    _, tfrozen = _frozen(nodrop)
    paths = []
    for s in range(3):
        # a unigram-and-bigram ARPA a sentiment: each id's log10 prob
        # depends on the sentiment, so samples and greedy rollouts part
        lines = ["\\data\\", f"ngram 1={V + 2}", "ngram 2=1", "",
                 "\\1-grams:", "-1.0 <s> -0.3", "-1.5 </s>"]
        lines += [f"{-0.5 - 0.1 * ((i * (s + 1)) % 7):.2f} {i} -0.2"
                  for i in range(V)]
        lines += ["", "\\2-grams:", f"-0.1 <s> {4 + s}", "", "\\end\\"]
        p = tmp_path / f"s{s}_id.sri"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    lm = lm_device.build_lm_tables(paths, V)
    fact, _, scs = _batches(nodrop, 0, fn2row, fns)
    out = {}
    for flag in (0.0, 1.0):
        _, tp = captioner_params(nodrop, eos_bias=1.5)
        tp = nn.tree_map(lambda x: x.requires_grad_(True), tp)
        trl = tsteps.make_rl_steps(port_settings(nodrop),
                                   topt.Adam(tp, LR), TIDS, MAXLEN, tt,
                                   lm_tables=lm, lm_flag=flag)
        out[flag] = trl[("fact", True)](tfrozen, _tensors(fact),
                                        _tensors(scs),
                                        torch.Generator().manual_seed(0))
    assert "lm_reward" not in out[0.0] and "lm_reward" in out[1.0]
    assert float(out[1.0]["lm_reward"]) != 0.0
    assert float(out[1.0]["cap_loss"]) != pytest.approx(
        float(out[0.0]["cap_loss"]), rel=1e-4)
    for k in ("da_loss", "xe_loss", "fact_reward", "cls_reward"):
        assert float(out[1.0][k]) == pytest.approx(float(out[0.0][k]),
                                                   rel=1e-6), k


def test_rl_raises_the_greedy_cider(nodrop):
    """SCST from random weights raises the greedy rollout's CIDEr-D against
    the ground truth (a flipped advantage or mask would still give finite
    losses): the port's own draws, 60 fact steps at lr 2e-3 on one batch
    of 8 images (the JAX package's slow-marked test_rl_improves, made
    small enough for the fast gate)."""
    T = 6
    g = np.random.default_rng(0)
    fns = [f"img{i}" for i in range(BS)]
    caps = np.zeros((BS, T + 1), np.int32)
    gt = {}
    for i in range(BS):
        caps[i, 0] = JIDS.sos
        caps[i, 1:5] = 4 + (np.arange(4) + 2 * i) % (V - 4)
        caps[i, 5] = JIDS.eos
        gt[fns[i]] = [list(caps[i, :6])] * 3
    tables, fn2row = tcd.build_tables(
        build_scorer({"train": gt}, JIDS.sos, JIDS.eos), gt, fns, T,
        JIDS.sos, JIDS.eos)
    batch = {"fc": t(g.normal(size=(BS, nodrop.fc_feat_dim))
                     .astype(np.float32)),
             "att": t(g.normal(size=(BS, 4, 4, nodrop.att_feat_dim))
                      .astype(np.float32)),
             "caps": t(caps), "lengths": t(np.full(BS, 5, np.int32)),
             "cpts": torch.zeros((BS, 3), dtype=torch.int32),
             "sentis": torch.zeros((BS, 2), dtype=torch.int32),
             "img_rows": t(np.asarray([fn2row[f] for f in fns], np.int32))}
    ps = port_settings(nodrop)
    _, tp = captioner_params(nodrop)
    params = nn.tree_map(lambda x: x.requires_grad_(True), tp)
    _, tfrozen = _frozen(nodrop)
    rl = tsteps.make_rl_steps(ps, topt.Adam(params, 2e-3, grad_clip=10.0),
                              TIDS, T, tables)

    @torch.no_grad()
    def greedy_cider():
        labels = tsd.sample(tfrozen.senti_detector, batch["att"], 0.7,
                            TIDS.neutral)[0]
        seq, _, _, _ = tcap.forward_rl(
            params, batch["fc"], batch["att"], batch["cpts"],
            batch["sentis"], labels, settings=ps, ids=TIDS, max_seq_len=T,
            sample_max=True, deterministic=True)
        ids, lens = tcd.canonicalize(seq, TIDS.eos, T + 1)
        return float(tcd.cider_d(tables, ids, lens,
                                 batch["img_rows"]).mean())

    before = greedy_cider()
    for i in range(60):
        rl[("fact", True)](tfrozen, batch, None,
                           torch.Generator().manual_seed(i))
    after = greedy_cider()
    assert np.isfinite(after)
    assert after > before + 0.5, (before, after)

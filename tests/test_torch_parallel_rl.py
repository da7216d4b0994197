"""The port's RL train and eval steps data-parallel on the CPU (gloo): the
ranks' step on a global batch (each rank its rows,
``parallel.mesh.shard_rows``) against the one-process step on that batch,
and against the JAX package's single-device step.

- With the default dropout (0.5), the real sampler (an inverse CDF at one
  uniform a global row) and the RL step's scheduled-sampling
  probabilities, the fact and senti steps at 2 ranks, the fact step at 4
  and the fact step with the LM reward on at 2, two steps each in
  float64, against one process: every step's losses within 1e-5
  relative, each leaf's summed gradient within 1e-6 of its norm (the two
  softmax-invariant attention-score biases, whose gradient is rounding,
  within 1e-12), the params within 1e-6 (those biases within lr a step)
  and the same on every rank bit for bit.
- With dropout 0, the draws forced to argmax(logprobs + G) (G one numpy
  Gumbel array, its rows those of the global batch) and the
  scheduled-sampling probabilities 0, the fact step at 2 ranks against
  the JAX package's ``make_rl_steps`` on the whole batch, three steps in
  float32: losses within 1e-5 relative, params by
  ``torch_parity.assert_params_match``.
- The fact eval step, on the same whole batch on every rank (the val pass
  is not striped) with the real sampler, gives each rank one process's
  (sums, counts) within 1e-9 relative in float64: its rollout draws are
  one process's (``mesh.whole_batch``), not a block of a draw twice as
  long.
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
from torch_parity import (JIDS, V, assert_params_match, caption_batches,
                          captioner_params, classifier_params,
                          detector_params, port_settings)
from torch_ranks import (numpy_tree, rl_eval, rl_steps, run_ranks, sequence,
                         tensors)

LR = 4e-4
GLOBAL_BS = 8          # rows: 4, 2 a rank at worlds 2, 4
MAXLEN = 8
STEPS = 2
JAX_STEPS = 3
GUMBEL = np.random.default_rng(123).gumbel(size=(64, V)).astype(np.float32)
SOFTMAX_INVARIANT_PATHS = ("attention/cont/att_alpha/bias",
                           "attention/senti/word_alpha/bias")
FACT_KEYS = ("fc", "att", "caps", "lengths", "cpts", "sentis", "img_rows")
SENTI_KEYS = ("fc", "att", "cpts", "sentis", "senti_labels")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _corpus(fns):
    g = np.random.default_rng(2)
    return {fn: [[JIDS.sos] + list(map(int, g.integers(4, V, size=5)))
                 + [JIDS.eos] for _ in range(int(g.integers(2, 5)))]
            for fn in fns}


def _batches(settings, seed, fns):
    """(fact batch, senti batch, scs batch) as numpy at GLOBAL_BS rows:
    14 x 14 att grids, each image's channels shifted by its own offsets
    (so that the detector's labels differ between images), the fact rows'
    images rows 0..GLOBAL_BS-1 of the tables."""
    b, scs = caption_batches(settings, GLOBAL_BS, seed, maxlen=MAXLEN)
    g = np.random.default_rng(100 + seed)
    C = settings.att_feat_dim
    b["att"] = (g.normal(size=(GLOBAL_BS, 14, 14, C))
                + 2.0 * g.normal(size=(GLOBAL_BS, 1, 1, C))).astype(
                    np.float32)
    b["sentis"] = g.integers(4, V, size=(GLOBAL_BS, 6)).astype(np.int32)
    b["img_rows"] = np.arange(len(fns), dtype=np.int32)
    senti = {k: b[k] for k in SENTI_KEYS if k in b}
    senti["senti_labels"] = g.integers(0, 3, size=(GLOBAL_BS,)).astype(
        np.int32)
    return ({k: b[k] for k in FACT_KEYS}, senti, scs)


def _lm_paths(tmp):
    """One unigram-and-bigram ARPA LM a sentiment, each id's log10 prob
    depending on the sentiment (the LM tables of
    ``test_torch_rl_steps.py::test_lm_reward_changes_the_cap_loss``)."""
    paths = []
    for s in range(3):
        lines = ["\\data\\", f"ngram 1={V + 2}", "ngram 2=1", "",
                 "\\1-grams:", "-1.0 <s> -0.3", "-1.5 </s>"]
        lines += [f"{-0.5 - 0.1 * ((i * (s + 1)) % 7):.2f} {i} -0.2"
                  for i in range(V)]
        lines += ["", "\\2-grams:", f"-0.1 <s> {4 + s}", "", "\\end\\"]
        p = tmp / f"s{s}_id.sri"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def inputs(settings, tmp_path_factory):
    """{case: spec} for ``torch_ranks.rl_steps`` / ``rl_eval``, and the
    JAX side of the forced case."""
    fns = [f"img{i}" for i in range(GLOBAL_BS)]
    corpus = _corpus(fns)
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    jp, tp = captioner_params(settings, eos_bias=1.5)
    jd, td = detector_params(settings, scale=30.0)
    jc, tc = classifier_params(settings)
    data = [_batches(settings, i, fns) for i in range(JAX_STEPS)]
    base = dict(params=numpy_tree(tp), frozen=(numpy_tree(td),
                                               numpy_tree(tc)),
                corpus=corpus, settings=port_settings(settings).to_dict(),
                dtype=torch.float64, lr=LR, max_seq_len=MAXLEN)
    fact = [(f, scs) for f, _, scs in data[:STEPS]]
    specs = {
        "fact": dict(base, data_type="fact", batches=fact),
        "senti": dict(base, data_type="senti",
                      batches=[(s, scs) for _, s, scs in data[:STEPS]]),
        "fact_lm": dict(base, data_type="fact", batches=fact,
                        lm_paths=_lm_paths(tmp_path_factory.mktemp("lm")),
                        vocab=V, lm_flag=1.0),
        "forced": dict(base, data_type="fact", dtype=torch.float32,
                       settings=port_settings(nodrop).to_dict(),
                       batches=[(f, scs) for f, _, scs in data],
                       gumbel=GUMBEL, ss_probs=(0.0, 0.0)),
        "eval": dict(base, batch=dict(data[0][0], valid=GLOBAL_BS - 1)),
    }
    return specs, (jp, jd, jc, nodrop, corpus, fns, data)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{world or case: [each rank's results]}: one spawn of 2 ranks runs
    every 2-rank case, one of 4 the fact case."""
    specs = inputs[0]
    tmp = tmp_path_factory.mktemp("rl_ranks")
    cases = ["fact", "senti", "fact_lm", "forced"]
    two = run_ranks(sequence, 2, tmp, [(rl_steps, (specs[c],))
                                       for c in cases]
                    + [(rl_eval, (specs["eval"],))])
    out = {(c, 2): [r[i] for r in two] for i, c in enumerate(cases)}
    out[("eval", 2)] = [r[len(cases)] for r in two]
    out[("fact", 4)] = run_ranks(rl_steps, 4, tmp, specs["fact"])
    return out


@pytest.fixture(scope="module")
def one(inputs):
    """The one-process results of the dropout cases and the eval step."""
    specs = inputs[0]
    out = {c: rl_steps(0, 1, specs[c]) for c in ("fact", "senti", "fact_lm")}
    out["eval"] = rl_eval(0, 1, specs["eval"])
    return out


@pytest.mark.parametrize("case,world", [("fact", 2), ("senti", 2),
                                        ("fact_lm", 2), ("fact", 4)])
def test_rl_train_step_ranks_equal_one_process(case, world, ranks, one):
    want_keys = {"cap_loss", "da_loss", "cls_reward", "all_rewards",
                 "seq2seq_loss"}
    if case.startswith("fact"):
        want_keys |= {"xe_loss", "fact_reward"}
    if case == "fact_lm":
        want_keys |= {"lm_reward"}
    ref = one[case]
    paths = _paths(ref["params"])
    for out in ranks[(case, world)]:
        for got, want in zip(out["losses"], ref["losses"]):
            assert set(got) == set(want) == want_keys
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
        for step, (gs, ws) in enumerate(zip(out["grads"], ref["grads"])):
            for path, g, w in zip(paths, gs, ws):
                assert g.dtype == w.dtype == torch.float64
                tol = 1e-12 if path in SOFTMAX_INVARIANT_PATHS else \
                    1e-6 * float(w.norm())
                assert float((g - w).norm()) <= tol, (step, path)
        got = dict(zip(paths, _leaves(out["params"])))
        for path, w in zip(paths, _leaves(ref["params"])):
            tol = LR * STEPS if path in SOFTMAX_INVARIANT_PATHS else 1e-6
            np.testing.assert_allclose(got[path], w, atol=tol, rtol=0,
                                       err_msg=path)
    first = _leaves(ranks[(case, world)][0]["params"])
    for out in ranks[(case, world)][1:]:
        assert all(np.array_equal(a, b)
                   for a, b in zip(_leaves(out["params"]), first))
    # the terms the case adds are live
    if case.startswith("fact"):
        assert any(s["fact_reward"] != 0.0 for s in ref["losses"])
    if case == "fact_lm":
        assert any(s["lm_reward"] != 0.0 for s in ref["losses"])


def test_rl_fact_step_two_ranks_equal_jax(inputs, ranks, monkeypatch):
    _, (jp, jd, jc, nodrop, corpus, fns, data) = inputs
    g_j = jnp.asarray(GUMBEL)
    monkeypatch.setattr(
        jax.random, "categorical", lambda key, logits, axis=-1, **kw:
        jnp.argmax(logits + g_j[:logits.shape[0]], axis=axis))
    monkeypatch.setattr(jsteps, "RL_XE_SS_PROB", 0.0)
    monkeypatch.setattr(jsteps, "RL_SEQ_SS_PROB", 0.0)
    tables, _ = jcd.build_tables(jbuild({"train": corpus}, JIDS.sos,
                                        JIDS.eos), corpus, fns, MAXLEN,
                                 JIDS.sos, JIDS.eos)
    tx = jopt.make_optimizer(LR)
    state = tx.init(jp)
    jrl = jsteps.make_rl_steps(nodrop, tx, JIDS, MAXLEN, tables)
    frozen = jsteps.RLModels(senti_detector=jd, sent_senti_cls=jc)
    jlosses = []
    for i, (b, _, scs) in enumerate(data):
        jp, state, jl = jrl[("fact", True)](jp, state, frozen, b, scs,
                                            jax.random.PRNGKey(i))
        jlosses.append({k: float(v) for k, v in jl.items()})
    assert any(s["fact_reward"] != 0.0 for s in jlosses)
    for out in ranks[("forced", 2)]:
        assert len(out["losses"]) == JAX_STEPS
        for got, want in zip(out["losses"], jlosses):
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5,
                                               abs=1e-7), k
        assert_params_match(tensors(out["params"]), jp, JAX_STEPS, LR)


def test_rl_eval_draws_as_one_process_on_every_rank(ranks, one):
    """Every rank's (sums, counts) of the fact eval step on the whole
    batch are one process's; ``mesh.rank_rows`` takes the rank's block of
    a global draw outside ``whole_batch`` and after a block an exception
    left, and one process's draw inside it."""
    ref = one["eval"]
    assert ref["counts"]["da_loss"] == GLOBAL_BS - 1
    assert ref["sums"]["fact_reward"] != 0.0
    for rank, out in enumerate(ranks[("eval", 2)]):
        assert set(out["sums"]) == set(ref["sums"])
        for k in ref["sums"]:
            assert out["sums"][k] == pytest.approx(ref["sums"][k],
                                                   rel=1e-9, abs=1e-12), k
            assert out["counts"][k] == ref["counts"][k], k
        block = list(range(3 * rank, 3 * rank + 3))
        assert out["rank_rows"] == [block, [0, 1, 2], block]

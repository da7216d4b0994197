"""The port's XE train and eval steps against the JAX package's on the
CPU, in f32 at the conftest widths.

Tolerances: losses within 1e-5 relative at each of 3 steps; params within
1e-6 absolute after them, except the two attention-score biases
(``attention/cont/att_alpha/b``, ``attention/senti/word_alpha/b``). The
softmax over positions is invariant to those, so their gradient is zero
up to rounding, and Adam's g / (|g| + eps) turns that rounding into an
update of up to lr a step in either package: they are held within
lr * steps of each other.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.training import steps as jsteps
from insenticap_model_tpu_torch import nn
from insenticap_model_tpu_torch.training import optim as topt
from insenticap_model_tpu_torch.training import steps as tsteps
from torch_parity import (assert_params_match, caption_batches,
                          captioner_params, classifier_params, port_settings,
                          t)

LR = 4e-4
STEPS = 3


def _tensors(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.fixture
def nodrop(settings):
    return dataclasses.replace(settings, dropout_p=0.0)


def test_xe_train_step_matches_jax(nodrop):
    jp, tp = captioner_params(nodrop)
    jc, tc = classifier_params(nodrop)
    tx = jopt.make_optimizer(LR)
    state = tx.init(jp)
    jtrain, _ = jsteps.make_xe_steps(nodrop, tx)
    tp = nn.tree_map(lambda x: x.requires_grad_(True), tp)
    adam = topt.Adam(tp, LR)
    ttrain, _ = tsteps.make_xe_steps(port_settings(nodrop), adam)
    for i in range(STEPS):
        b, scs = caption_batches(nodrop, 8, seed=i)
        jp, state, jl = jtrain(jp, state, jc, b, scs, jax.random.PRNGKey(i),
                               jnp.float32(0.0))
        tl = ttrain(tc, _tensors(b), _tensors(scs),
                    torch.Generator().manual_seed(i), 0.0)
        assert set(tl) == set(jl) == {"xe_loss", "da_loss", "cap_loss",
                                      "seq2seq_loss", "all_loss"}
        for k in jl:
            assert float(tl[k]) == pytest.approx(float(jl[k]), rel=1e-5), k
    assert_params_match(tp, jp, STEPS, LR)
    assert adam.count == STEPS


def test_pseudo_labels_match_jax(nodrop):
    """The frozen classifier's labels of the captions: seeds 0-3 give no
    near-tie (the top two logits at least 1e-4 apart), so argmax agrees."""
    _, tc = classifier_params(nodrop)
    jc, _ = classifier_params(nodrop)
    for seed in range(4):
        b, _ = caption_batches(nodrop, 8, seed=seed)
        logits, _ = jss.forward(jc, b["caps"][:, 1:], b["lengths"],
                                settings=nodrop)
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
        got = tsteps._pseudo_senti_labels(tc, t(b["caps"]), t(b["lengths"]),
                                          port_settings(nodrop))
        want = jsteps._pseudo_senti_labels(jc, b["caps"], b["lengths"],
                                           nodrop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_xe_eval_step_matches_jax_and_batch_boundaries(settings):
    """The eval step's masked sums equal the JAX package's (1e-5
    relative), and the aggregated val loss is the same however the split
    is batched: the padding rows of a last batch add nothing."""
    jp, tp = captioner_params(settings)
    jc, tc = classifier_params(settings)
    _, jeval = jsteps.make_xe_steps(settings, jopt.make_optimizer(LR))
    _, teval = tsteps.make_xe_steps(port_settings(settings),
                                    topt.Adam(tp, LR))
    full, _ = caption_batches(settings, 10, seed=11)

    def val_loss(bs):
        sums, cnts = {}, {}
        for s in range(0, 10, bs):
            rows = list(range(s, min(s + bs, 10)))
            valid = len(rows)
            rows += [rows[-1]] * (bs - valid)
            b = {k: v[rows] for k, v in full.items()}
            tb = dict(_tensors(b), valid=valid)
            ts, tcnt = teval(tc, tb)
            js, jcnt = jeval(jp, jc, dict(b, valid=np.int32(valid)),
                             jax.random.PRNGKey(0))
            for k in ts:
                assert float(ts[k]) == pytest.approx(float(js[k]),
                                                     rel=1e-5), k
                assert float(tcnt[k]) == float(jcnt[k]), k
                sums[k] = sums.get(k, 0.0) + float(ts[k])
                cnts[k] = cnts.get(k, 0.0) + float(tcnt[k])
        return {k: sums[k] / cnts[k] for k in sums}

    a, b_, c = val_loss(4), val_loss(3), val_loss(10)
    for k in a:
        assert a[k] == pytest.approx(c[k], rel=1e-5), k
        assert b_[k] == pytest.approx(c[k], rel=1e-5), k


def test_xe_train_step_with_dropout_and_sampling_falls(settings):
    """With the default dropout and ss_prob 0.25 the step runs, its
    losses are finite and the loss on a fixed batch falls over 8 steps."""
    _, tp = captioner_params(settings)
    _, tc = classifier_params(settings)
    tp = nn.tree_map(lambda x: x.requires_grad_(True), tp)
    adam = topt.Adam(tp, 1e-3)
    ttrain, _ = tsteps.make_xe_steps(port_settings(settings), adam)
    b, scs = caption_batches(settings, 16, seed=5)
    b, scs = _tensors(b), _tensors(scs)
    losses = [ttrain(tc, b, scs, torch.Generator().manual_seed(i), 0.25)
              for i in range(8)]
    assert all(np.isfinite(float(v)) for ls in losses for v in ls.values())
    assert float(losses[-1]["all_loss"]) < float(losses[0]["all_loss"])



# the port-layout paths of the two softmax-invariant attention-score biases
SOFTMAX_INVARIANT_PORT = ("attention/cont/att_alpha/bias",
                          "attention/senti/word_alpha/bias")


def _leaf_paths(tree, prefix=""):
    """'a/b/c' paths of a nested dict's leaves, in ``nn.tree_leaves``
    order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def test_xe_gradients_f32_match_f64(nodrop):
    """The f32 step's gradients against the same step in f64, leaf by
    leaf: |g32 - g64| / |g64| (L2) within 1e-5, a leaf with no gradient
    zero in both, the two softmax-invariant biases apart (their gradient
    is rounding alone). This is the rounding scale from which
    ``chip_smoke.py`` phase 3f sets its card-against-CPU gradient check."""
    def grads(dtype):
        _, tp = captioner_params(nodrop)
        _, tc = classifier_params(nodrop)
        tp = nn.tree_map(lambda x: x.to(dtype).requires_grad_(True), tp)
        tc = nn.tree_map(lambda x: x.to(dtype), tc)
        adam = topt.Adam(tp, LR)
        seen = {}
        step = adam.step

        def recording_step():
            seen.update(zip(_leaf_paths(tp),
                            [None if p.grad is None else p.grad.clone()
                             for p in nn.tree_leaves(tp)]))
            step()
        adam.step = recording_step
        ttrain, _ = tsteps.make_xe_steps(port_settings(nodrop), adam)
        b, scs = caption_batches(nodrop, 8, seed=0)

        def cast(batch):
            return {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in _tensors(batch).items()}
        ttrain(tc, cast(b), cast(scs), torch.Generator().manual_seed(0), 0.0)
        return seen

    g32, g64 = grads(torch.float32), grads(torch.float64)
    assert g32.keys() == g64.keys()
    assert set(SOFTMAX_INVARIANT_PORT) <= g32.keys()
    worst = 0.0
    for path, a in g32.items():
        b = g64[path]
        if path in SOFTMAX_INVARIANT_PORT:
            continue
        if b is None or not b.abs().max():
            assert a is None or not a.abs().max(), path
            continue
        rel = float((a.double() - b).norm() / b.norm())
        assert rel <= 1e-5, (path, rel)
        worst = max(worst, rel)
    assert worst > 0.0   # f32 did round: the comparison is not vacuous

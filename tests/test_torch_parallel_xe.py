"""The port's XE train step data-parallel on the CPU (gloo): the ranks'
step on a global batch (each rank its rows, ``parallel.mesh.shard_rows``)
against the one-process step on that batch, and against the JAX
package's single-device step.

- With dropout 0.5 and scheduled sampling at 0.25 (every draw one a row
  of the global batch, ``mesh.rank_rows``), 2 and 4 ranks against one
  process, two steps in float64: every step's losses within 1e-5
  relative, its summed gradient within 1e-6 of each leaf's largest
  magnitude (float64, since the gradient is a sum that can nearly cancel:
  in float32 the rounding of the two orders of summation alone can reach
  that), the params within 1e-6, and the same on every rank bit for bit.
  The two softmax-invariant attention-score biases
  (``torch_parity.SOFTMAX_INVARIANT``) have a gradient that is zero up to
  rounding: it is held within 1e-12, and their params within lr a step
  (Adam's g / (|g| + eps) turns that rounding into an update).
- With dropout 0 and ss_prob 0, 2 ranks against the JAX package's
  ``make_xe_steps`` on the whole batch, three steps in float32: losses
  within 1e-5 relative, params by ``torch_parity.assert_params_match``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.training import steps as jsteps
from torch_parity import (assert_params_match, caption_batches,
                          captioner_params, classifier_params,
                          port_settings)
from torch_ranks import numpy_tree, run_ranks, sequence, tensors, xe_steps

LR = 4e-4
GLOBAL_BS = 8          # rows: 4, 2 a rank at worlds 2, 4
SS_PROB = 0.25
JAX_STEPS = 3
# the captioner's attention-score biases in ``nn.tree_leaves`` order (keys
# sorted): attention/cont/att_alpha/bias and attention/senti/word_alpha/
# bias, whose gradient is zero up to rounding
SOFTMAX_INVARIANT_PATHS = ("attention/cont/att_alpha/bias",
                           "attention/senti/word_alpha/bias")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       f"{prefix}{k}/")]
    return [prefix[:-1]]


@pytest.fixture(scope="module")
def inputs(settings):
    """(dropout args, no-dropout args, JAX params, JAX classifier,
    batches) for ``torch_ranks.xe_steps``."""
    jp, tp = captioner_params(settings)
    jc, tc = classifier_params(settings)
    batches = [caption_batches(settings, GLOBAL_BS, seed=i)
               for i in range(JAX_STEPS)]
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    drop = (numpy_tree(tp), numpy_tree(tc), batches[:2],
            port_settings(settings).to_dict(), SS_PROB, torch.float64, LR)
    plain = (numpy_tree(tp), numpy_tree(tc), batches,
             port_settings(nodrop).to_dict(), 0.0, torch.float32, LR)
    return drop, plain, jp, jc, batches, nodrop


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{world: [each rank's results]}: world 2 runs both step sets."""
    drop, plain = inputs[:2]
    tmp = tmp_path_factory.mktemp("xe_ranks")
    two = run_ranks(sequence, 2, tmp, [(xe_steps, drop), (xe_steps, plain)])
    four = run_ranks(xe_steps, 4, tmp, *drop)
    return {2: [r[0] for r in two], 4: four, "plain": [r[1] for r in two]}


@pytest.mark.parametrize("world", [2, 4])
def test_xe_step_ranks_equal_one_process(world, inputs, ranks):
    one = xe_steps(0, 1, *inputs[0])
    paths = _paths(one["params"])
    for out in ranks[world]:
        for got, want in zip(out["losses"], one["losses"]):
            assert set(got) == set(want) == {
                "xe_loss", "da_loss", "cap_loss", "seq2seq_loss", "all_loss"}
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
        for step, (gs, ws) in enumerate(zip(out["grads"], one["grads"])):
            for path, g, w in zip(paths, gs, ws):
                assert g.dtype == w.dtype == torch.float64
                # the two biases' gradient is rounding: held to 1e-12
                tol = 1e-12 if path in SOFTMAX_INVARIANT_PATHS else \
                    1e-6 * float(w.abs().max())
                assert float((g - w).abs().max()) <= tol, (step, path)
        got = dict(zip(paths, tensors(_leaves(out["params"]))))
        for path, w in zip(paths, tensors(_leaves(one["params"]))):
            tol = LR * 2 if path in SOFTMAX_INVARIANT_PATHS else 1e-6
            np.testing.assert_allclose(got[path].numpy(), w.numpy(),
                                       atol=tol, rtol=0, err_msg=path)
    first = _leaves(ranks[world][0]["params"])
    for out in ranks[world][1:]:
        assert all(np.array_equal(a, b)
                   for a, b in zip(_leaves(out["params"]), first))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_xe_step_two_ranks_equal_jax(inputs, ranks):
    _, _, jp, jc, batches, nodrop = inputs
    tx = jopt.make_optimizer(LR)
    state = tx.init(jp)
    jtrain, _ = jsteps.make_xe_steps(nodrop, tx)
    jlosses = []
    for i, (b, scs) in enumerate(batches):
        jp, state, jl = jtrain(jp, state, jc, b, scs, jax.random.PRNGKey(i),
                               jnp.float32(0.0))
        jlosses.append({k: float(v) for k, v in jl.items()})
    for out in ranks["plain"]:
        assert len(out["losses"]) == JAX_STEPS
        for got, want in zip(out["losses"], jlosses):
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
        assert_params_match(tensors(out["params"]), jp, JAX_STEPS, LR)

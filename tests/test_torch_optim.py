"""The port's Adam behind the element-wise clamp against the JAX package's
optax chain (and ``torch.optim.Adam`` after ``grad.clamp_``) on the CPU,
in f32, and its state against optax's tree.

Tolerance: params within 1e-6 absolute after every step (5 steps,
gradients of scale 3 against a clamp of 0.1, so most are clamped); the
moments within 1e-6 relative plus 1e-9 absolute; counts and learning
rates exact. A row whose gradient is always zero keeps its values
exactly in all three.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu_torch import convert
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.training import optim as topt

LR = 1e-3
STEPS = 5


def _params(seed=0):
    """A linear and an embedding, port layout (float32, requiring grad),
    and the JAX package's copy."""
    g = np.random.default_rng(seed)
    tp = {"lin": {"weight": torch.tensor(g.normal(size=(3, 4)),
                                         dtype=torch.float32),
                  "bias": torch.tensor(g.normal(size=(3,)),
                                       dtype=torch.float32)},
          "emb": {"weight": torch.tensor(g.normal(size=(5, 2)),
                                         dtype=torch.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, convert.to_jax_numpy(tp))
    return tnn.tree_map(lambda x: x.requires_grad_(True), tp), jp


def _grads(step, zero_row=3):
    """Port-layout gradients of scale 3; the embedding's row 3 is 0."""
    g = np.random.default_rng(100 + step)
    emb = g.normal(size=(5, 2)) * 3
    emb[zero_row] = 0.0
    return {"lin": {"weight": torch.tensor(g.normal(size=(3, 4)) * 3,
                                           dtype=torch.float32),
                    "bias": torch.tensor(g.normal(size=(3,)) * 3,
                                         dtype=torch.float32)},
            "emb": {"weight": torch.tensor(emb, dtype=torch.float32)}}


def _set_grads(params, grads):
    for p, g in zip(tnn.tree_leaves(params), tnn.tree_leaves(grads)):
        p.grad = g.clone()


def _jax_grads(grads):
    return jax.tree_util.tree_map(jnp.asarray, convert.to_jax_numpy(grads))


def _assert_params(tp, jp, atol=1e-6):
    got = convert.to_jax_numpy(tp)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=atol,
                                                rtol=0), got, jp)


def test_adam_matches_optax_and_torch():
    tp, jp = _params()
    init_row = tp["emb"]["weight"][3].detach().clone()
    adam = topt.Adam(tp, LR, grad_clip=0.1)
    tx = jopt.make_optimizer(LR, grad_clip=0.1)
    state = tx.init(jp)
    ref = [p.detach().clone().requires_grad_(True)
           for p in tnn.tree_leaves(tp)]
    tadam = torch.optim.Adam(ref, lr=LR)
    for s in range(STEPS):
        grads = _grads(s)
        _set_grads(tp, grads)
        adam.step()
        jp, state = jopt.apply_updates(jp, _jax_grads(grads), state, tx)
        _assert_params(tp, jp)
        tadam.zero_grad()
        for p, g in zip(ref, tnn.tree_leaves(grads)):
            p.grad = g.clone().clamp_(-0.1, 0.1)
        tadam.step()
        for p, r in zip(tnn.tree_leaves(tp), ref):
            np.testing.assert_allclose(p.detach().numpy(),
                                       r.detach().numpy(), atol=1e-6)
    assert adam.count == STEPS
    assert torch.equal(tp["emb"]["weight"][3], init_row)
    np.testing.assert_array_equal(np.asarray(jp["emb"]["table"])[3],
                                  init_row.numpy())


def test_lr_get_and_set_follow_optax():
    tp, jp = _params(1)
    adam = topt.Adam(tp, 4e-4)
    tx = jopt.make_optimizer(4e-4)
    state = tx.init(jp)
    assert topt.get_lr(adam) == pytest.approx(jopt.get_lr(state))
    topt.set_lr(adam, 2e-4)
    state = jopt.set_lr(state, 2e-4)
    assert topt.get_lr(adam) == pytest.approx(2e-4)
    for s in range(3):
        grads = _grads(s)
        _set_grads(tp, grads)
        adam.step()
        jp, state = jopt.apply_updates(jp, _jax_grads(grads), state, tx)
    _assert_params(tp, jp)


def test_state_converts_to_and_from_optax():
    """After 5 steps the port's state, as optax's tree, equals flax's state
    dict of optax's; a port optimizer loaded from optax's state continues
    as optax does, and optax loaded from the port's continues as the port
    does."""
    tp, jp = _params(2)
    adam = topt.Adam(tp, LR)
    tx = jopt.make_optimizer(LR)
    state = tx.init(jp)
    for s in range(STEPS):
        grads = _grads(s)
        _set_grads(tp, grads)
        adam.step()
        jp, state = jopt.apply_updates(jp, _jax_grads(grads), state, tx)
    mine = topt.to_optax_state(adam)
    theirs = serialization.to_state_dict(state)
    mine_sd = {**mine, "inner_state": {str(i): v for i, v in
                                       enumerate(mine["inner_state"])}}
    flat_m, tree_m = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, mine_sd))
    flat_t, tree_t = jax.tree_util.tree_flatten(theirs)
    assert tree_m == tree_t
    for a, b in zip(flat_m, flat_t):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)

    # each continues from the other's state
    tp2, _ = _params(2)
    with torch.no_grad():
        for p, q in zip(tnn.tree_leaves(tp2), tnn.tree_leaves(tp)):
            p.copy_(q)
    other = topt.Adam(tp2, 1.0)
    topt.load_optax_state(other, jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), theirs))
    assert other.count == STEPS and other.lr == pytest.approx(LR)
    jstate2 = serialization.from_state_dict(state, jax.tree_util.tree_map(
        np.asarray, mine_sd))
    jp2 = jp
    for s in range(STEPS, STEPS + 3):
        grads = _grads(s)
        _set_grads(tp, grads)
        _set_grads(tp2, grads)
        adam.step()
        other.step()
        jp, state = jopt.apply_updates(jp, _jax_grads(grads), state, tx)
        jp2, jstate2 = jopt.apply_updates(jp2, _jax_grads(grads), jstate2,
                                          tx)
    _assert_params(tp2, jp)
    _assert_params(tp, jp2)


def _as_torch(state):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  serialization.to_state_dict(state))


def test_load_refuses_another_shape_or_chain():
    """Only the chain the JAX CLIs write (clip, Adam, scale) is read: the
    4-element chain with optax's weight decay is refused."""
    tp, jp = _params(3)
    as_torch = _as_torch(jopt.make_optimizer(LR).init(jp))
    with pytest.raises(ValueError, match="inner states"):
        topt.load_optax_state(topt.Adam(tp, LR), _as_torch(
            jopt.make_optimizer(LR, weight_decay=0.1).init(jp)))
    other, _ = _params(3)
    other["emb"]["weight"] = torch.zeros(6, 2, requires_grad=True)
    with pytest.raises(ValueError, match="shape"):
        topt.load_optax_state(topt.Adam(other, LR), as_torch)


def test_bf16_params_keep_f32_moments():
    """bf16 parameters: the moments stay float32 and the update is formed
    in float32, then rounded to the parameter (as optax's moments stay in
    the float32 they were initialised in by the JAX CLI)."""
    tp, _ = _params(4)
    tp16 = tnn.tree_map(lambda x: x.detach().bfloat16().requires_grad_(True),
                        tp)
    tp32 = tnn.tree_map(lambda x: x.detach().float().requires_grad_(True),
                        tp16)
    a16 = topt.Adam(tp16, LR)
    a32 = topt.Adam(tp32, LR)
    grads = _grads(0)
    _set_grads(tp16, tnn.tree_map(lambda g: g.bfloat16(), grads))
    _set_grads(tp32, tnn.tree_map(lambda g: g.bfloat16().float(), grads))
    a16.step()
    a32.step()
    assert all(m.dtype == torch.float32 for m in tnn.tree_leaves(a16.mu))
    for p16, p32 in zip(tnn.tree_leaves(tp16), tnn.tree_leaves(tp32)):
        assert p16.dtype == torch.bfloat16
        assert torch.equal(p16, p32.bfloat16())

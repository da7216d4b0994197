"""The head stages' train and eval steps (concept, both image-sentiment
heads, sentence classifier) against the JAX package's on the CPU, in f32
at the conftest widths, dropout 0.

Tolerances: each step's loss and each eval step's masked loss sum within
1e-5 relative, its row count equal, its outputs (scores within 1e-5;
labels identical); the params within 1e-6 absolute after 3 Adam steps. A
padded eval batch (its last rows repeat a true row, ``valid`` counts the
true ones) gives the same masked sum as the true rows alone, within 1e-6
relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.training import steps as jsteps
from insenticap_model_tpu_torch import nn
from insenticap_model_tpu_torch.training import optim as topt
from insenticap_model_tpu_torch.training import steps as tsteps
from torch_parity import V, jax_flat, jax_numpy, n, port_settings, t, to_port

LR = 4e-4
STEPS = 3
BS = 6
N_CONCEPTS = 11
T = 8


def _init(stage, s):
    """The JAX package's initial params of a stage."""
    key = jax.random.PRNGKey(4)
    if stage == "concept":
        return jcpt.init_params(key, N_CONCEPTS, s)
    if stage == "cls":
        return jss.init_params(key, V, 3, s)
    return jsd.module_for(s).init_params(key, 3, s)


def _batch(stage, s, seed):
    """One batch of numpy arrays, as the stage's loader gives it."""
    g = np.random.default_rng(seed)
    if stage == "concept":
        return {"fc": g.standard_normal((BS, s.fc_feat_dim))
                .astype(np.float32),
                "cpts": (g.random((BS, N_CONCEPTS)) < 0.3)
                .astype(np.float32)}
    labels = g.integers(0, 3, BS).astype(np.int32)
    if stage == "cls":
        lengths = g.integers(1, T + 1, BS).astype(np.int32)
        caps = np.zeros((BS, T), np.int32)
        for i, L in enumerate(lengths):
            caps[i, :L] = g.integers(4, V, L)
        return {"caps": caps, "lengths": lengths, "labels": labels}
    return {"att": g.random((BS, 14, 14, s.att_feat_dim), np.float32),
            "labels": labels}


# stage -> (the step factory, the model kind, num_kernels_per_sentiment)
MAKERS = {"concept": ("make_concept_steps", "concept", None),
          "senti": ("make_senti_steps", "senti", 0),
          "senti_full": ("make_senti_steps", "senti", 2),
          "cls": ("make_cls_steps", "cls", None)}


@pytest.fixture(params=list(MAKERS))
def stage(request, settings):
    """(stage, JAX settings with dropout 0 and the stage's head)."""
    s = dataclasses.replace(settings, dropout_p=0.0)
    k = MAKERS[request.param][2]
    if k is not None:
        s = dataclasses.replace(s, num_kernels_per_sentiment=k)
    return request.param, s


def _tensors(batch):
    return {k: v if k == "valid" else t(v) for k, v in batch.items()}


def _steps(stage, s):
    name, kind, _ = MAKERS[stage]
    jp = _init(kind, s)
    tx = jopt.make_optimizer(LR)
    jtrain, jeval = getattr(jsteps, name)(s, tx)
    tp = nn.tree_map(lambda x: x.requires_grad_(True), to_port(jp))
    adam = topt.Adam(tp, LR)
    ttrain, teval = getattr(tsteps, name)(port_settings(s), adam)
    return jp, tx.init(jp), jtrain, jeval, adam, ttrain, teval


def _assert_eval(got, want):
    (ts, tc, tout), (js, jc, jout) = got, want
    assert float(ts) == pytest.approx(float(js), rel=1e-5)
    assert float(tc) == float(jc)
    if tout.is_floating_point():
        np.testing.assert_allclose(n(tout), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert tout.dtype == torch.int32
        np.testing.assert_array_equal(n(tout), np.asarray(jout))


def test_train_and_eval_steps_match_jax(stage):
    name, s = stage
    kind = MAKERS[name][1]
    jp, state, jtrain, jeval, adam, ttrain, teval = _steps(name, s)
    for i in range(STEPS):
        b = _batch(kind, s, seed=10 + i)
        _assert_eval(teval(_tensors(b)), jeval(jp, b))
        jp, state, jl = jtrain(jp, state, b, jax.random.PRNGKey(i))
        tl = ttrain(_tensors(b), torch.Generator().manual_seed(i))
        assert tl.requires_grad is False
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    got, want = jax_numpy(adam.params), jax_flat(jp)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, w) in zip(got, want):
        np.testing.assert_allclose(a, w, atol=1e-6, rtol=0, err_msg=path)
    assert adam.count == STEPS
    b = _batch(kind, s, seed=20)
    _assert_eval(teval(_tensors(b)), jeval(jp, b))


def test_padded_eval_batch_sums_its_true_rows(stage):
    """The eval loader's last batch: rows past ``valid`` repeat the last
    true row. Its masked sum and count are the true rows', as the JAX
    step's are where the batch carries ``valid``."""
    name, s = stage
    kind = MAKERS[name][1]
    jp, _, _, jeval, _, _, teval = _steps(name, s)
    full = _batch(kind, s, seed=30)
    valid = 4
    padded = {k: np.concatenate([v[:valid]] + [v[valid - 1:valid]]
                                * (BS - valid)) for k, v in full.items()}
    padded["valid"] = valid
    ps, pc, _ = teval(_tensors(padded))
    ts, tc, _ = teval(_tensors({k: v[:valid] for k, v in full.items()}))
    assert float(pc) == float(tc) == valid
    assert float(ps) == pytest.approx(float(ts), rel=1e-6)
    js, jc, _ = jeval(jp, padded)
    assert float(jc) == valid
    assert float(ps) == pytest.approx(float(js), rel=1e-5)
    nomask, _, _ = teval(_tensors({k: v for k, v in padded.items()
                                   if k != "valid"}))
    assert float(nomask) > float(ps)

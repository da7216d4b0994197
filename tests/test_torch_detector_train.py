"""The detectors' training forwards and losses against the JAX package's on
the CPU, in f32 at the conftest widths: the concept MLP's multi-label BCE
and both image-sentiment heads' cross entropy.

Tolerances: forwards, losses and per-row losses within 1e-6 (relative and
absolute) with dropout 0. Gradients against ``jax.grad`` of the same loss
in f64 (``jax.enable_x64``): the port's f64 gradient within 1e-10 of each
leaf's norm (the same function), its f32 gradient within 1e-5 of the norm
(f32 rounding: the JAX package's own f32 gradient of the 1x1 conv's bias,
a sum over 196 positions and the batch, is 1.3e-5 off f64 there, the
port's 1.1e-6). The clamped loss of exactly saturated scores equal
to the JAX package's within 1e-6. Dropout 0.5 is held by a numpy-mask
double given to both packages (the same mask at the same site, outputs
within 1e-6) and by the port's own mask statistics.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import nn as jnn
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.models import concept_detector as tcpt
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from torch_parity import (features, jax_flat, jax_numpy, n, port_settings,
                          t, to_port)

TOL = dict(rtol=1e-6, atol=1e-6)
BS = 6
N_CONCEPTS = 11


def _heads(settings):
    """{head: (JAX settings, the JAX module, the port module)}."""
    full = dataclasses.replace(settings, num_kernels_per_sentiment=2)
    out = {}
    for head, s in (("standard", settings), ("full", full)):
        out[head] = (s, jsd.module_for(s), tsd.module_for(port_settings(s)))
    return out


def _detector(settings, head, seed=1):
    s, jmod, tmod = _heads(settings)[head]
    jp = jmod.init_params(jax.random.PRNGKey(seed), 3, s)
    return s, jmod, tmod, jp, to_port(jp)


def _concept_batch(settings, seed=3):
    g = np.random.default_rng(seed)
    fc = g.standard_normal((BS, settings.fc_feat_dim)).astype(np.float32)
    cpts = (g.random((BS, N_CONCEPTS)) < 0.3).astype(np.float32)
    return fc, cpts


def _labels(seed):
    return np.random.default_rng(seed).integers(0, 3, BS).astype(np.int32)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _assert_grads(port_loss, jax_loss, jp):
    """The port's gradients of ``port_loss(params)`` (params from the JAX
    tree ``jp``) in f64 and in f32 against ``jax.grad(jax_loss)`` in f64,
    leaf by leaf: |g - g_jax| / |g_jax| (L2) within 1e-10 and 1e-5."""
    with jax.enable_x64(True):
        want = jax_flat(jax.grad(jax_loss)(_f64(jp)))
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        tp = tnn.tree_map(lambda x: x.to(dtype).requires_grad_(True),
                          to_port(jp))
        port_loss(tp, dtype).backward()
        got = jax_numpy(tnn.tree_map(lambda x: x.grad, tp))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, w) in zip(got, want):
            norm = np.linalg.norm(w)
            assert norm > 0, path
            assert np.linalg.norm(a - w) <= tol * norm, (path, dtype)


def test_concept_training_forward_and_losses_match_jax(settings):
    jp = jcpt.init_params(jax.random.PRNGKey(2), N_CONCEPTS, settings)
    tp = to_port(jp)
    fc, cpts = _concept_batch(settings)
    jout = jcpt.forward(jp, fc, dropout_p=0.0, rng=jax.random.PRNGKey(0),
                        deterministic=False)
    tout = tcpt.forward(tp, t(fc), dropout_p=0.0,
                        gen=torch.Generator().manual_seed(0),
                        deterministic=False)
    np.testing.assert_allclose(n(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(n(tcpt.forward(tp, t(fc))), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(
        n(tcpt.multi_label_loss_rows(tout, t(cpts))),
        np.asarray(jcpt.multi_label_loss_rows(jout, cpts)), **TOL)
    np.testing.assert_allclose(
        n(tcpt.multi_label_loss(tout, t(cpts))),
        np.asarray(jcpt.multi_label_loss(jout, cpts)), **TOL)


def test_concept_gradients_match_jax_grad(settings):
    jp = jcpt.init_params(jax.random.PRNGKey(2), N_CONCEPTS, settings)
    fc, cpts = _concept_batch(settings, seed=4)
    _assert_grads(
        lambda tp, dt: tcpt.multi_label_loss(
            tcpt.forward(tp, t(fc).to(dt), deterministic=False),
            t(cpts).to(dt)),
        lambda p: jcpt.multi_label_loss(
            jcpt.forward(p, fc.astype(np.float64), dropout_p=0.0,
                         deterministic=False), cpts.astype(np.float64)),
        jp)


def test_multi_label_loss_clamps_saturated_scores():
    """Scores of exactly 0 and 1, on and off target: both logs clamped at
    1e-12, so the loss is finite and the JAX package's."""
    result = np.asarray([[0.0, 1.0, 0.5, 1.0], [1.0, 0.0, 0.0, 0.25]],
                        np.float32)
    target = np.asarray([[1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.0]],
                        np.float32)
    rows = n(tcpt.multi_label_loss_rows(t(result), t(target)))
    assert np.isfinite(rows).all()
    np.testing.assert_allclose(
        rows, np.asarray(jcpt.multi_label_loss_rows(result, target)), **TOL)
    # the clamp gives -log(1e-12) = 27.63 for each saturated miss
    np.testing.assert_allclose(rows[0], (2 * -np.log(1e-12) - np.log(0.5))
                               / 4, rtol=1e-6)
    np.testing.assert_allclose(
        n(tcpt.multi_label_loss(t(result), t(target))),
        np.asarray(jcpt.multi_label_loss(result, target)), **TOL)


@pytest.mark.parametrize("head", ["standard", "full"])
def test_detector_training_forward_and_losses_match_jax(settings, head):
    s, jmod, tmod, jp, tp = _detector(settings, head)
    _, att, _ = features(settings, BS, 5)
    labels = _labels(5)
    jl, jsp = jmod.forward(jp, att, dropout_p=0.0,
                           rng=jax.random.PRNGKey(0), deterministic=False)
    tl, tsp = tmod.forward(tp, t(att), dropout_p=0.0,
                           gen=torch.Generator().manual_seed(0),
                           deterministic=False)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(n(tsp), np.asarray(jsp), **TOL)
    np.testing.assert_allclose(
        n(tmod.xent_loss(tp, t(att), t(labels), dropout_p=0.0, gen=None,
                         deterministic=False)),
        np.asarray(jmod.xent_loss(jp, att, labels, dropout_p=0.0,
                                  rng=jax.random.PRNGKey(0),
                                  deterministic=False)), **TOL)
    np.testing.assert_allclose(
        n(tmod.xent_nll_rows(tp, t(att), t(labels))),
        np.asarray(jmod.xent_nll_rows(jp, att, labels)), **TOL)


@pytest.mark.parametrize("head", ["standard", "full"])
def test_detector_gradients_match_jax_grad(settings, head):
    s, jmod, tmod, jp, _ = _detector(settings, head, seed=6)
    _, att, _ = features(settings, BS, 6)
    labels = _labels(6)
    _assert_grads(
        lambda tp, dt: tmod.xent_loss(tp, t(att).to(dt), t(labels),
                                      dropout_p=0.0, gen=None,
                                      deterministic=False),
        lambda p: jmod.xent_loss(p, att.astype(np.float64), labels,
                                 dropout_p=0.0, rng=jax.random.PRNGKey(0),
                                 deterministic=False),
        jp)


def _mask_doubles(calls):
    """nn.dropout for both packages drawing the same numpy mask at the
    i-th train-mode call, recording the shapes it was given."""
    def double(where):
        def dropout(key, x, rate, deterministic):
            if deterministic or rate == 0.0:
                return x
            i = len(calls[where])
            calls[where].append(tuple(x.shape))
            keep = 1.0 - rate
            mask = np.random.default_rng(700 + i).random(x.shape) < keep
            if where == "torch":
                return torch.where(torch.from_numpy(mask), x / keep,
                                   torch.zeros((), dtype=x.dtype))
            return jnp.where(mask, x / keep, 0.0).astype(x.dtype)
        return dropout
    return double("jax"), double("torch")


def test_concept_dropout_placement_matches_jax(settings, monkeypatch):
    """One site, between fc2's ReLU and fc3: the same mask gives the same
    scores and loss."""
    jp = jcpt.init_params(jax.random.PRNGKey(2), N_CONCEPTS, settings)
    tp = to_port(jp)
    fc, cpts = _concept_batch(settings, seed=8)
    calls = {"jax": [], "torch": []}
    jd, td = _mask_doubles(calls)
    monkeypatch.setattr(jnn, "dropout", jd)
    monkeypatch.setattr(tnn, "dropout", td)
    jout = jcpt.forward(jp, fc, dropout_p=0.5, rng=jax.random.PRNGKey(0),
                        deterministic=False)
    tout = tcpt.forward(tp, t(fc), dropout_p=0.5,
                        gen=torch.Generator().manual_seed(0),
                        deterministic=False)
    assert calls["torch"] == calls["jax"] == [(BS,
                                               settings.concept_mid_dim)]
    np.testing.assert_allclose(n(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(
        n(tcpt.multi_label_loss(tout, t(cpts))),
        np.asarray(jcpt.multi_label_loss(jout, cpts)), **TOL)


@pytest.mark.parametrize("head", ["standard", "full"])
def test_detector_dropout_placement_matches_jax(settings, head,
                                                monkeypatch):
    """One site, on the conv stack's output before its ReLU: the same mask
    gives the same logits and loss."""
    s, jmod, tmod, jp, tp = _detector(settings, head, seed=9)
    _, att, _ = features(settings, BS, 9)
    labels = _labels(9)
    calls = {"jax": [], "torch": []}
    jd, td = _mask_doubles(calls)
    monkeypatch.setattr(jnn, "dropout", jd)
    monkeypatch.setattr(tnn, "dropout", td)
    jloss = jmod.xent_loss(jp, att, labels, dropout_p=0.5,
                           rng=jax.random.PRNGKey(0), deterministic=False)
    tloss = tmod.xent_loss(tp, t(att), t(labels), dropout_p=0.5,
                           gen=torch.Generator().manual_seed(0),
                           deterministic=False)
    width = s.fc_feat_dim // 2 ** s.sentiment_convs_num
    assert calls["torch"] == calls["jax"] == [(BS, 14, 14, width)]
    np.testing.assert_allclose(n(tloss), np.asarray(jloss), **TOL)


@pytest.mark.parametrize("head", ["standard", "full"])
def test_detector_dropout_statistics(settings, head):
    """The port's own mask on the conv stack's output: about half the
    positive activations kept, each doubled; a fresh mask from another
    seed; none in a deterministic forward."""
    s, _, tmod, _, tp = _detector(settings, head, seed=10)
    _, att, _ = features(settings, BS, 10)
    ref, _ = tsd.conv_stack(tp, t(att))
    outs = [tsd.conv_stack(tp, t(att), dropout_p=0.5,
                           gen=torch.Generator().manual_seed(seed),
                           deterministic=False)[0] for seed in (0, 1)]
    pos = ref > 0
    for out in outs:
        kept = out[pos] != 0
        assert 0.45 < float(kept.float().mean()) < 0.55
        torch.testing.assert_close(out[pos][kept], 2 * ref[pos][kept])
        assert not out[~pos].any()
    assert not torch.equal(outs[0], outs[1])
    torch.testing.assert_close(
        tsd.conv_stack(tp, t(att), dropout_p=0.5, deterministic=True)[0],
        ref, rtol=0, atol=0)

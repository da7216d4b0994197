"""The port's sentence sentiment classifier against the JAX package's on the
CPU, in f32 at the conftest widths: logits and per-token weights at every
length 1..T, labels, losses, gradients and dropout's placement.

Tolerances: 1e-5 relative and absolute for values, 1e-4 relative plus
1e-6 absolute for gradients; labels identical (the seeds used give no
near-tie: the top two logits differ by more than 1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import nn as jnn
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.models import sent_senti_cls as tss
from torch_parity import (V, classifier_params, jax_flat, jax_numpy, n,
                          port_settings, t)

TOL = dict(rtol=1e-5, atol=1e-5)
T = 8
BS = 6


def _seqs(seed, lengths):
    g = np.random.default_rng(seed)
    seqs = np.zeros((len(lengths), T), np.int32)
    for i, L in enumerate(lengths):
        seqs[i, :L] = g.integers(4, V, size=L)
    return seqs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("length", range(1, T + 1))
def test_forward_matches_jax_at_every_length(settings, length):
    """Rows of the given length beside rows of other lengths: the mask
    applied to the LSTM outputs and again to the excitation."""
    jp, tp = classifier_params(settings)
    lengths = [length, length, 1 + (length % T), T, max(1, length - 1),
               length]
    seqs, lens = _seqs(length, lengths)
    jl, jw = jss.forward(jp, seqs, lens, settings=settings)
    tl, tw = tss.forward(tp, t(seqs), t(lens),
                         settings=port_settings(settings))
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(n(tw), np.asarray(jw), **TOL)
    assert not n(tw)[0, length:].any()


def test_init_params_shapes_match_jax(settings):
    from insenticap_model_tpu_torch import convert
    jp = jss.init_params(jax.random.PRNGKey(0), V, 3, settings)
    tp = tss.init_params(torch.Generator().manual_seed(0), V, 3,
                         port_settings(settings), device="cpu")
    got = jax.tree_util.tree_map(np.shape, convert.to_jax_numpy(tp))
    assert got == jax.tree_util.tree_map(np.shape, jp)
    assert tnn.param_count(tp) == jnn.param_count(jp)


def test_sample_and_losses_match_jax(settings):
    jp, tp = classifier_params(settings)
    seqs, lens = _seqs(20, [1, 3, 8, 5, 2, 7])
    labels = np.asarray([0, 1, 2, 2, 1, 0], np.int32)
    logits, _ = jss.forward(jp, seqs, lens, settings=settings)
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
    ps = port_settings(settings)
    jlab, _ = jss.sample(jp, seqs, lens, settings=settings)
    tlab, _ = tss.sample(tp, t(seqs), t(lens), settings=ps)
    assert tlab.dtype == torch.int32
    np.testing.assert_array_equal(n(tlab), np.asarray(jlab))
    np.testing.assert_allclose(
        n(tss.xent_nll_rows(tp, t(seqs), t(lens), t(labels), settings=ps)),
        np.asarray(jss.xent_nll_rows(jp, seqs, lens, labels,
                                     settings=settings)), **TOL)
    np.testing.assert_allclose(
        n(tss.xent_loss(tp, t(seqs), t(lens), t(labels), settings=ps,
                        gen=None, deterministic=True)),
        np.asarray(jss.xent_loss(jp, seqs, lens, labels, settings=settings,
                                 rng=jax.random.PRNGKey(0),
                                 deterministic=True)), **TOL)


def test_gradients_match_jax_grad(settings):
    jp, tp = classifier_params(settings)
    seqs, lens = _seqs(21, [2, 8, 4, 1, 6, 3])
    labels = np.asarray([2, 0, 1, 1, 0, 2], np.int32)
    jg = jax.grad(lambda p: jss.xent_loss(
        p, seqs, lens, labels, settings=settings, rng=jax.random.PRNGKey(0),
        deterministic=True))(jp)
    tp = tnn.tree_map(lambda x: x.requires_grad_(True), tp)
    tss.xent_loss(tp, t(seqs), t(lens), t(labels),
                  settings=port_settings(settings), gen=None,
                  deterministic=True).backward()
    got = jax_numpy(tnn.tree_map(lambda x: x.grad, tp))
    want = jax_flat(jg)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, w) in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_dropout_placement_matches_jax(settings, monkeypatch):
    """The three train-mode sites (embedding, LSTM outputs, cls1) get the
    same numpy masks in both packages, call for call."""
    jp, tp = classifier_params(settings)
    seqs, lens = _seqs(22, [3, 8, 1, 5, 7, 2])
    calls = {"jax": [], "torch": []}

    def double(where):
        def dropout(key, x, rate, deterministic):
            if deterministic or rate == 0.0:
                return x
            i = len(calls[where])
            calls[where].append(tuple(x.shape))
            keep = 1.0 - rate
            mask = np.random.default_rng(500 + i).random(x.shape) < keep
            if where == "torch":
                return torch.where(torch.from_numpy(mask), x / keep,
                                   torch.zeros((), dtype=x.dtype))
            return jnp.where(mask, x / keep, 0.0).astype(x.dtype)
        return dropout
    monkeypatch.setattr(jnn, "dropout", double("jax"))
    monkeypatch.setattr(tnn, "dropout", double("torch"))
    jl, jw = jss.forward(jp, seqs, lens, settings=settings,
                         rng=jax.random.PRNGKey(0), deterministic=False)
    tl, tw = tss.forward(tp, t(seqs), t(lens),
                         settings=port_settings(settings),
                         gen=torch.Generator().manual_seed(0),
                         deterministic=False)
    H, We = settings.rnn_hid_dim, settings.word_emb_dim
    assert calls["torch"] == calls["jax"] == [(BS, T, We), (BS, T, H),
                                              (BS, H)]
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(n(tw), np.asarray(jw), **TOL)

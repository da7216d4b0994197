"""The port's checkpoint reader and writer for training: the sentence
classifier's trees, and the optimizer state both ways between the
packages, on the CPU in f32.

Reading is exact (bit-identical leaves). A continuation from the other
package's file is held to the XE step's parity tolerance
(``torch_parity.assert_params_match``): 1e-6 absolute, the two
softmax-invariant attention-score biases within lr * steps.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.training import steps as jsteps
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.training import checkpoint as tck
from insenticap_model_tpu_torch.training import optim as topt
from insenticap_model_tpu_torch.training import steps as tsteps
from torch_parity import (assert_params_match, caption_batches,
                          captioner_params, classifier_params, jax_flat,
                          jax_numpy, port_settings, t)

LR = 4e-4


def _meta(settings, vocab, **kw):
    return {"settings": settings.to_dict(), "idx2word": vocab.idx2word,
            "sentiment_categories": ["positive", "negative", "neutral"],
            **kw}


def _assert_exact(port_tree, jax_tree):
    got, want = jax_numpy(port_tree), jax_flat(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_reads_a_bare_sentence_classifier(tmp_path, settings, vocab):
    """The classifier's tree has a word_embed too: it must not be taken
    for a captioner."""
    jp, _ = classifier_params(settings)
    path = str(tmp_path / "cls.ckpt")
    jck.save(path, jp, None, _meta(settings, vocab))
    got, meta = tck.load(path, device="cpu")
    assert set(got) == {"word_embed", "lstm", "excitation1", "excitation2",
                        "cls1", "cls2"}
    _assert_exact(got, jp)


def test_reads_the_rl_composite_with_its_classifier(tmp_path, settings,
                                                    vocab):
    jc, _ = captioner_params(settings)
    jd = jsd.init_params(jax.random.PRNGKey(3), 3, settings)
    js, _ = classifier_params(settings)
    path = str(tmp_path / "rl.ckpt")
    jck.save(path, {"captioner": jc, "senti_detector": jd,
                    "sent_senti_cls": js}, None, _meta(settings, vocab))
    got, _ = tck.load(path, device="cpu")
    assert set(got) == {"captioner", "senti_detector", "sent_senti_cls"}
    _assert_exact(got["sent_senti_cls"], js)
    _assert_exact(got["captioner"], jc)


def test_with_opt_state_on_a_file_without_one(tmp_path, settings, vocab):
    jp, _ = classifier_params(settings)
    path = str(tmp_path / "cls.ckpt")
    jck.save(path, jp, None, _meta(settings, vocab))
    params, state, meta = tck.load(path, device="cpu", with_opt_state=True)
    assert state is None and "settings" in meta


def test_checkpoint_name_matches_jax():
    got = tck.checkpoint_name("/ck/xe", 3, 6.123456, 3.5)
    want = jck.checkpoint_name("/ck/xe", 3, 6.123456, 3.5)
    # the stamp is the minute of the call
    pat = r"^/ck/xe/model_3_6\.1235_3\.5000_\d{4}-\d{4}\.ckpt$"
    assert re.match(pat, got) and re.match(pat, want)


def _xe_pair(settings):
    """JAX and port XE training at dropout 0 from the same weights."""
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    jp, tp = captioner_params(nodrop)
    jc, tc = classifier_params(nodrop)
    tx = jopt.make_optimizer(LR)
    jtrain, _ = jsteps.make_xe_steps(nodrop, tx)
    tp = tnn.tree_map(lambda x: x.requires_grad_(True), tp)
    adam = topt.Adam(tp, LR)
    return nodrop, jp, tp, jc, tc, tx, jtrain, adam


def _jstep(jtrain, jp, state, jc, i, settings):
    b, scs = caption_batches(settings, 8, seed=i)
    jp, state, _ = jtrain(jp, state, jc, b, scs, jax.random.PRNGKey(i),
                          jnp.float32(0.0))
    return jp, state


def _tstep(ttrain, tc, i, settings):
    b, scs = caption_batches(settings, 8, seed=i)
    ttrain(tc, {k: t(v) for k, v in b.items()},
           {k: t(v) for k, v in scs.items()},
           torch.Generator().manual_seed(i), 0.0)


def test_opt_state_resumes_across_packages(tmp_path, settings, vocab):
    """Both packages take 2 XE steps and save. The JAX package's load,
    with its own templates, reads the port's file and takes 2 more steps;
    the port reads the JAX package's file and takes 2 more. Each
    continuation matches the other package's own continuation."""
    nodrop, jp, tp, jc, tc, tx, jtrain, adam = _xe_pair(settings)
    ttrain, _ = tsteps.make_xe_steps(port_settings(nodrop), adam)
    state = tx.init(jp)
    for i in range(2):
        jp, state = _jstep(jtrain, jp, state, jc, i, nodrop)
        _tstep(ttrain, tc, i, nodrop)
    meta = _meta(nodrop, vocab, epoch=0, lr=LR)
    tpath, jpath = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    tck.save(tpath, tp, topt.to_optax_state(adam), meta)
    jck.save(jpath, jp, state, meta)

    # the JAX package continues from the port's file
    jp_t, state_t, _ = jck.load(tpath, jax.tree_util.tree_map(
        jnp.zeros_like, jp), tx.init(jp))
    assert int(state_t.count) == 2
    # the port continues from the JAX package's file
    tp_j, ostate, _ = tck.load(jpath, device="cpu", with_opt_state=True)
    tp_j = tnn.tree_map(lambda x: x.requires_grad_(True), tp_j)
    adam_j = topt.Adam(tp_j, 1.0)
    topt.load_optax_state(adam_j, ostate)
    assert adam_j.count == 2 and adam_j.lr == pytest.approx(LR)
    ttrain_j, _ = tsteps.make_xe_steps(port_settings(nodrop), adam_j)

    for i in range(2, 4):
        jp, state = _jstep(jtrain, jp, state, jc, i, nodrop)
        jp_t, state_t = _jstep(jtrain, jp_t, state_t, jc, i, nodrop)
        _tstep(ttrain, tc, i, nodrop)
        _tstep(ttrain_j, tc, i, nodrop)
    assert_params_match(tp, jp_t, 4, LR)
    assert_params_match(tp_j, jp, 4, LR)


def test_port_file_is_the_jax_packages_file(tmp_path, settings, vocab):
    """The port's writer, given params and optimizer state, writes the
    bytes the JAX package's save writes for the same trees."""
    nodrop, _, tp, _, tc, _, _, adam = _xe_pair(settings)
    ttrain, _ = tsteps.make_xe_steps(port_settings(nodrop), adam)
    _tstep(ttrain, tc, 0, nodrop)
    state = topt.to_optax_state(adam)
    meta = _meta(nodrop, vocab, epoch=0, lr=LR)
    tpath, jpath = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    tck.save(tpath, tp, state, meta)
    from insenticap_model_tpu_torch import convert
    as_np = jax.tree_util.tree_map(
        lambda x: np.asarray(x), dict(state, inner_state={
            str(i): s for i, s in enumerate(state["inner_state"])}))
    jck.save(jpath, convert.to_jax_numpy(tp), as_np, meta)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()

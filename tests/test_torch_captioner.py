"""The port's captioner serving parts and the plain twin of the beam-shared
attention kernel, against the JAX package on the CPU in f32.

Tolerances: the context embedding and decode cell 1e-5 (the same f32 math
in other summation orders, through a few layers); the attention 2e-5 (the
twin drops att_alpha's bias, which cancels in the softmax, and sums in
another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.ops.fused_attention import \
    beam_content_attention as jax_beam_att

from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.ops import beam as tbeam
from insenticap_model_tpu_torch.ops import fused_attention as tfa

from torch_parity import captioner_params, features, n, t

CTX_TOL = dict(rtol=1e-5, atol=1e-5)
ATT_TOL = dict(rtol=2e-5, atol=2e-5)


def _contexts(jp, tp, settings, bs, seed, senti=True):
    fc, att, sentis = features(settings, bs, seed)
    labels = np.arange(bs, dtype=np.int32) % 3
    jctx, _ = jcap.build_visual_context(
        jp, jnp.asarray(fc), jnp.asarray(att), settings.dropout_p,
        jax.random.PRNGKey(0), True,
        senti_words=jnp.asarray(sentis) if senti else None,
        senti_labels=jnp.asarray(labels) if senti else None)
    tctx = tcap.build_visual_context(
        tp, t(fc), t(att), senti_words=t(sentis) if senti else None,
        senti_labels=t(labels) if senti else None)
    return jctx, tctx


@pytest.mark.parametrize("senti", [True, False])
def test_build_visual_context(settings, senti):
    jp, tp = captioner_params(settings)
    jctx, tctx = _contexts(jp, tp, settings, 3, 0, senti)
    for name, a, b in zip(jcap.DecodeContext._fields, jctx, tctx):
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(n(b), n(a), err_msg=name, **CTX_TOL)


@pytest.mark.parametrize("mode", ["xe", "rl", "seq2seq"])
def test_decode_cell_and_step(settings, mode):
    jp, tp = captioner_params(settings)
    jctx, tctx = _contexts(jp, tp, settings, 4, 1)
    g = np.random.default_rng(2)
    H = settings.rnn_hid_dim
    st = [g.normal(size=(4, H)).astype(np.float32) for _ in range(4)]
    it = np.array([2, 5, 0, 9], np.int32)
    jout, jstate, jw = jcap.decode_cell(
        jp, jctx, jcap.DecodeState(*map(jnp.asarray, st)), jnp.asarray(it),
        mode=mode, dropout_p=0.0, drop_key=jax.random.PRNGKey(0),
        deterministic=True)
    tout, tstate, tw = tcap.decode_cell(
        tp, tctx, tcap.DecodeState(*map(t, st)), t(it), mode=mode)
    np.testing.assert_allclose(n(tout), n(jout), **CTX_TOL)
    for a, b in zip(jstate, tstate):
        np.testing.assert_allclose(n(b), n(a), **CTX_TOL)
    assert set(jw) == set(tw)
    for k in jw:
        np.testing.assert_allclose(n(tw[k]), n(jw[k]), err_msg=k,
                                   **CTX_TOL)
    jlp, _, _ = jcap.decode_step(
        jp, jctx, jcap.DecodeState(*map(jnp.asarray, st)), jnp.asarray(it),
        mode=mode, dropout_p=0.0, drop_key=jax.random.PRNGKey(0),
        deterministic=True)
    tlp, _, _ = tcap.decode_step(tp, tctx, tcap.DecodeState(*map(t, st)),
                                 t(it), mode=mode)
    np.testing.assert_allclose(n(tlp), n(jlp), **CTX_TOL)


def _attention_inputs(settings, bs, B, seed):
    g = np.random.default_rng(seed)
    N = 196
    h = g.normal(size=(bs * B, settings.rnn_hid_dim)).astype(np.float32)
    att = g.random((bs, N, settings.feat_emb_dim), np.float32)
    p_att = g.random((bs, N, settings.att_hid_dim), np.float32)
    return h, att, p_att


@pytest.mark.parametrize("bs,B", [(4, 3), (8, 2)])
def test_attention_twin_matches_jax_kernel_interpret(settings, bs, B):
    """The plain twin against the Pallas kernel in interpret mode."""
    jp, tp = captioner_params(settings)
    h, att, p_att = _attention_inputs(settings, bs, B, 3)
    want = jax_beam_att(jnp.asarray(h), jp["attention"]["cont"],
                        jnp.asarray(att), jnp.asarray(p_att), B=B,
                        tile_b=4, interpret=True)
    got = tfa.beam_content_attention(t(h), tp["attention"]["cont"], t(att),
                                     t(p_att), B=B)
    assert got.shape == (bs * B, settings.feat_emb_dim)
    np.testing.assert_allclose(n(got), n(want), **ATT_TOL)


def test_attention_twin_matches_content_attention(settings):
    """Against the tiled-rows content_attention (which keeps alpha's
    bias) on the beam-repeated context."""
    jp, tp = captioner_params(settings)
    bs, B = 5, 3
    h, att, p_att = _attention_inputs(settings, bs, B, 4)
    want, _ = jcap.content_attention(
        jp["attention"]["cont"], jnp.asarray(h),
        jnp.repeat(jnp.asarray(att), B, axis=0),
        jnp.repeat(jnp.asarray(p_att), B, axis=0))
    got = tfa.beam_content_attention_plain(t(h), tp["attention"]["cont"],
                                           t(att), t(p_att), B=B)
    np.testing.assert_allclose(n(got), n(want), **ATT_TOL)
    port, _ = tcap.content_attention(
        tp["attention"]["cont"], t(h), t(att).repeat_interleave(B, 0),
        t(p_att).repeat_interleave(B, 0))
    np.testing.assert_allclose(n(got), n(port), **ATT_TOL)


@pytest.mark.parametrize("mode", ["xe", "rl"])
def test_shared_attention_cell_matches_tiled_cell(settings, mode):
    """The decode cell that the card runs (beam-shared attention, here
    through its plain twin) equals the tiled-rows cell."""
    jp, tp = captioner_params(settings)
    _, tctx = _contexts(jp, tp, settings, 3, 5)
    B = 3
    g = np.random.default_rng(6)
    H = settings.rnn_hid_dim
    st = tcap.DecodeState(*(t(g.normal(size=(3 * B, H)).astype(np.float32))
                            for _ in range(4)))
    last = t(np.array([2, 7, 9] * 3, np.int64))
    bctx = tbeam._tile_ctx(tctx, B)
    sctx = tbeam._tile_ctx(tctx._replace(att=None, p_att=None), B)
    want, wstate, _ = tcap.decode_cell(tp, bctx, st, last, mode=mode)
    got, gstate = tbeam._decode_cell_shared_att(tp, sctx, tctx.att,
                                                tctx.p_att, st, last,
                                                mode=mode, B=B)
    np.testing.assert_allclose(n(got), n(want), **ATT_TOL)
    for a, b in zip(wstate, gstate):
        np.testing.assert_allclose(n(b), n(a), **ATT_TOL)


def test_attention_wrapper_counts_only_kernel_launches(settings):
    """On a CPU tensor the wrapper runs the twin and counts nothing."""
    _, tp = captioner_params(settings)
    h, att, p_att = _attention_inputs(settings, 2, 3, 7)
    before = tfa.beam_content_attention.launches
    out = tfa.beam_content_attention(t(h), tp["attention"]["cont"], t(att),
                                     t(p_att), B=3)
    assert tfa.beam_content_attention.launches == before
    assert out.dtype == torch.float32
    bf = tfa.beam_content_attention(
        t(h).bfloat16(), {k: {kk: vv.bfloat16() for kk, vv in v.items()}
                          for k, v in tp["attention"]["cont"].items()},
        t(att).bfloat16(), t(p_att).bfloat16(), B=3)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(n(bf), n(out), rtol=5e-2, atol=5e-2)

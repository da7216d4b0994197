"""The port's beam-shared attention, variant v2 (its plain version, which
the CPU runs) against the JAX package's ``_kernel_v2`` in interpret mode:
f32 within 2e-5 (the JAX test's own tolerance, tests/test_fused_topk.py),
bf16 within one bf16 rounding of the output (rtol 1e-2) plus 1e-3 of its
scale. Also: ISC_ATT_KERNEL is read in the wrapper at each call."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import nn as jnn
from insenticap_model_tpu.ops.fused_attention import (
    beam_content_attention as jax_att)

from insenticap_model_tpu_torch.ops import fused_attention as fa

from torch_parity import n, to_port

BS, B, N, H, Ah, Fe = 8, 3, 49, 32, 32, 40


def _inputs(seed, dtype=jnp.float32):
    g = np.random.default_rng(seed)
    p_cont = {"h2att": jnn.linear_init(jax.random.PRNGKey(seed), H, Ah),
              "att_alpha": jnn.linear_init(jax.random.PRNGKey(seed + 1), Ah,
                                           1)}
    h = g.normal(size=(BS * B, H)).astype(np.float32)
    att = g.random((BS, N, Fe)).astype(np.float32)
    p_att = g.normal(size=(BS, N, Ah)).astype(np.float32)
    p_cont = jax.tree_util.tree_map(lambda x: x.astype(dtype), p_cont)
    return p_cont, h, att, p_att


def _port_args(p_cont, h, att, p_att, dtype):
    return (torch.from_numpy(h).to(dtype), to_port(p_cont),
            torch.from_numpy(att).to(dtype), torch.from_numpy(p_att).to(dtype))


def test_plain_v2_matches_jax_kernel_f32():
    p_cont, h, att, p_att = _inputs(0)
    want = jax_att(jnp.asarray(h), p_cont, jnp.asarray(att),
                   jnp.asarray(p_att), B=B, tile_b=4, interpret=True,
                   variant="v2")
    got = fa.beam_content_attention_plain(
        *_port_args(p_cont, h, att, p_att, torch.float32), B=B, variant="v2")
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=2e-5)
    # in f32 v2 is v1's function
    v1 = fa.beam_content_attention_plain(
        *_port_args(p_cont, h, att, p_att, torch.float32), B=B)
    np.testing.assert_array_equal(n(got), n(v1))


def test_plain_v2_matches_jax_kernel_bf16():
    p_cont, h, att, p_att = _inputs(1, jnp.bfloat16)
    cast = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(jax_att(cast(h), p_cont, cast(att), cast(p_att), B=B,
                              tile_b=4, interpret=True, variant="v2"),
                      np.float32)
    got = n(fa.beam_content_attention_plain(
        *_port_args(p_cont, h, att, p_att, torch.bfloat16), B=B,
        variant="v2"))
    tol = 1e-2 * np.abs(want) + 1e-3 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_v2_rounds_the_weights_to_atts_dtype():
    """bf16: v2 applies the rounding the JAX v2 kernel applies; v1 does
    not, so the two differ somewhere while staying within a rounding."""
    p_cont, h, att, p_att = _inputs(2, jnp.bfloat16)
    args = _port_args(p_cont, h, att, p_att, torch.bfloat16)
    v1 = fa.beam_content_attention_plain(*args, B=B, variant="v1")
    v2 = fa.beam_content_attention_plain(*args, B=B, variant="v2")
    assert not torch.equal(v1, v2)
    torch.testing.assert_close(v1.float(), v2.float(), rtol=2e-2, atol=1e-2)


def test_env_switch_is_read_in_the_wrapper(monkeypatch):
    p_cont, h, att, p_att = _inputs(3)
    args = _port_args(p_cont, h, att, p_att, torch.float32)
    seen = []
    real = fa.beam_content_attention_plain

    def spy(*a, variant, **kw):
        seen.append(variant)
        return real(*a, variant=variant, **kw)
    monkeypatch.setattr(fa, "beam_content_attention_plain", spy)
    monkeypatch.delenv("ISC_ATT_KERNEL", raising=False)
    fa.beam_content_attention(*args, B=B)
    monkeypatch.setenv("ISC_ATT_KERNEL", "v2")
    fa.beam_content_attention(*args, B=B)
    fa.beam_content_attention(*args, B=B, variant="v1")   # explicit wins
    assert seen == ["v1", "v2", "v1"]
    monkeypatch.setenv("ISC_ATT_KERNEL", "v3")
    with pytest.raises(ValueError, match="v3"):
        fa.beam_content_attention(*args, B=B)

"""The port's int8-storage beam attention (``ops/fused_attention_i8``)
against the int8 study's Pallas kernel ``tools/bench_int8.py``
``_kernel_i8`` in interpret mode, and its quantiser against the study's
``quant``, bit for bit. Both are nested in ``attention()`` there, with no
free variables, so they are rebuilt from its code object. The plain
version and the Pallas kernel each sum in f32 and round once to bf16, so
they agree within one bf16 ulp (taken at no less than 1e-3 of the output's
scale)."""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.bench_int8 as bench_int8
from insenticap_model_tpu_torch.ops import fused_attention as fa
from insenticap_model_tpu_torch.ops import fused_attention_i8 as fa8

from torch_parity import assert_within_bf16_ulp, n, to_port

_NESTED = {c.co_name: c for c in bench_int8.attention.__code__.co_consts
           if isinstance(c, types.CodeType)}
quant = types.FunctionType(_NESTED["quant"], vars(bench_int8))
_kernel_i8 = types.FunctionType(_NESTED["_kernel_i8"], vars(bench_int8))

BS, N, W, B, TILE_B = 8, 12, 16, 3, 4


def _pallas_i8(h, pattq, patts, attq, atts, p_cont, *, B, tile_b):
    """bench_int8.py:302-334's pallas_call, in interpret mode."""
    bs, n_reg, Ah = pattq.shape
    Fe = attq.shape[2]
    w = p_cont["h2att"]["w"]
    b = p_cont["h2att"]["b"].reshape(1, -1)
    aw = p_cont["att_alpha"]["w"]
    vmem = pltpu.VMEM
    out = pl.pallas_call(
        functools.partial(_kernel_i8, B=B, TB=tile_b),
        grid=(bs // tile_b,),
        in_specs=[
            pl.BlockSpec((tile_b * B, h.shape[1]), lambda i: (i, 0),
                         memory_space=vmem),
            pl.BlockSpec((tile_b, n_reg, Ah), lambda i: (i, 0, 0),
                         memory_space=vmem),
            pl.BlockSpec((tile_b, 1, Ah), lambda i: (i, 0, 0),
                         memory_space=vmem),
            pl.BlockSpec((tile_b, n_reg, Fe), lambda i: (i, 0, 0),
                         memory_space=vmem),
            pl.BlockSpec((tile_b, 1, Fe), lambda i: (i, 0, 0),
                         memory_space=vmem),
            pl.BlockSpec(w.shape, lambda i: (0, 0), memory_space=vmem),
            pl.BlockSpec((1, b.shape[1]), lambda i: (0, 0),
                         memory_space=vmem),
            pl.BlockSpec((aw.shape[0], 1), lambda i: (0, 0),
                         memory_space=vmem),
        ],
        out_specs=pl.BlockSpec((tile_b, B, Fe), lambda i: (i, 0, 0),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((bs, B, Fe), jnp.bfloat16),
        interpret=True,
    )(h, pattq, patts, attq, atts, w, b, aw)
    return out.reshape(bs * B, Fe)


def _inputs(seed, bs=BS, n_reg=N, width=W, beam=B):
    """The study's inputs at a small size: normal att/p_att, h x 0.1, W and
    alpha x 0.05, a zero bias; JAX's {"w", "b"} weights in bf16."""
    g = np.random.default_rng(seed)
    att_f = g.normal(size=(bs, n_reg, width)).astype(np.float32)
    patt_f = g.normal(size=(bs, n_reg, width)).astype(np.float32)
    h = jnp.asarray(g.normal(size=(bs * beam, width)) * 0.1, jnp.bfloat16)
    p_cont = {"h2att": {"w": jnp.asarray(g.normal(size=(width, width))
                                         * 0.05, jnp.bfloat16),
                        "b": jnp.zeros((width,), jnp.bfloat16)},
              "att_alpha": {"w": jnp.asarray(g.normal(size=(width, 1))
                                             * 0.05, jnp.bfloat16)}}
    return h, p_cont, att_f, patt_f


def _port(h, p_cont, att_f, patt_f):
    th = torch.from_numpy(np.asarray(h, np.float32)).bfloat16()
    aq, as_ = fa8.quantize_per_channel(torch.from_numpy(att_f))
    pq, ps = fa8.quantize_per_channel(torch.from_numpy(patt_f))
    return th, to_port(p_cont), aq, as_, pq, ps


@pytest.mark.parametrize("shape,scale", [((8, 12, 16), 1.0),
                                         ((3, 196, 40), 0.01),
                                         ((2, 5, 7), 300.0)])
def test_quantizer_equals_the_studys_quant(shape, scale):
    x = (np.random.default_rng(sum(shape)).normal(size=shape)
         * scale).astype(np.float32)
    x[0, :, 0] = 0.0                  # an all-zero channel: s = 1e-12
    jq, js = quant(x)
    tq, ts = fa8.quantize_per_channel(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (shape[0], 1, shape[2])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_i8(seed):
    h, p_cont, att_f, patt_f = _inputs(seed)
    att_q, att_s = quant(att_f)
    patt_q, patt_s = quant(patt_f)
    want = _pallas_i8(h, patt_q, patt_s, att_q, att_s, p_cont, B=B,
                      tile_b=TILE_B)
    got = fa8.beam_content_attention_i8_plain(*_port(h, p_cont, att_f,
                                                     patt_f), B=B)
    assert got.dtype == torch.bfloat16 and got.shape == (BS * B, W)
    assert_within_bf16_ulp(got, np.asarray(want, np.float32))


def test_plain_in_f32_is_v1_on_the_dequantised_tensors():
    h, p_cont, att_q, att_s, p_att_q, p_att_s = _port(*_inputs(2))
    got = fa8.beam_content_attention_i8_plain(
        h, p_cont, att_q, att_s, p_att_q, p_att_s, B=B,
        out_dtype=torch.float32)
    want = fa.beam_content_attention_plain(
        h, p_cont, fa8.dequantize(att_q, att_s),
        fa8.dequantize(p_att_q, p_att_s), B=B)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _port(*_inputs(3))
    before = fa8.beam_content_attention_i8.launches
    got = fa8.beam_content_attention_i8(*args, B=B)
    assert fa8.beam_content_attention_i8.launches == before
    assert torch.equal(got, fa8.beam_content_attention_i8_plain(*args, B=B))


@pytest.mark.parametrize("exact_tanh", [False, True])
def test_wrapper_takes_exact_tanh_and_the_plain_version_on_the_cpu(
        exact_tanh):
    """``exact_tanh`` picks the kernel's tanh on the card; on the CPU it is
    accepted and the plain version runs as without it."""
    args = _port(*_inputs(5))
    before = fa8.beam_content_attention_i8.launches
    got = fa8.beam_content_attention_i8(*args, B=B, exact_tanh=exact_tanh)
    assert fa8.beam_content_attention_i8.launches == before
    assert torch.equal(got, fa8.beam_content_attention_i8_plain(*args, B=B))


def _bad(h, p, aq, as_, pq, ps):
    f32 = {k: {kk: vv.float() for kk, vv in v.items()} for k, v in p.items()}
    return [
        (TypeError, (h.float(), p, aq, as_, pq, ps)),        # h vs W
        (TypeError, (h.half(), {k: {kk: vv.half() for kk, vv in v.items()}
                                for k, v in p.items()}, aq, as_, pq, ps)),
        (TypeError, (h, p, aq.int(), as_, pq, ps)),           # not int8
        (TypeError, (h, p, aq, as_.double(), pq, ps)),        # scale type
        (ValueError, (h[:-1], p, aq, as_, pq, ps)),           # rows
        (ValueError, (h, p, aq, as_[:, :, :-1], pq, ps)),     # scale shape
        (ValueError, (h, p, aq, as_, pq[:, :-1], ps)),        # p_att regions
        (ValueError, (h.float(), f32, aq[0], as_, pq, ps)),   # att_q rank
    ]


@pytest.mark.parametrize("case", range(8))
def test_wrapper_refuses_wrong_types_and_shapes(case):
    err, args = _bad(*_port(*_inputs(4)))[case]
    with pytest.raises(err):
        fa8.beam_content_attention_i8(*args, B=B)

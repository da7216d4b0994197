"""The port's int8 study (``tools/bench_torch_int8.py``) against the JAX
study (``tools/bench_int8.py``) on the CPU, and the decode-cell study's
H100 arithmetic (``tools/bench_torch_megacell.py``).

The int8 convolutions' int32 sums must equal ``lax.conv_general_dilated``
on int8 with ``preferred_element_type=int32`` exactly (bench_int8.py:185-
195); the whole stack's f32 output must be within 1e-5 of the JAX study's
own ``int8_fwd`` (rebuilt from its code object with the same weights:
both take the same int32 sums and the same few f32 operations)."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tools.bench_int8 as bench_int8
import tools.bench_torch_int8 as ti
import tools.bench_torch_megacell as tm

_STACK = {c.co_name: c for c in bench_int8.stack.__code__.co_consts
          if isinstance(c, types.CodeType)}
qw = types.FunctionType(_STACK["qw"], vars(bench_int8))

HW, C0, C1, C2, BS = 14, 32, 16, 8, 2


def _dn(cin, cout):
    return jax.lax.conv_dimension_numbers((BS, HW, HW, cin),
                                          (3, 3, cin, cout),
                                          ("NHWC", "HWIO", "NHWC"))


def _lax_int8_conv(x, w):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=_dn(x.shape[-1], w.shape[-1]),
        preferred_element_type=jnp.int32))


def _stack_inputs(seed=0):
    """The study's stack inputs at [2,14,14,32] -> 16 -> 8."""
    g = np.random.default_rng(seed)
    x = (np.abs(g.normal(size=(BS, HW, HW, C0))) * 0.5).astype(np.float32)
    w1 = (g.normal(size=(3, 3, C0, C1)) * 0.02).astype(np.float32)
    b1 = (g.normal(size=(C1,)) * 0.01).astype(np.float32)
    w2 = (g.normal(size=(3, 3, C1, C2)) * 0.02).astype(np.float32)
    b2 = (g.normal(size=(C2,)) * 0.01).astype(np.float32)
    return x, (w1, b1), (w2, b2)


def _port_qlayers(layers):
    return [ti.quantize_weight(torch.from_numpy(w)) + (torch.from_numpy(b),)
            for w, b in layers]


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_weight_equals_the_studys_qw(seed):
    w = _stack_inputs(seed)[1][0]
    jq, js = qw(w)
    tq, ts = ti.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_stack_int32_sums_equal_lax_conv():
    x, l1, l2 = _stack_inputs()
    out = ti.int8_stack(torch.from_numpy(x), _port_qlayers([l1, l2]))
    assert out["a1"].dtype == torch.int32 and out["a2"].dtype == torch.int32
    xq, _ = ti._quantize_tensor(torch.from_numpy(x))
    (w1q, _, _), (w2q, _, _) = _port_qlayers([l1, l2])
    np.testing.assert_array_equal(out["a1"].numpy(),
                                  _lax_int8_conv(xq.numpy(), w1q.numpy()))
    y1 = out["a1"].float() * (ti._quantize_tensor(torch.from_numpy(x))[1]
                              * _port_qlayers([l1])[0][1]) \
        + torch.from_numpy(l1[1])
    y1q, _ = ti._quantize_tensor(y1)
    np.testing.assert_array_equal(out["a2"].numpy(),
                                  _lax_int8_conv(y1q.numpy(), w2q.numpy()))


def test_int8_conv_sums_at_the_extremes():
    """All-±127 inputs and weights: the largest sums, still exact."""
    g = np.random.default_rng(5)
    x = np.where(g.random((BS, HW, HW, C0)) < 0.5, -127, 127).astype(np.int8)
    w = np.where(g.random((3, 3, C0, C1)) < 0.5, -127, 127).astype(np.int8)
    got = ti.conv3x3_int8(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), _lax_int8_conv(x, w))


def test_int8_stack_output_matches_the_jax_study():
    x, (w1, b1), (w2, b2) = _stack_inputs()
    w1q, w1s = qw(w1)
    w2q, w2s = qw(w2)
    env = {"C1": C1, "C2": C2, "H": HW, "W": HW, "b1j": jnp.asarray(b1),
           "b2j": jnp.asarray(b2), "dn": _dn(C0, C1), "w1q": w1q,
           "w1s": w1s, "w2q": w2q, "w2s": w2s}
    code = _STACK["int8_fwd"]
    int8_fwd = types.FunctionType(
        code, vars(bench_int8), None, None,
        tuple(types.CellType(env[k]) for k in code.co_freevars))
    want = np.asarray(jax.jit(int8_fwd)(jnp.asarray(x)))
    got = ti.int8_stack(torch.from_numpy(x), _port_qlayers(
        [(w1, b1), (w2, b2)]))["y"]
    assert got.dtype == torch.float32 and got.shape == (BS, HW, HW, C2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layer", [0, 1])
def test_int8_conv_sums_with_column_major_weights(layer):
    """The weights' layout (``col_major``) changes no value: the same
    int32 sums as lax.conv."""
    x, l1, l2 = _stack_inputs(3)
    wq, _ = ti.quantize_weight(torch.from_numpy((l1, l2)[layer][0]))
    cm = ti.col_major(wq)
    assert torch.equal(cm, wq) and cm[1, 2].t().is_contiguous()
    xq = ti._quantize_tensor(torch.from_numpy(x))[0][..., :wq.shape[2]]
    np.testing.assert_array_equal(ti.conv3x3_int8(xq, cm).numpy(),
                                  _lax_int8_conv(xq.numpy(), wq.numpy()))


def test_int_mm_takes_int8_only():
    with pytest.raises(TypeError):
        ti.int_mm(torch.zeros(32, 8), torch.zeros(8, 8, dtype=torch.int8))


def test_megacell_budget_is_the_h100s():
    rows = {b["tile_b"]: b for b in tm.budget()}
    assert sorted(rows) == [4, 8, 16]
    # bf16 att + p_att of one tile: tile_b x 196 regions x (512 + 512) x 2
    assert rows[4]["att_p_att_bytes"] == 4 * 196 * 1024 * 2 == 1_605_632
    assert rows[16]["att_p_att_bytes"] == 6_422_528
    assert not any(b["fits_shared_memory"] for b in rows.values())
    # att_lstm [1536, 2048] + lang_lstm [1024, 2048] bf16: 10.5 MB, in L2
    assert all(b["lstm_weight_bytes"] == 10_485_760 and b["weights_fit_l2"]
               for b in rows.values())
    assert [b["tile_rows"] for b in rows.values()] == [12, 24, 48]


@pytest.mark.parametrize("K,want_ms,by", [(1536, 0.00733, "operations"),
                                          (1024, 0.00489, "operations")])
def test_megacell_bounds(K, want_ms, by):
    ms, got_by = tm.bound_ms(K, 2048)
    assert got_by == by and abs(ms - want_ms) < 5e-5


@pytest.mark.parametrize("tool,argv", [(ti, ["bench_torch_int8.py",
                                             "attention"]),
                                       (tm, ["bench_torch_megacell.py"])])
def test_tools_refuse_to_run_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr("sys.argv", argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main()
    assert "needs a CUDA card" in str(e.value)

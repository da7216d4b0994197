"""The port's plain Winograd stack against the JAX package's Pallas stack
(``conv3x3_stack_sm(..., variant="f5")``) run in interpret mode on the CPU,
at [14, 14, 8, 32] through 32 -> 16 -> 8. Interpret mode costs about a
minute a call here, so this file holds only these two comparisons.

Tolerances: f32 2e-5 of the output scale (the same transforms, summed in
another order). bf16, at the same cast points (V, U and M rounded to bf16):
the RMS of their difference within 2e-2 of the output's RMS, and their
largest errors against the f32 direct chain equal within a quarter (the
port loses what the reference loses, no more). The largest single
difference is no measure here: where the two round one V or M entry to
neighbouring bf16 values, the inverse transform (constants up to 16)
amplifies that one ulp."""
import numpy as np
import pytest

import jax.numpy as jnp

from insenticap_model_tpu.ops.winograd_pallas import conv3x3_stack_sm

from insenticap_model_tpu_torch.ops import winograd_kernels as wk

from test_torch_winograd import _direct_chain, _layers
from torch_parity import n, t


@pytest.fixture(scope="module")
def case():
    g = np.random.default_rng(11)
    x = g.normal(size=(8, 14, 14, 32)).astype(np.float32)
    layers = _layers(g, (32, 16, 8))
    ref = _direct_chain(x, layers)
    return x, layers, ref, np.abs(ref).max()


def test_plain_stack_matches_pallas_interpret_f32(case):
    x, layers, ref, scale = case
    want = conv3x3_stack_sm(jnp.asarray(x).transpose(1, 2, 0, 3),
                            [(jnp.asarray(w), jnp.asarray(b))
                             for w, b in layers],
                            interpret=True, variant="f5")
    got = wk.conv3x3_stack_sm(t(x).permute(1, 2, 0, 3),
                              [(t(w), t(b)) for w, b in layers])
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=0,
                               atol=2e-5)


def test_plain_stack_matches_pallas_interpret_bf16(case):
    x, layers, ref, scale = case
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = conv3x3_stack_sm(jbf(x).transpose(1, 2, 0, 3),
                            [(jbf(w), jbf(b)) for w, b in layers],
                            interpret=True, variant="f5")
    want = np.asarray(want.astype(jnp.float32))
    got = wk.conv3x3_stack_sm(t(x).bfloat16().permute(1, 2, 0, 3),
                              [(t(w).bfloat16(), t(b).bfloat16())
                               for w, b in layers])
    got = n(got)
    rms = lambda a: np.sqrt(np.mean(np.square(a)))  # noqa: E731
    assert rms(got - want) <= 2e-2 * rms(want), (rms(got - want),
                                                 rms(want))
    ref_sm = ref.transpose(1, 2, 0, 3)
    err_port = np.abs(got - ref_sm).max() / scale
    err_jax = np.abs(want - ref_sm).max() / scale
    assert abs(err_port - err_jax) <= 0.25 * err_jax, (err_port, err_jax)

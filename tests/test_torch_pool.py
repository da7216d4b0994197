"""The port's plain ceil-mode max pool (``ops/pool.py``, what a CPU tensor
runs and what the card holds the kernel against) equals the JAX package's
Pallas kernel in interpret mode and its ``reduce_window`` definition, in
both public forms. Exact equality: max is exact in every dtype, including
the -inf ceil-pad band."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from insenticap_model_tpu.models.encoder import _ceil_maxpool_3x3s2
from insenticap_model_tpu.ops.pool_pallas import (ceil_maxpool_3x3s2_nhwc,
                                                  ceil_maxpool_3x3s2_sm)

from insenticap_model_tpu_torch.ops import pool


@pytest.mark.parametrize("shape", [
    (2, 14, 14, 8),     # even extents: the ceil pad row and column
    (1, 13, 13, 4),     # odd extents: no ceil pad
    (3, 9, 11, 8),      # H != W
    (1, 8, 8, 128),
    (2, 7, 7, 3),       # C = 3
    (2, 36, 26, 16),
    (9, 14, 14, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_pool_equals_pallas_and_reduce_window(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    xj = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(dtype)
    x32 = np.array(xj, np.float32)                    # exact for bf16
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    pallas = np.asarray(ceil_maxpool_3x3s2_nhwc(xj, interpret=True),
                        np.float32)
    rw = np.asarray(_ceil_maxpool_3x3s2(xj), np.float32)
    got = pool.ceil_maxpool_3x3s2_nhwc(xt)
    assert got.dtype == xt.dtype and got.shape == pallas.shape
    np.testing.assert_array_equal(got.float().numpy(), pallas)
    np.testing.assert_array_equal(got.float().numpy(), rw)
    np.testing.assert_array_equal(
        pool.ceil_maxpool_3x3s2_plain(xt).float().numpy(), rw)
    # the spatial-major form, against the Pallas kernel's own _sm entry
    sm_want = np.asarray(ceil_maxpool_3x3s2_sm(xj.transpose(1, 2, 0, 3),
                                               interpret=True), np.float32)
    sm_got = pool.ceil_maxpool_3x3s2_sm(xt.permute(1, 2, 0, 3))
    np.testing.assert_array_equal(sm_got.float().numpy(), sm_want)
    assert pool.out_extent(shape[1]) == pallas.shape[1]
    assert pool.out_extent(shape[2]) == pallas.shape[2]

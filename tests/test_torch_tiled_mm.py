"""The port's row-tiled product (``ops/tiled_mm``) against the decode-cell
study's Pallas kernel ``tools/bench_megacell.py`` ``_mm_kernel`` in
interpret mode, through the BlockSpecs of its ``pallas_tiled_mm``
(:84-96): f32 within 1e-6 of the output's scale (sums in another order),
bf16 within one bf16 ulp (both sum in f32 and round once)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools.bench_megacell import _mm_kernel
from insenticap_model_tpu_torch.ops import tiled_mm as tmm
from insenticap_model_tpu_torch.utils.tolerance import bf16_ulp_error

from torch_parity import assert_within_bf16_ulp, n


def _pallas_tiled_mm(x, w, tile_rows):
    rows, K = x.shape
    N = w.shape[1]
    return pl.pallas_call(
        _mm_kernel,
        grid=(rows // tile_rows,),
        in_specs=[pl.BlockSpec((tile_rows, K), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((K, N), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tile_rows, N), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, N), x.dtype),
        interpret=True,
    )(x, w)


def _inputs(rows, K, N, seed):
    g = np.random.default_rng(seed)
    return (g.normal(size=(rows, K)).astype(np.float32),
            (g.normal(size=(K, N)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_rows,rows,K,N", [(24, 48, 64, 128),
                                                (48, 96, 40, 72)])
def test_plain_matches_pallas_mm_kernel(dtype, tile_rows, rows, K, N):
    x, w = _inputs(rows, K, N, tile_rows + K)
    jdt = jnp.dtype(dtype)
    want = np.asarray(_pallas_tiled_mm(jnp.asarray(x, jdt),
                                       jnp.asarray(w, jdt), tile_rows),
                      np.float32)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    got = tmm.tiled_mm(tx, tw, tile_rows=tile_rows)
    assert got.dtype == tdt and got.shape == (rows, N)
    assert torch.equal(got, tmm.tiled_mm_plain(tx, tw))
    if dtype == "float32":
        np.testing.assert_allclose(n(got), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        assert_within_bf16_ulp(got, want)


@pytest.mark.parametrize("tile_rows", [36, 0, 7])
def test_ragged_tiles_raise(tile_rows):
    x = torch.zeros(48, 16)
    w = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="tile_rows"):
        tmm.tiled_mm(x, w, tile_rows=tile_rows)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tmm.tiled_mm(torch.zeros(48, 16), torch.zeros(15, 8), tile_rows=24)


def test_bf16_ulp_error_counts_ulps():
    """The card checks' measure: one bf16 rounding is within one ulp, two
    ulps off reads as two, and the floor keeps near-zero values from
    setting the scale."""
    g = np.random.default_rng(7)
    want = torch.from_numpy(g.normal(size=(64, 32)).astype(np.float32))
    rounded = want.bfloat16()
    err, ulps = bf16_ulp_error(rounded, want)
    assert 0 < ulps <= 0.5 and err == float((rounded.float() - want).abs()
                                            .max())
    w = torch.tensor([1.0, 2.0, 0.0])
    assert bf16_ulp_error(w + torch.tensor([2 ** -6, 0.0, 0.0]), w)[1] == 2.0
    # at 0.0 the ulp is taken at 1e-3 of max|want| = 2e-3: 2^-9 - 7
    assert bf16_ulp_error(w + torch.tensor([0.0, 0.0, 2 ** -16]), w)[1] == 1.0

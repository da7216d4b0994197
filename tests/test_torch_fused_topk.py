"""The port's fused classifier top-k (its plain version, which the CPU
runs) against the JAX package's Pallas kernel in interpret mode: indices
identical, values within 1e-5 (the JAX test's own tolerance,
tests/test_fused_topk.py). The JAX kernel takes W as [H, V] with V padded
to its tile; the port takes the Linear layout [V, H] and any V."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from insenticap_model_tpu.ops.fused_topk import classifier_topk as jax_topk

from insenticap_model_tpu_torch.ops import fused_topk as ft

BANNED = (0, 1, 2)


def _inputs(seed, rows, H, V):
    g = np.random.default_rng(seed)
    h = g.normal(size=(rows, H)).astype(np.float32)
    w = (g.normal(size=(H, V)) * 0.05).astype(np.float32)
    b = (g.normal(size=(V,)) * 0.1).astype(np.float32)
    last = g.integers(4, V, size=(rows,)).astype(np.int32)
    return h, w, b, last


def _port(h, w, b, last, k, banned, dtype=torch.float32):
    return ft.classifier_topk_plain(
        torch.from_numpy(h).to(dtype), torch.from_numpy(w.T.copy()).to(dtype),
        torch.from_numpy(b).to(dtype),
        None if last is None else torch.from_numpy(last), k=k,
        banned=banned)


def _check(port, jax_out):
    pv, pi = port
    jv, ji = (np.asarray(x) for x in jax_out)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows,V,k", [(16, 1024, 3), (8, 512, 5)])
def test_plain_matches_jax_kernel(rows, V, k):
    h, w, b, last = _inputs(0, rows, 64, V)
    jout = jax_topk(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                    jnp.asarray(last), k=k, banned=BANNED, tile_r=rows,
                    tile_v=256, interpret=True)
    port = _port(h, w, b, last, k, BANNED)
    _check(port, jout)
    assert not np.isin(port[1].numpy(), BANNED).any()
    assert not (port[1].numpy() == last[:, None]).any()


def test_plain_matches_jax_kernel_bf16():
    """bf16 operands: both take exact bf16 products and sum them in f32."""
    h, w, b, last = _inputs(1, 16, 64, 512)
    cast = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jout = jax_topk(cast(h), cast(w), cast(b), jnp.asarray(last), k=3,
                    banned=BANNED, tile_r=16, tile_v=256, interpret=True)
    _check(_port(h, w, b, last, 3, BANNED, torch.bfloat16), jout)


def test_exact_ties_go_to_the_lower_index():
    """Words 256..511 repeat words 0..255 (another vocab tile of the JAX
    kernel): every twin ranks after its original, in both."""
    h, w, b, _ = _inputs(2, 8, 32, 256)
    w2, b2 = np.concatenate([w, w], 1), np.concatenate([b, b])
    last = np.full((8,), -1, np.int32)
    jout = jax_topk(jnp.asarray(h), jnp.asarray(w2), jnp.asarray(b2),
                    jnp.asarray(last), k=6, banned=(), tile_r=8, tile_v=256,
                    interpret=True)
    port = _port(h, w2, b2, last, 6, ())
    _check(port, jout)
    for row in port[1].tolist():
        assert row[0::2] == [x - 256 for x in row[1::2]], row


def test_no_last_word_ban():
    """last = -1 bans nothing (decoding_constraint off); None likewise."""
    h, w, b, _ = _inputs(3, 8, 32, 512)
    last = np.full((8,), -1, np.int32)
    jout = jax_topk(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                    jnp.asarray(last), k=4, banned=BANNED, tile_r=8,
                    tile_v=256, interpret=True)
    _check(_port(h, w, b, last, 4, BANNED), jout)
    _check(_port(h, w, b, None, 4, BANNED), jout)


def test_unpadded_vocab_against_padded_jax():
    """V = 300 in the port, the JAX kernel on W padded to 512 with a -1e30
    bias on the pad (its own padding rule, ops/beam.py:180-184)."""
    h, w, b, last = _inputs(4, 8, 32, 300)
    wp = np.pad(w, ((0, 0), (0, 212)))
    bp = np.pad(b, (0, 212), constant_values=-1e30)
    jout = jax_topk(jnp.asarray(h), jnp.asarray(wp), jnp.asarray(bp),
                    jnp.asarray(last), k=3, banned=BANNED, tile_r=8,
                    tile_v=256, interpret=True)
    port = _port(h, w, b, last, 3, BANNED)
    _check(port, jout)
    assert int(port[1].max()) < 300


def test_wrapper_takes_the_plain_version_on_the_cpu():
    h, w, b, last = _inputs(5, 7, 16, 40)
    args = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
            torch.from_numpy(b), torch.from_numpy(last).long())
    before = ft.classifier_topk.launches
    got = ft.classifier_topk(*args, k=3, banned=BANNED)
    want = ft.classifier_topk_plain(*args, k=3, banned=BANNED)
    assert ft.classifier_topk.launches == before      # no kernel here
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_rows_with_fewer_candidates_than_k():
    """The documented rule: slots no candidate fills hold (-1e30, 0), as k
    argmax passes over the masked row give."""
    h = torch.ones(2, 4)
    w = torch.arange(20, dtype=torch.float32).reshape(5, 4) / 10
    b = torch.zeros(5)
    v, i = ft.classifier_topk_plain(h, w, b, torch.tensor([4, -1]), k=4,
                                    banned=(0, 1, 2))
    assert i.tolist() == [[3, 0, 0, 0], [4, 3, 0, 0]]
    assert (v[0, 1:] == ft.NEG_INF).all() and (v[1, 2:] == ft.NEG_INF).all()
    assert (v[:, 0] > ft.NEG_INF).all()

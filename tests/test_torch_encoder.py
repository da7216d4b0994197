"""The port's patched ResNet-101 (``models/encoder.py``) against the JAX
package's on the CPU, at full depth on small images, with the same weights
(a torchvision-style state dict through the JAX package's converter, then
``convert.from_jax_numpy``); plus the adaptive pool, the s2d stem, the host
image helpers, the bucket ladder and the weight conversions.

Tolerances: the encoders agree within 1e-5 of the output's largest
magnitude (f32, sums in another order through 104 convolutions; measured
about 1e-6). The adaptive pool within 1e-5 of scale in f32 (the JAX
package sums through an integral image, the port sums the window), and in
bf16 within one bf16 rounding (2^-8 relative) of the port's own f32 mean.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import preprocessing as jpp
from insenticap_model_tpu.models import encoder as jenc
from insenticap_model_tpu.ops.adaptive_pool import (
    adaptive_avg_pool2d as jadaptive)

from insenticap_model_tpu_torch import convert
from insenticap_model_tpu_torch import preprocessing as tpp
from insenticap_model_tpu_torch.models import encoder as tenc
from insenticap_model_tpu_torch.ops import pool
from insenticap_model_tpu_torch.ops.adaptive_pool import (
    adaptive_avg_pool2d as tadaptive)

from torch_parity import encoder_params, resnet_state_dict, t

SCALE_TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return encoder_params(0)


def _close_to_scale(got, want, frac=SCALE_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, (err, scale)


@pytest.mark.parametrize("hw", [(64, 64), (65, 49)])
@pytest.mark.parametrize("path", ["forward_batch", "forward_raw_batch"])
def test_encoder_matches_jax(params, hw, path):
    jp, tp = params
    g = np.random.default_rng(hw[0] * 7 + hw[1])
    raw = g.integers(0, 256, size=(2, *hw, 3)).astype(np.uint8)
    if path == "forward_batch":
        x = np.stack([jenc.preprocess(r) for r in raw])
        want = jenc.forward_batch(jp, jnp.asarray(x))
        got = tenc.forward_batch(tp, t(x))
    else:
        want = jenc.forward_raw_batch(jp, jnp.asarray(raw), s2d_stem=False)
        got = tenc.forward_raw_batch(tp, t(raw), s2d_stem=False)
    assert got[0].shape == (2, 2048) and got[1].shape == (2, 14, 14, 2048)
    assert got[0].dtype == torch.float32
    _close_to_scale(got[0].numpy(), want[0])
    _close_to_scale(got[1].numpy(), want[1])


def test_forward_single_image_and_plain_pool(params):
    """``forward`` is forward_batch of one image; ``use_kernels=False``
    (the plain pool, the card's reference run) is the same function."""
    _, tp = params
    g = np.random.default_rng(5)
    x = jenc.preprocess(g.integers(0, 256, size=(40, 36, 3)).astype(
        np.uint8))
    fc, att = tenc.forward(tp, t(x))
    fcb, attb = tenc.forward_batch(tp, t(x)[None], use_kernels=False)
    assert torch.equal(fc, fcb[0]) and torch.equal(att, attb[0])


def test_s2d_stem_matches_direct_stem_and_jax(params, monkeypatch):
    jp, tp = params
    g = np.random.default_rng(11)
    raw = t(g.integers(0, 256, size=(2, 64, 58, 3)).astype(np.uint8))
    fc_d, att_d = tenc.forward_raw_batch(tp, raw, s2d_stem=False)
    fc_s, att_s = tenc.forward_raw_batch(tp, raw, s2d_stem=True)
    _close_to_scale(fc_s.numpy(), fc_d.numpy())
    _close_to_scale(att_s.numpy(), att_d.numpy())
    jfc, jatt = jenc.forward_raw_batch(jp, jnp.asarray(raw.numpy()),
                                       s2d_stem=True)
    _close_to_scale(fc_s.numpy(), jfc)
    _close_to_scale(att_s.numpy(), jatt)
    # the switch is read at each call
    monkeypatch.setenv("ISC_S2D_STEM", "1")
    assert torch.equal(tenc.forward_raw_batch(tp, raw)[0], fc_s)
    monkeypatch.setenv("ISC_S2D_STEM", "0")
    assert torch.equal(tenc.forward_raw_batch(tp, raw)[0], fc_d)
    # odd extents keep the direct conv
    odd = t(g.integers(0, 256, size=(1, 65, 58, 3)).astype(np.uint8))
    assert torch.equal(tenc.forward_raw_batch(tp, odd, s2d_stem=True)[0],
                       tenc.forward_raw_batch(tp, odd, s2d_stem=False)[0])


def test_s2d_stem_conv_at_the_bucket_shapes():
    """conv1 alone, f32, at every resize bucket: the rewrite against the
    direct 7x7/s2 conv and the JAX package's rewrite (1e-5: another
    summation order of the same products)."""
    g = np.random.default_rng(6)
    w = (g.standard_normal((7, 7, 3, 8)) * 0.1).astype(np.float32)
    for h, wd in tpp.DEFAULT_BUCKET_SHAPES:
        x = g.standard_normal((1, h, wd, 3)).astype(np.float32)
        s2d = tenc._stem_conv_s2d(t(w), t(x))
        direct = tenc._conv({"weight": t(w)}, t(x), 2, 3)
        assert s2d.shape == direct.shape == (1, h // 2, wd // 2, 8)
        np.testing.assert_allclose(s2d.numpy(), direct.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(
            s2d.numpy(), np.asarray(jenc._stem_conv_s2d(jnp.asarray(w),
                                                        jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw,out", [((12, 16), (14, 14)), ((14, 14),
                                                           (14, 14)),
                                    ((7, 9), (3, 4))])
def test_adaptive_pool_matches_jax_in_f32(hw, out):
    g = np.random.default_rng(hw[0])
    x = (np.abs(g.standard_normal((2, *hw, 64))) * 2).astype(np.float32)
    want = np.asarray(jadaptive(jnp.asarray(x), out))
    got = tadaptive(t(x), out)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close_to_scale(got.numpy(), want)
    ref = torch.nn.functional.adaptive_avg_pool2d(
        t(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(12, 16), (14, 14)])
def test_adaptive_pool_bf16_is_one_rounding_of_f32(hw):
    """bf16 in: the f32 window mean rounded once (the JAX package's bf16
    integral image loses whole units here; ROADMAP queue 3)."""
    g = np.random.default_rng(1)
    x = t((np.abs(g.standard_normal((2, *hw, 64))) * 2).astype(
        np.float32)).bfloat16()
    got = tadaptive(x, (14, 14))
    assert got.dtype == torch.bfloat16
    want = tadaptive(x.float(), (14, 14))
    assert torch.equal(got, want.bfloat16())
    err = (got.float() - want).abs()
    assert (err <= 2.0 ** -8 * want.abs()).all()
    if hw == (14, 14):                       # the identity, exactly
        assert torch.equal(got, x)


def test_image_helpers_match_jax():
    g = np.random.default_rng(2)
    rgb = g.integers(0, 256, size=(10, 12, 3)).astype(np.uint8)
    for img in (rgb, rgb[..., 0], rgb[..., :1],
                np.concatenate([rgb, rgb[..., :1]], -1)):
        np.testing.assert_array_equal(tpp.to_rgb_uint8(img),
                                      jpp.to_rgb_uint8(img))
        np.testing.assert_array_equal(tenc.preprocess(img),
                                      jenc.preprocess(img))
    with pytest.raises(ValueError):
        tpp.to_rgb_uint8(np.zeros((4, 4, 2), np.uint8))
    shapes = tpp.DEFAULT_BUCKET_SHAPES
    assert shapes == jpp.DEFAULT_BUCKET_SHAPES
    for h, w in [(448, 448), (480, 640), (640, 480), (500, 510), (1, 1000),
                 (1000, 1), (300, 400), (400, 300), (413, 500)]:
        assert tpp.bucket_for_shape(h, w, shapes) == \
            jpp.bucket_for_shape(h, w, shapes)


def test_convert_torch_state_dict_matches_jax():
    """numpy state dict -> the port's params, bit for bit the JAX
    package's conversion carried over; torch tensors in give the same."""
    sd = resnet_state_dict(3)
    got = tenc.convert_torch_state_dict(sd, device="cpu")
    want = convert.from_jax_numpy(jax.tree_util.tree_map(
        np.asarray, jenc.convert_torch_state_dict(sd)), device="cpu")
    flat_a, tree_a = jax.tree_util.tree_flatten(got)
    flat_b, tree_b = jax.tree_util.tree_flatten(want)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and torch.equal(a, b)
    again = tenc.convert_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu")
    assert torch.equal(again["layers"][2][22]["conv2"]["weight"],
                       got["layers"][2][22]["conv2"]["weight"])


def test_init_params_tree_and_bridge(params):
    """init_params has the JAX package's tree and shapes (its BatchNorm
    nodes kept under their names by the bridge, both ways), kaiming-normal
    fan-out convs and BatchNorm at identity."""
    jp, tp = params
    gen = torch.Generator().manual_seed(0)
    mine = tenc.init_params(gen, device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jp)
    back = convert.to_jax_numpy(mine)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
    w = mine["layers"][3][0]["conv2"]["weight"]
    assert abs(float(w.std()) - (2.0 / (9 * 512)) ** 0.5) < 1e-3
    bn = mine["layers"][0][0]["bn3"]
    assert bn["scale"].eq(1).all() and bn["var"].eq(1).all()
    assert not bn["bias"].any() and not bn["mean"].any()
    # the JAX tree -> port -> JAX tree is the identity
    flat_a = jax.tree_util.tree_leaves(convert.to_jax_numpy(tp))
    for a, b in zip(flat_a, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_stem_pool_is_the_pool_module(params):
    """The trunk's pool is ops/pool.py: the plain version on the CPU,
    equal to the JAX package's reduce_window pool."""
    g = np.random.default_rng(9)
    x = g.standard_normal((2, 33, 32, 64)).astype(np.float32)
    want = np.asarray(jenc._ceil_maxpool_3x3s2(jnp.asarray(x)))
    np.testing.assert_array_equal(tenc._ceil_maxpool_3x3s2(t(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        pool.ceil_maxpool_3x3s2_plain(t(x)).numpy(), want)

"""The port's Winograd F(5x5,3x3) matrices, the plain twins of its three
transform kernels, and the image-sentiment detector, against the JAX
package on the CPU.

Tolerances: the matrices are exactly equal (both round the same exact
rationals once to f32); the plain stack 2e-5 of the output scale against
the direct f32 conv chain (the transforms' constants reach 5, so their
f32 rounding grows a little beyond a direct conv's); the detector's logits
1e-5 and its labels exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.ops import winograd as jwino

from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.ops import winograd as twino
from insenticap_model_tpu_torch.ops import winograd_kernels as wk

from torch_parity import detector_params, features, n, t

STACK_TOL = 2e-5


def _direct_chain(x, layers):
    """JAX direct SAME convs, NHWC."""
    y = jnp.asarray(x)
    for w, b in layers:
        y = lax.conv_general_dilated(
            y, jnp.asarray(w), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(b)
    return np.asarray(y)


def _layers(g, chans, scale=0.1):
    return [(g.normal(size=(3, 3, ci, co)).astype(np.float32) * scale,
             g.normal(size=(co,)).astype(np.float32))
            for ci, co in zip(chans[:-1], chans[1:])]


def test_cook_toom_matrices_equal_jax_package():
    for mine, theirs in ((twino._AT5, jwino._AT5), (twino._G5, jwino._G5),
                         (twino._BT5, jwino._BT5)):
        assert mine.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)
    with pytest.raises(ValueError):
        twino.cook_toom(5, 3, [0, 1, -1])


def test_transform_filter_matches_jax():
    g = np.random.default_rng(0)
    w = g.normal(size=(3, 3, 5, 4)).astype(np.float32)
    want = jwino.transform_filter(jnp.asarray(w), g_mat=jwino._G5)
    got = twino.transform_filter(t(w))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw,chans", [((14, 14), (16, 8, 4)),
                                      ((14, 14), (12, 6)),
                                      ((11, 13), (8, 6, 4, 2)),
                                      ((5, 3), (4, 4)),
                                      ((1, 1), (3, 2))])
def test_plain_stack_matches_jax_direct_chain(hw, chans):
    """The stack on the detector's permuted NHWC view, as the detector
    calls it; the view and its contiguous copy give the same numbers."""
    g = np.random.default_rng(sum(hw) + len(chans))
    bs = 3
    x = g.normal(size=(bs, *hw, chans[0])).astype(np.float32)
    layers = _layers(g, chans)
    ref = _direct_chain(x, layers)
    view = t(x).permute(1, 2, 0, 3)
    tl = [(t(w), t(b)) for w, b in layers]
    got = wk.conv3x3_stack_sm(view, tl)
    assert torch.equal(got, wk.conv3x3_stack_sm(view.contiguous(), tl))
    assert torch.equal(wk.wino_input_plain(view),
                       wk.wino_input_plain(view.contiguous()))
    got = n(got.permute(2, 0, 1, 3))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                               atol=STACK_TOL)


def test_plain_kernel_twins_compose():
    """input -> product -> output equals one direct conv, and the middle
    twin equals output-then-input of the trimmed activation."""
    g = np.random.default_rng(1)
    x = t(g.normal(size=(14, 14, 2, 6)).astype(np.float32))
    (w, b), = _layers(g, (6, 5))
    v = wk.wino_input(x)
    assert v.shape == (49, 9, 2, 6)
    u = twino.transform_filter(t(w)).reshape(49, 6, 5)
    m = torch.bmm(v.reshape(49, -1, 6), u).reshape(49, 9, 2, 5)
    y = wk.wino_output(m, t(b), 14, 14)
    ref = _direct_chain(n(x.permute(2, 0, 1, 3)), [(w, b)])
    np.testing.assert_allclose(n(y.permute(2, 0, 1, 3)), ref, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(n(wk.wino_middle(m, t(b), 14, 14)),
                               n(wk.wino_input(y)), rtol=1e-5, atol=1e-4)


def test_bf16_stack_error_is_the_f5_algorithms():
    """bf16 against the f32 direct chain. The transform itself is sound:
    on bf16-rounded operands in f32 it meets the JAX package's bf16 rule,
    max(4 x the bf16 direct conv's error, 0.05) of the output scale
    (tests/test_winograd.py). With the serving cast points (V, U and M in
    bf16) F(5x5,3x3) loses more: its transform constants reach 5 and 1/2,
    and the inverse transform cancels large terms. The JAX package's own
    bf16 stack shows the same loss (0.10 of scale, pinned against this
    port in test_torch_winograd_interpret.py), so here it is held below
    0.15 of scale."""
    g = np.random.default_rng(2)
    x = g.normal(size=(4, 14, 14, 32)).astype(np.float32)
    layers = _layers(g, (32, 16, 8))
    ref = _direct_chain(x, layers)
    scale = np.abs(ref).max()
    bf = lambda a: t(a).bfloat16()  # noqa: E731
    y = bf(x)
    for w, b in layers:
        y = tnn.conv2d({"weight": bf(w), "bias": bf(b)}, y)
    err_direct = np.abs(n(y) - ref).max() / scale
    rounded = wk.conv3x3_stack_sm(
        bf(x).float().permute(1, 2, 0, 3),
        [(bf(w).float(), bf(b).float()) for w, b in layers])
    err_rounded = np.abs(n(rounded.permute(2, 0, 1, 3)) - ref).max() / scale
    assert err_rounded < max(4 * err_direct, 0.05), (err_rounded,
                                                     err_direct)
    view = bf(x).permute(1, 2, 0, 3)
    bl = [(bf(w), bf(b)) for w, b in layers]
    got = wk.conv3x3_stack_sm(view, bl)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, wk.conv3x3_stack_sm(view.contiguous(), bl))
    assert torch.equal(wk.wino_input_plain(view),
                       wk.wino_input_plain(view.contiguous()))
    err = np.abs(n(got.permute(2, 0, 1, 3)) - ref).max() / scale
    assert err < 0.15, err


def test_kernel_gate():
    ok = dict(x_shape=(384, 14, 14, 2048), w_shape=(3, 3, 2048, 1024),
              dtype=torch.bfloat16, device="cuda")
    assert twino.kernel_eligible(**ok)
    assert twino.kernel_eligible(**dict(ok, x_shape=(5, 14, 14, 12)))
    assert not twino.kernel_eligible(**dict(ok, dtype=torch.float32))
    assert not twino.kernel_eligible(**dict(ok, device="cpu"))
    assert not twino.kernel_eligible(**dict(ok, w_shape=(1, 1, 2048, 3)))
    assert not twino.kernel_eligible(**dict(ok, x_shape=(8, 16, 14, 64)))
    with pytest.raises(ValueError):
        wk.conv3x3_stack_sm(torch.zeros(14, 14, 1, 2), [], variant="f5")
    with pytest.raises(ValueError):
        wk.conv3x3_stack_sm(torch.zeros(14, 14, 1, 2),
                            [(torch.zeros(3, 3, 2, 2), None)], variant="f4")


@pytest.mark.parametrize("threshold", [0.7, 0.45, 0.0])
def test_detector_sample_matches_jax(settings, threshold):
    jp, tp = detector_params(settings, scale=10.0)
    _, att, _ = features(settings, 8, 3)
    att = att - 0.5
    jl, jspatial, jscores = jsd.sample(jp, jnp.asarray(att), threshold, 2)
    tl, tspatial, tscores = tsd.sample(tp, t(att), threshold, 2)
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(n(tl), n(jl))
    np.testing.assert_allclose(n(tscores), n(jscores), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tspatial), n(jspatial), rtol=1e-5,
                               atol=1e-5)
    jlog, _ = jsd.forward(jp, jnp.asarray(att), dropout_p=0.0)
    tlog, _ = tsd.forward(tp, t(att))
    np.testing.assert_allclose(n(tlog), n(jlog), rtol=1e-5, atol=1e-5)


def test_detector_labels_mix(settings):
    """The scaled detector gives both confident and neutral-fallback rows
    at 0.7, so the label test above sees both branches."""
    _, tp = detector_params(settings, scale=10.0)
    _, att, _ = features(settings, 8, 3)
    labels, _, scores = tsd.sample(tp, t(att - 0.5), 0.7, 2)
    assert (scores >= 0.7).any() and (scores < 0.7).any()

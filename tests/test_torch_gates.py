"""Where the port's kernels are taken, on the CPU: the beam's gates
(``fused_attention.kernel_takes``, ``fused_topk.kernel_takes`` and the
bf16 top-k's grid, ``fused_topk.vocab_groups``), the
wrappers' refusal to launch a kernel inside a recorded autograd graph
(``_build.no_grad_guard``), and the detector heads' ``deterministic`` flag,
whose training form keeps the differentiable direct conv and gives the
JAX package's gradients (f32, within 1e-5 of scale: the same sums in
another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu_torch.config import Settings
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.models import sentiment_detector_full as tsdf
from insenticap_model_tpu_torch.ops import _build
from insenticap_model_tpu_torch.ops import beam as tbeam
from insenticap_model_tpu_torch.ops import fused_attention as fa
from insenticap_model_tpu_torch.ops import fused_topk as ft

from torch_parity import (TIDS, captioner_params, detector_params,
                          features, n, port_settings, t, to_port)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,H,Ah,Fe,dtype,variant,takes", [
    (3, 512, 512, 512, BF, "v1", True),      # serving width
    (3, 512, 512, 512, F32, "v1", True),
    (1, 48, 40, 72, BF, "v1", True),
    (8, 48, 40, 72, F32, "v1", True),
    (9, 512, 512, 512, BF, "v1", False),     # wider than the kernel's beam
    (9, 512, 512, 512, F32, "v1", False),
    (0, 512, 512, 512, BF, "v1", False),
    (3, 24, 40, 72, BF, "v1", False),        # H % 16: the mma's K
    (3, 24, 40, 72, F32, "v1", True),
    (3, 48, 36, 72, BF, "v1", False),        # Ah % 8 in bf16
    (3, 48, 36, 68, F32, "v1", True),        # % 4 in f32
    (3, 48, 40, 70, F32, "v1", False),       # Fe % 4
    (3, 48, 2048, 2048, BF, "v1", True),     # 256 lanes x 8 channels
    (3, 48, 2056, 512, BF, "v1", False),
    (3, 48, 512, 2056, F32, "v1", False),
    (3, 48, 40, 72, torch.float16, "v1", False),
    (3, 48, 40, 72, F32, "v2", True),
    (3, 24, 40, 72, F32, "v2", True),        # v2 runs v1's kernel
    (9, 48, 40, 72, BF, "v2", False),
])
def test_attention_kernel_takes(B, H, Ah, Fe, dtype, variant, takes):
    assert fa.kernel_takes(B, H, Ah, Fe, dtype, variant) is takes


def test_attention_kernel_takes_reads_the_switch(monkeypatch):
    """variant=None reads ISC_ATT_KERNEL at each call: an unknown name
    raises through kernel_takes, and resolve_variant follows the
    variable (v1 and v2 take the same shapes: one kernel)."""
    monkeypatch.setenv("ISC_ATT_KERNEL", "v3")
    with pytest.raises(ValueError, match="v3"):
        fa.kernel_takes(3, 24, 40, 72, F32)
    monkeypatch.setenv("ISC_ATT_KERNEL", "v2")
    assert fa.resolve_variant() == "v2"
    assert fa.kernel_takes(3, 24, 40, 72, F32)
    monkeypatch.delenv("ISC_ATT_KERNEL")
    assert fa.resolve_variant() == "v1"
    assert fa.kernel_takes(3, 24, 40, 72, F32)


@pytest.mark.parametrize("k,takes", [(0, False), (1, True), (3, True),
                                     (8, True), (9, False)])
def test_topk_kernel_takes(k, takes):
    assert ft.kernel_takes(k, 512, BF) is takes


@pytest.mark.parametrize("k,H,dtype,takes", [
    (3, 512, BF, True),                      # serving width
    (3, 512, F32, True),
    (3, 8, BF, True),
    (3, 36, BF, False),                      # bf16 rows of 16-byte pieces
    (3, 36, F32, True),                      # f32: FFMA, any width
    (3, 33, F32, True),
    (3, ft.MAX_H_BF16, BF, True),            # h resident: ten panels
    (3, ft.MAX_H_BF16 + 8, BF, False),
    (3, 4096, F32, True),
    (3, 0, BF, False),
    (9, 64, F32, False),
    (3, 512, torch.float16, False),
])
def test_topk_kernel_takes_widths(k, H, dtype, takes):
    assert ft.kernel_takes(k, H, dtype) is takes


@pytest.mark.parametrize("rows,V,sms,groups", [
    (1152, 10_000, 132, 14),                 # serving: 9 x 14 = 126 CTAs
    (1153, 10_000, 132, 13),                 # 10 row blocks
    (1, 10_000, 132, 79),                    # one CTA a tile
    (1, 1, 132, 1),
    (128 * 200, 10_000, 132, 1),             # more row blocks than SMs
    (300, 129, 132, 2),
])
def test_topk_vocab_groups(rows, V, sms, groups):
    """The bf16 grid's vocab split: about one CTA an SM, every group at
    least one 128-word tile."""
    assert ft.vocab_groups(rows, V, sms) == groups


@pytest.mark.parametrize("takes", [False, True])
def test_beam_gates_the_fused_tail_on_kernel_takes(settings, monkeypatch,
                                                   takes):
    """Under ISC_FUSED_TOPK=1 the beam asks ``fused_topk.kernel_takes``
    with (beam, h's width, the classifier's dtype) and sends a refused
    width to ``classifier_topk_plain``; the decode is the plain path's
    either way (on the CPU the wrapper runs the plain version too)."""
    monkeypatch.setenv("ISC_FUSED_TOPK", "1")
    asked, called = [], []
    monkeypatch.setattr(ft, "kernel_takes",
                        lambda *a: asked.append(a) or takes)
    wrapper = ft.classifier_topk

    def fused(*a, **kw):
        called.append(1)
        return wrapper(*a, **kw)
    monkeypatch.setattr(ft, "classifier_topk", fused)
    ps = port_settings(settings)
    _, tp = captioner_params(settings)
    fc, att, sentis = features(settings, 4, 0)
    ctx = tcap.build_visual_context(
        tp, t(fc), t(att), senti_words=t(sentis),
        senti_labels=torch.tensor([0, 1, 2, 0], dtype=torch.int32),
        pad_id=TIDS.pad)
    kw = dict(settings=ps, ids=TIDS, beam_size=3, max_seq_len=6, mode="rl")
    got = tbeam.beam_search_batched(tp, ctx, **kw)
    want = tbeam.beam_search_batched(tp, ctx, use_kernels=False, **kw)
    assert asked == [(3, ps.rnn_hid_dim, F32)]
    assert bool(called) is takes
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_no_grad_guard():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    _build.no_grad_guard("k", y, None)
    _build.no_grad_guard("k", x.detach())
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.no_grad_guard("k", y, x)
    with torch.no_grad():
        _build.no_grad_guard("k", x)
    with torch.inference_mode():
        _build.no_grad_guard("k", x)


class _StackTaken(Exception):
    pass


def _kernels_eligible(monkeypatch):
    """Make every conv look kernel-eligible, with a stand-in stack that
    raises when taken, so the CPU shows which path conv_stack takes."""
    def stack(*args, **kwargs):
        raise _StackTaken
    monkeypatch.setattr(tsd, "kernel_eligible", lambda *a: True)
    monkeypatch.setattr(tsd, "conv3x3_stack_sm", stack)


@pytest.mark.parametrize("head", ["standard", "full"])
def test_training_forward_keeps_the_direct_conv(monkeypatch, head):
    s = Settings(fc_feat_dim=16, sentiment_convs_num=2,
                 num_kernels_per_sentiment=2 if head == "full" else 0)
    mod = tsd.module_for(s)
    assert mod is (tsdf if head == "full" else tsd)
    params = mod.init_params(torch.Generator().manual_seed(0), 3, s,
                             device="cpu")
    x = torch.rand(2, 14, 14, 16, generator=torch.Generator().manual_seed(1))
    _kernels_eligible(monkeypatch)
    with pytest.raises(_StackTaken):
        mod.forward(params, x)
    for cp in params["convs"]:
        cp["weight"].requires_grad_(True)
    y, spatial_major = tsd.conv_stack(params, x, deterministic=False)
    assert not spatial_major and y.shape[:3] == x.shape[:3]
    assert y.grad_fn is not None
    logits, _ = mod.forward(params, x, deterministic=False)
    logits.sum().backward()
    for cp in params["convs"]:
        assert cp["weight"].grad is not None
        assert cp["weight"].grad.abs().sum() > 0


def test_training_gradients_match_jax(settings):
    """The detector's training forward (deterministic=False, no dropout)
    differentiated by autograd against ``jax.grad`` of the JAX forward."""
    jp, tp = detector_params(settings, scale=3.0)
    _, att, _ = features(settings, 4, 7)
    c = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)

    def jloss(p):
        logits, spatial = jsd.forward(p, jnp.asarray(att), dropout_p=0.0,
                                      deterministic=False)
        return (logits * c).sum() + spatial.sum()
    jgrad = to_port(jax.grad(jloss)(jp))

    leaves = [cp[k] for cp in tp["convs"] for k in ("weight", "bias")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    logits, spatial = tsd.forward(tp, t(att), deterministic=False)
    ((logits * t(c)).sum() + spatial.sum()).backward()
    for got, want in zip(tp["convs"], jgrad["convs"]):
        for k in ("weight", "bias"):
            g, w = n(got[k].grad), n(want[k])
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())

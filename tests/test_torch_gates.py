"""Where the port's kernels are taken, on the CPU: the beam's gates
(``fused_attention.kernel_takes``, ``fused_topk.kernel_takes``), the
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
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.models import sentiment_detector_full as tsdf
from insenticap_model_tpu_torch.ops import _build
from insenticap_model_tpu_torch.ops import fused_attention as fa
from insenticap_model_tpu_torch.ops import fused_topk as ft

from torch_parity import detector_params, features, n, t, to_port

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
    (3, 24, 40, 72, F32, "v2", False),       # v2: H % 16 in f32 too
    (9, 48, 40, 72, BF, "v2", False),
])
def test_attention_kernel_takes(B, H, Ah, Fe, dtype, variant, takes):
    assert fa.kernel_takes(B, H, Ah, Fe, dtype, variant) is takes


def test_attention_kernel_takes_reads_the_switch(monkeypatch):
    monkeypatch.setenv("ISC_ATT_KERNEL", "v2")
    assert not fa.kernel_takes(3, 24, 40, 72, F32)
    monkeypatch.delenv("ISC_ATT_KERNEL")
    assert fa.kernel_takes(3, 24, 40, 72, F32)


@pytest.mark.parametrize("k,takes", [(0, False), (1, True), (3, True),
                                     (8, True), (9, False)])
def test_topk_kernel_takes(k, takes):
    assert ft.kernel_takes(k) is takes


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

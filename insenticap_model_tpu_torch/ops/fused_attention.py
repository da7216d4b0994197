"""Beam-shared additive content attention (CUDA kernels + plain twin).

Replaces the Pallas kernels ``insenticap_model_tpu/ops/fused_attention.py``
``_kernel`` (v1) and ``_kernel_v2`` (v2, :51; both through the pallas_call
at :123). In beam decode the visual context is the same for all B beams
of an image, but the tiled-rows formulation reads att and p_att
([bs, N, 512] each) B times per step. The kernel
(``csrc/fused_attention.cu``) reads each image's att/p_att once for all its
beams:

    q[b,k]   = h @ W_h2att^T + b_h2att                  (rows = bs*B)
    e[b,k,n] = alpha . tanh(p_att[b,n] + q[b,k])        (alpha's bias
               dropped: it cancels in the softmax; dropped in the twin too)
    out[b,k] = softmax_n(e[b,k]) @ att[b]

What bounds it on the H100: the att/p_att bytes (154 MB a step at bs=384,
bf16, N=196, 512 wide: about 46 us at 3.35 TB/s), with 115.6 M tanh beside
them. The design streams each image's p_att rows once to form all B logits
and att once for all B weighted sums, with the queries and softmax weights
in f32 shared memory (see the source's header). Serving only: no backward.

v2 (``csrc/fused_attention_v2.cu``) computes v1's function with one
difference, as ``_kernel_v2`` does: the softmax weights are rounded to
att's dtype before the weighted sum, which accumulates in f32 (in f32 the
two are the same function). Its design puts the q product and, for bf16,
the weighted sum on the tensor cores (``mma.sync`` m16n8k16), and reads
p_att and att with 16-byte loads; the bound is v1's.

``beam_content_attention`` takes the plain version for CPU tensors and
launches a kernel for CUDA tensors. ``variant=None`` reads
``ISC_ATT_KERNEL`` ("v1" when unset) at each call, here in the wrapper;
``beam_content_attention.launches`` and ``.launches_v2`` count the v1 and
v2 kernel launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import nn
from . import _build

MAX_BEAM = 8   # the kernels' softmax runs one warp per beam
VARIANTS = ("v1", "v2")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P] * 7 + [_I] * 6 + [_P]
_LIBS = {"v1": "fused_attention", "v2": "fused_attention_v2"}
_FNS = {"v1": {torch.float32: "isc_beam_att_f32",
               torch.bfloat16: "isc_beam_att_bf16"},
        "v2": {torch.float32: "isc_beam_att_v2_f32",
               torch.bfloat16: "isc_beam_att_v2_bf16"}}


def _lib(variant: str):
    return _build.load(_LIBS[variant],
                       {fn: _SIG for fn in _FNS[variant].values()})


def resolve_variant(variant=None) -> str:
    """``variant``, or ``ISC_ATT_KERNEL`` ("v1" when unset) for None."""
    if variant is None:
        variant = os.environ.get("ISC_ATT_KERNEL", "v1")
    if variant not in VARIANTS:
        raise ValueError(f"attention kernel variant {variant!r}: one of "
                         f"{VARIANTS}")
    return variant


def beam_content_attention_plain(h, p_cont, att, p_att, *, B: int,
                                 variant: str = "v1"):
    """The kernels' function in PyTorch: f32 arithmetic throughout, output
    in att's dtype; under "v2" the softmax weights are rounded to att's
    dtype before the weighted sum. h [bs*B, H] image-major (row =
    image*B + beam), att/p_att [bs, N, ·] untiled -> [bs*B, Fe]."""
    variant = resolve_variant(variant)
    bs, N, Fe = att.shape
    w = p_cont["h2att"]["weight"].float()
    b = p_cont["h2att"]["bias"].float()
    alpha = p_cont["att_alpha"]["weight"].float().reshape(-1)
    with nn.exact_numerics():
        q = (h.float() @ w.t() + b).view(bs, B, 1, -1)           # [bs,B,1,Ah]
    t = torch.tanh(p_att.float()[:, None] + q)                  # [bs,B,N,Ah]
    e = (t * alpha).sum(-1)                                     # [bs,B,N]
    wts = torch.softmax(e, dim=-1)
    if variant == "v2":
        wts = wts.to(att.dtype).float()
    with nn.exact_numerics():
        res = torch.einsum("bkn,bnf->bkf", wts, att.float())
    return res.to(att.dtype).reshape(bs * B, Fe)


def beam_content_attention(h, p_cont, att, p_att, *, B: int,
                           variant=None):
    """h [bs*B, H] in image-major row order, p_cont =
    params['attention']['cont'], att [bs, N, Fe] and p_att [bs, N, Ah]
    untiled. Returns [bs*B, Fe] in att's dtype. Any bs works; v2 needs
    H % 16 == 0 and Ah, Fe % 8 == 0."""
    variant = resolve_variant(variant)
    if att.device.type == "cpu":
        return beam_content_attention_plain(h, p_cont, att, p_att, B=B,
                                            variant=variant)
    if att.device.type != "cuda":
        raise ValueError(f"beam_content_attention: device {att.device}")
    w = p_cont["h2att"]["weight"]
    b = p_cont["h2att"]["bias"]
    alpha = p_cont["att_alpha"]["weight"]
    bs, N, Fe = att.shape
    Ah, H = w.shape
    tensors = (h, w, b, alpha, p_att, att)
    fns = _FNS[variant]
    if att.dtype not in fns or any(t.dtype != att.dtype for t in tensors):
        raise TypeError("beam_content_attention: all operands must share "
                        "one dtype, float32 or bfloat16: "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != att.device for t in tensors):
        raise ValueError("beam_content_attention: operands on several "
                         "devices")
    if not 1 <= B <= MAX_BEAM:
        raise ValueError(f"beam size {B} outside [1, {MAX_BEAM}]")
    if (h.shape != (bs * B, H) or p_att.shape != (bs, N, Ah)
            or b.shape != (Ah,) or alpha.numel() != Ah):
        raise ValueError(
            f"beam_content_attention shapes: h {tuple(h.shape)}, W "
            f"{tuple(w.shape)}, att {tuple(att.shape)}, p_att "
            f"{tuple(p_att.shape)}, B={B}")
    h, w, b, alpha, p_att, att = (t.contiguous() for t in tensors)
    if variant == "v2" and (H % 16 or Ah % 8 or Fe % 8 or any(
            t.data_ptr() % 16 for t in (h, w, p_att, att))):
        raise ValueError(
            f"beam_content_attention v2 needs H % 16 == 0 (H={H}), Ah and "
            f"Fe % 8 == 0 (Ah={Ah}, Fe={Fe}) and 16-byte aligned operands")
    out = torch.empty((bs * B, Fe), dtype=att.dtype, device=att.device)
    fn = getattr(_lib(variant), fns[att.dtype])
    _build.check(fn(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), p_att.data_ptr(), att.data_ptr(),
                    out.data_ptr(), bs, B, H, Ah, N, Fe,
                    _build.stream_ptr(att.device)),
                 f"beam_content_attention {variant}")
    if variant == "v2":
        beam_content_attention.launches_v2 += 1
    else:
        beam_content_attention.launches += 1
    return out


beam_content_attention.launches = 0      # v1 kernel launches
beam_content_attention.launches_v2 = 0   # v2 kernel launches

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
bf16, N=196, 512 wide: about 46.9 us at 3.35 TB/s), with 115.6 M tanh beside
them. v1 is two launches (``csrc/fused_attention.cu``): a tiled query
product Q = h W^T + b for all bs*B rows into an f32 scratch (bf16 on the
tensor cores, f32 on FFMA), then one block per image that streams p_att and
att through a cp.async ring once for all B beams (see the source's header).
The bf16 instance takes ``tanh.approx.f32`` (``exact_tanh=True`` takes
tanhf, to measure the approximation); f32 takes tanhf. Serving only: no
backward, so a CUDA call raises where an operand requires grad.

v2 computes v1's function with one difference, as ``_kernel_v2`` does: the
softmax weights are rounded to att's dtype before the weighted sum, which
accumulates in f32 (in f32 the two are the same function). It runs on v1's
kernels, with the rounding as the attention kernel's ``kRoundW`` flag
(``isc_beam_att_v2_bf16``, ``tanh.approx.f32`` as v1; the f32 entry runs
v1's instance), so it takes what v1 takes and has v1's bound.

``kernel_takes(B, H, Ah, Fe, dtype)`` says whether a kernel takes a shape;
the beam runs the plain tiled-rows cell where it does not (a beam wider
than ``MAX_BEAM``, odd widths), as the JAX package's beam gates its kernel.
``beam_content_attention`` takes the plain version for CPU tensors and
launches a kernel for CUDA tensors, or raises on what the kernel does not
take. ``variant=None`` reads ``ISC_ATT_KERNEL`` ("v1" when unset) at each
call, here in the wrapper; ``beam_content_attention.launches`` and
``.launches_v2`` count the v1 and v2 wrapper calls that launched (one
each, though each is two kernels).
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import nn
from . import _build

MAX_BEAM = 8     # the kernels' softmax runs one warp per beam
MAX_WIDTH = 2048  # a lane owns 8 of Ah's (and Fe's) channels, 256 lanes
VARIANTS = ("v1", "v2")

_P = ctypes.c_void_p
_I = ctypes.c_int
# h, w, b, alpha, p_att, att, out, the f32 query scratch, bs, B, H, Ah, N,
# Fe, stream
_SIG = [_P] * 8 + [_I] * 6 + [_P]
_FNS = {"v1": {torch.float32: "isc_beam_att_f32",
               torch.bfloat16: "isc_beam_att_bf16"},
        "v2": {torch.float32: "isc_beam_att_v2_f32",
               torch.bfloat16: "isc_beam_att_v2_bf16"}}
_V1_BF16_TANHF = "isc_beam_att_bf16_tanhf"


def _lib():
    fns = [fn for v in VARIANTS for fn in _FNS[v].values()]
    return _build.load("fused_attention",
                       {fn: _SIG for fn in fns + [_V1_BF16_TANHF]})


def resolve_variant(variant=None) -> str:
    """``variant``, or ``ISC_ATT_KERNEL`` ("v1" when unset) for None."""
    if variant is None:
        variant = os.environ.get("ISC_ATT_KERNEL", "v1")
    if variant not in VARIANTS:
        raise ValueError(f"attention kernel variant {variant!r}: one of "
                         f"{VARIANTS}")
    return variant


def kernel_takes(B: int, H: int, Ah: int, Fe: int, dtype,
                 variant=None) -> bool:
    """Whether the ``variant`` kernel (``ISC_ATT_KERNEL`` for None; an
    unknown name raises) takes a beam of ``B`` with h width H, attention
    width Ah and feature width Fe in ``dtype``. v1 and v2 run one kernel:
    B <= 8; bf16 needs H % 16 == 0 (the ``mma`` K) and Ah, Fe % 8 == 0,
    f32 H, Ah, Fe % 4 == 0 (16-byte rows); Ah, Fe <= 2048."""
    variant = resolve_variant(variant)
    if dtype not in _FNS[variant] or not 1 <= B <= MAX_BEAM or min(
            H, Ah, Fe) < 1:
        return False
    vec = 8 if dtype == torch.bfloat16 else 4      # elements in 16 bytes
    return (H % (16 if dtype == torch.bfloat16 else 4) == 0
            and Ah % vec == 0 and Fe % vec == 0
            and max(Ah, Fe) <= MAX_WIDTH)


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
                           variant=None, exact_tanh: bool = False):
    """h [bs*B, H] in image-major row order, p_cont =
    params['attention']['cont'], att [bs, N, Fe] and p_att [bs, N, Ah]
    untiled. Returns [bs*B, Fe] in att's dtype. Any bs and N; the widths
    and B that ``kernel_takes`` accepts, 16-byte aligned operands.
    ``exact_tanh``: v1 bf16 only, tanhf in place of ``tanh.approx.f32``."""
    variant = resolve_variant(variant)
    if att.device.type == "cpu":
        return beam_content_attention_plain(h, p_cont, att, p_att, B=B,
                                            variant=variant)
    if att.device.type != "cuda":
        raise ValueError(f"beam_content_attention: device {att.device}")
    w = p_cont["h2att"]["weight"]
    b = p_cont["h2att"]["bias"]
    alpha = p_cont["att_alpha"]["weight"]
    tensors = (h, w, b, alpha, p_att, att)
    _build.no_grad_guard("beam_content_attention", *tensors)
    fns = _FNS[variant]
    if att.dtype not in fns or any(t.dtype != att.dtype for t in tensors):
        raise TypeError("beam_content_attention: all operands must share "
                        "one dtype, float32 or bfloat16: "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != att.device for t in tensors):
        raise ValueError("beam_content_attention: operands on several "
                         "devices")
    bs, N, Fe = att.shape
    Ah, H = w.shape
    if (h.shape != (bs * B, H) or p_att.shape != (bs, N, Ah)
            or b.shape != (Ah,) or alpha.numel() != Ah):
        raise ValueError(
            f"beam_content_attention shapes: h {tuple(h.shape)}, W "
            f"{tuple(w.shape)}, att {tuple(att.shape)}, p_att "
            f"{tuple(p_att.shape)}, B={B}")
    if not kernel_takes(B, H, Ah, Fe, att.dtype, variant):
        raise ValueError(
            f"beam_content_attention {variant} does not take B={B} (at "
            f"most {MAX_BEAM}), H={H}, Ah={Ah}, Fe={Fe} in {att.dtype} "
            "(kernel_takes)")
    h, w, b, alpha, p_att, att = (t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in (h, w, alpha, p_att, att)):
        raise ValueError("beam_content_attention needs 16-byte aligned "
                         "operands")
    out = torch.empty((bs * B, Fe), dtype=att.dtype, device=att.device)
    q = torch.empty((bs * B, Ah), dtype=torch.float32, device=att.device)
    lib = _lib()
    fn = getattr(lib, fns[att.dtype])
    if variant == "v1" and exact_tanh and att.dtype == torch.bfloat16:
        fn = getattr(lib, _V1_BF16_TANHF)
    what = f"beam_content_attention {variant}"
    with _build.launch(what, h, w, b, alpha, p_att, att, out, q) as stream:
        _build.check(fn(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                        alpha.data_ptr(), p_att.data_ptr(), att.data_ptr(),
                        out.data_ptr(), q.data_ptr(), bs, B, H, Ah, N, Fe,
                        stream), what)
    _build.count(beam_content_attention,
                 "launches_v2" if variant == "v2" else "launches")
    return out


beam_content_attention.launches = 0      # v1 wrapper calls that launched
beam_content_attention.launches_v2 = 0   # v2 wrapper calls that launched

"""Beam-shared content attention over int8 storage (CUDA kernel + plain twin).

Replaces the Pallas kernel ``tools/bench_int8.py`` ``_kernel_i8`` (:283,
pallas_call :309-333), the int8-storage variant that the JAX package's
int8 study measures against the bf16 attention. att and p_att ([bs, N, ·])
are stored as int8 with one f32 scale per (image, channel), from
``quantize_per_channel``, and dequantised in registers; the function is
v1's (``ops/fused_attention.py``), each image's rows read once for all B
beams. h, W_h2att, its bias and alpha are bf16 (the plain version also
takes them all in f32); the output is bf16, as ``_kernel_i8``'s
``out_shape`` is.

What bounds it on the H100: at bs=384, N=196, 512 wide the int8 bytes are
81.5 MB (24.3 us at 3.35 TB/s, half of v1's bf16 bound), and the 115.6 M
tanh take 27.6 us at one special-function operation each, 16 a clock an
SM: the tanh, not the bytes, set the floor. The kernels are v1's design,
in the same source (``csrc/fused_attention.cu``): v1's tiled query product
into an f32 scratch that the wrapper allocates, then
``beam_att_i8_kernel<B, kFast>``, a block an image streaming p_att and att
through v1's ``cp.async`` ring, each int8 value converted by a byte
permute and one add rather than the int-to-float convert. Its tanh is
1 - 2 / (1 + e^2p e^2q) with e^2p shared by the B beams (1 + B
special-function operations a value, within f32 rounding; see the
source); ``exact_tanh=True`` takes tanhf (2B). ``tanh.approx.f32`` is not
used here: it moves the output by more than one bf16 ulp at 512 wide.

``beam_content_attention_i8`` takes the plain version for CPU tensors and
launches the kernels for CUDA tensors (bf16 only, no operand requiring
grad), or raises; ``beam_content_attention_i8.launches`` counts the wrapper
calls that launched (one each, though each is two kernels; v1's own count,
``fused_attention.beam_content_attention.launches``, does not move).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_attention import MAX_WIDTH, beam_content_attention_plain

MAX_BEAM = 8              # the kernel is instantiated for B = 1..8

_P = ctypes.c_void_p
_I = ctypes.c_int
# h, w, b, alpha, p_att_q, p_att_s, att_q, att_s, out, the f32 query
# scratch, bs, B, H, Ah, N, Fe, stream
_SIG = [_P] * 10 + [_I] * 6 + [_P]
_FN, _FN_TANHF = "isc_beam_att_i8_bf16", "isc_beam_att_i8_bf16_tanhf"
_SIGS = {_FN: _SIG, _FN_TANHF: _SIG}


def _lib():
    return _build.load("fused_attention", _SIGS)


def quantize_per_channel(x):
    """x [bs, N, C] -> (q int8 [bs, N, C], s f32 [bs, 1, C]): the absmax
    over the region axis / 127 (+ 1e-12), q = clip(round(x / s), ±127),
    in f32 (the int8 study's ``quant``, bench_int8.py:274-277)."""
    x = x.float()
    s = x.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    return q, s


def dequantize(q, s):
    return q.float() * s


def beam_content_attention_i8_plain(h, p_cont, att_q, att_s, p_att_q,
                                    p_att_s, *, B: int,
                                    out_dtype=torch.bfloat16):
    """The kernel's function in PyTorch: att and p_att dequantised in f32,
    then v1's f32 arithmetic (``beam_content_attention_plain``), rounded
    once to ``out_dtype`` (bf16, as the kernel; f32 keeps the sums)."""
    att = dequantize(att_q, att_s)
    p_att = dequantize(p_att_q, p_att_s)
    return beam_content_attention_plain(h, p_cont, att, p_att,
                                        B=B).to(out_dtype)


def beam_content_attention_i8(h, p_cont, att_q, att_s, p_att_q, p_att_s, *,
                              B: int, exact_tanh: bool = False):
    """h [bs*B, H] in image-major row order, p_cont = {"h2att": {"weight"
    [Ah, H], "bias" [Ah]}, "att_alpha": {"weight" [1, Ah]}} in h's dtype,
    att_q [bs, N, Fe] and p_att_q [bs, N, Ah] int8 with f32 scales att_s
    [bs, 1, Fe] and p_att_s [bs, 1, Ah]. Returns [bs*B, Fe] bf16. Types
    and shapes are checked on every device; the kernel also needs bf16,
    B <= 8, H % 8 == 0, Ah and Fe % 16 == 0 and at most 2048 (a lane owns
    8 channels, 256 lanes) and 16-byte aligned operands (the plain version
    also takes h and the weights in f32). ``exact_tanh``: the kernel takes
    tanhf in place of its factored exponential (the plain version's tanh
    is PyTorch's either way)."""
    w = p_cont["h2att"]["weight"]
    b = p_cont["h2att"]["bias"]
    alpha = p_cont["att_alpha"]["weight"]
    dense = (h, w, b, alpha)
    if (h.dtype not in (torch.bfloat16, torch.float32)
            or any(t.dtype != h.dtype for t in dense)):
        raise TypeError("beam_content_attention_i8: h, W, b and alpha must "
                        "share one dtype, bfloat16 or float32: "
                        f"{[t.dtype for t in dense]}")
    if att_q.dtype != torch.int8 or p_att_q.dtype != torch.int8:
        raise TypeError("beam_content_attention_i8: att_q and p_att_q must "
                        f"be int8: {att_q.dtype}, {p_att_q.dtype}")
    if att_s.dtype != torch.float32 or p_att_s.dtype != torch.float32:
        raise TypeError("beam_content_attention_i8: the scales must be "
                        f"float32: {att_s.dtype}, {p_att_s.dtype}")
    tensors = dense + (att_q, att_s, p_att_q, p_att_s)
    if any(t.device != att_q.device for t in tensors):
        raise ValueError("beam_content_attention_i8: operands on several "
                         "devices")
    if att_q.dim() != 3 or w.dim() != 2:
        raise ValueError(f"beam_content_attention_i8: att_q "
                         f"{tuple(att_q.shape)}, W {tuple(w.shape)}")
    bs, N, Fe = att_q.shape
    Ah, H = w.shape
    if (h.shape != (bs * B, H) or p_att_q.shape != (bs, N, Ah)
            or att_s.shape != (bs, 1, Fe) or p_att_s.shape != (bs, 1, Ah)
            or b.shape != (Ah,) or alpha.numel() != Ah):
        raise ValueError(
            f"beam_content_attention_i8 shapes: h {tuple(h.shape)}, W "
            f"{tuple(w.shape)}, att_q {tuple(att_q.shape)}, att_s "
            f"{tuple(att_s.shape)}, p_att_q {tuple(p_att_q.shape)}, p_att_s "
            f"{tuple(p_att_s.shape)}, B={B}")
    if att_q.device.type == "cpu":
        return beam_content_attention_i8_plain(h, p_cont, att_q, att_s,
                                               p_att_q, p_att_s, B=B)
    if att_q.device.type != "cuda":
        raise ValueError(f"beam_content_attention_i8: device {att_q.device}")
    _build.no_grad_guard("beam_content_attention_i8", *tensors)
    if h.dtype != torch.bfloat16:
        raise TypeError("beam_content_attention_i8: the kernel takes h, W, b "
                        f"and alpha in bfloat16: {h.dtype}")
    if not 1 <= B <= MAX_BEAM:
        raise ValueError(f"beam size {B} outside [1, {MAX_BEAM}]")
    if H % 8 or Ah % 16 or Fe % 16 or max(Ah, Fe) > MAX_WIDTH:
        raise ValueError(f"beam_content_attention_i8 needs H % 8 == 0 "
                         f"(H={H}), Ah and Fe % 16 == 0 and at most "
                         f"{MAX_WIDTH} (Ah={Ah}, Fe={Fe})")
    h, w, b, alpha, att_q, att_s, p_att_q, p_att_s = (
        t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in (h, w, att_q, att_s, p_att_q)):
        raise ValueError("beam_content_attention_i8 needs 16-byte aligned "
                         "operands")
    out = torch.empty((bs * B, Fe), dtype=torch.bfloat16, device=att_q.device)
    q = torch.empty((bs * B, Ah), dtype=torch.float32, device=att_q.device)
    fn = getattr(_lib(), _FN_TANHF if exact_tanh else _FN)
    with _build.launch("beam_content_attention_i8", h, w, b, alpha,
                       att_q, att_s, p_att_q, p_att_s, out, q) as stream:
        _build.check(fn(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), alpha.data_ptr(),
            p_att_q.data_ptr(), p_att_s.data_ptr(), att_q.data_ptr(),
            att_s.data_ptr(), out.data_ptr(), q.data_ptr(), bs, B, H, Ah, N,
            Fe, stream), "beam_content_attention_i8")
    _build.count(beam_content_attention_i8)
    return out


beam_content_attention_i8.launches = 0

"""Fused classifier + log-softmax + bans + exact top-k (CUDA kernel + plain
version).

Replaces the Pallas kernel ``insenticap_model_tpu/ops/fused_topk.py``
``_kernel`` with ``_merge_topk`` (:35-116, pallas_call at :135). The beam
decode's vocabulary-wide tail is, per candidate row r:

    logits[r]  = h[r] @ W^T + b                      (f32 accumulation)
    lse[r]     = log sum_v exp(logits[r, v])         (over ALL V logits)
    candidates = every v except the static ``banned`` ids and ``last[r]``
    out[r]     = the k largest logits[r, v] - lse[r] over the candidates,
                 descending, the lower index first on a tie

(the reference bans after the log-softmax, captioner.py:394-399, so banned
words still count in the normaliser). A slot that no candidate fills (a
row with fewer than k candidates) holds (-1e30, 0), which is what k argmax
passes over the masked row give. ``last[r] < 0`` bans nothing.

W is the port's Linear layout ``[V, H]``; the JAX kernel needs the vocab
padded to its tile width and ``rows % 8 == 0``, the CUDA kernel takes any
V and any row count and masks the ragged tiles itself.

What bounds it on the H100, at serving width (rows = 384 x 3 = 1152,
H = 512, V = 10,000): operations. 2 x 1152 x 512 x 10,000 = 11.8 GFLOP,
11.9 us at the bf16 tensor rate (989 TFLOP/s) against 11.5 MB moved
(3.4 us at 3.35 TB/s); in f32 the same work on FFMA (TF32 would change the
function) is 0.176 ms at 67 TFLOP/s. The design (``csrc/fused_topk.cu``),
two launches: in bf16 one CTA per (128-row block, vocab group) keeps its
rows of h in shared memory, streams W through a ``cp.async`` ring and
multiplies on ``wgmma`` (f32 accumulation: bf16 products are exact in f32,
so it is the same function), and keeps each row's online max, exp-sum and
top-k in registers across the group's vocab tiles; in f32 one block per
(64-row block, 128-word tile) on FFMA. Each writes one partial per (group
or tile, row) to scratch, and a second small kernel merges a row's partials
(max, rescaled sum, top-k) and writes ``[rows, k]``. The ``[rows, V]``
logits never reach device memory. ``vocab_groups`` is the bf16 grid's
split of the vocab (about one wave of CTAs); ``wgmma_product`` runs the
bf16 pass's product alone, as a check against a library product.

``classifier_topk`` runs the plain version for CPU tensors and launches
the kernels for CUDA tensors (raising where an operand requires grad or
``kernel_takes(k, H, dtype)`` fails); ``classifier_topk.launches`` counts
its wrapper calls that launched (one per call, two kernels).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .. import nn
from . import _build

NEG_INF = -1e30          # the beam's finite "banned" sentinel
MAX_K = 8                # the kernels keep up to 8 candidates a row
MAX_BANNED = 8           # static bans pass by value
VOCAB_TILE = 128         # csrc/fused_topk.cu kCols: the wgmma N
ROW_BLOCK = 128          # kRowsW: rows of h resident in a bf16 CTA
MAX_H_BF16 = 640         # kMaxPanels x 64: h's panels beside the W ring

_P = ctypes.c_void_p
_I = ctypes.c_int
# h, w, b, last, banned (host), n_banned, rows, H, V, k, groups, part_f,
# part_i, out_v, out_i, stream
_SIG = [_P, _P, _P, _P, _P] + [_I] * 6 + [_P] * 5
_FNS = {torch.float32: "isc_topk_f32", torch.bfloat16: "isc_topk_bf16"}
_PRODUCT = "isc_topk_product_bf16"   # h, w, logits, rows, H, V, groups, stream
_PRODUCT_SIG = [_P] * 3 + [_I] * 4 + [_P]


def _lib():
    sigs = {fn: _SIG for fn in _FNS.values()}
    sigs[_PRODUCT] = _PRODUCT_SIG
    return _build.load("fused_topk", sigs)


def kernel_takes(k: int, H: int, dtype) -> bool:
    """Whether the kernel takes a top-k of width ``k`` over rows of width
    ``H`` in ``dtype``: k <= ``MAX_K``; bf16 needs H % 8 == 0 (the copies
    move 16-byte pieces of a row) and H <= ``MAX_H_BF16`` (h stays in
    shared memory); f32 takes any H. The beam runs the plain tail
    otherwise, as the JAX package's beam does where its kernel's gate
    fails (its ``_fused_rows``)."""
    if not 1 <= k <= MAX_K or H < 1:
        return False
    if dtype == torch.bfloat16:
        return H % 8 == 0 and H <= MAX_H_BF16
    return dtype == torch.float32


def vocab_groups(rows: int, V: int, sms: int) -> int:
    """The bf16 pass's number of vocab groups: about one CTA an SM over
    the ``ceil(rows / ROW_BLOCK)`` row blocks, at most one group a
    128-word tile. Group g takes the tiles ``[g * tiles // groups,
    (g + 1) * tiles // groups)``."""
    tiles = -(-V // VOCAB_TILE)
    return max(1, min(tiles, sms // -(-rows // ROW_BLOCK)))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t):
    """``t`` contiguous, on a 16-byte boundary (the copies' pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _topk_argmax(x, k: int):
    """Exact top-k along the last axis by k argmax passes: descending, the
    first index winning a tie (the JAX package's ``_topk_argmax``;
    ``torch.topk`` leaves the tie order unspecified)."""
    vals, idxs = [], []
    for _ in range(k):
        i = x.argmax(dim=-1, keepdim=True)
        vals.append(x.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        x = x.scatter(-1, i, NEG_INF)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def classifier_topk_plain(h, w, b, last: Optional[torch.Tensor], *, k: int,
                          banned: Sequence[int] = ()):
    """The kernel's function in PyTorch (and the beam's plain tail): f32
    logits and normaliser, bans on the candidates only, k argmax passes.
    h [rows, H], w [V, H], b [V], last [rows] (or None) -> (logprobs
    [rows, k] f32, ids [rows, k] int64)."""
    with nn.exact_numerics():
        logits = F.linear(h.float(), w.float(), b.float())
    logprobs = nn.log_softmax(logits)                         # [rows, V]
    if banned:
        logprobs[:, list(banned)] = NEG_INF
    if last is not None:
        # a negative id writes back column 0's own value: no ban
        last = last.reshape(-1, 1).long()
        idx = last.clamp(min=0)
        logprobs.scatter_(1, idx, torch.where(last >= 0, NEG_INF,
                                              logprobs.gather(1, idx)))
    return _topk_argmax(logprobs, k)


def classifier_topk(h, w, b, last: Optional[torch.Tensor], *, k: int,
                    banned: Sequence[int] = ()):
    """h [rows, H] (bf16 or f32), w [V, H] and b [V] of h's dtype, last
    [rows] integer ids (negative: no ban; None: no last-word bans) ->
    (logprobs [rows, k] f32, ids [rows, k] int64). Any rows and V; the k
    and H that ``kernel_takes`` accepts."""
    if h.device.type == "cpu":
        return classifier_topk_plain(h, w, b, last, k=k, banned=banned)
    if h.device.type != "cuda":
        raise ValueError(f"classifier_topk: device {h.device}")
    tensors = (h, w, b)
    _build.no_grad_guard("classifier_topk", *tensors)
    if h.dtype not in _FNS or any(t.dtype != h.dtype for t in tensors):
        raise TypeError("classifier_topk: h, w and b must share one dtype, "
                        f"float32 or bfloat16: {[t.dtype for t in tensors]}")
    if any(t.device != h.device for t in tensors) or (
            last is not None and last.device != h.device):
        raise ValueError("classifier_topk: operands on several devices")
    banned = [int(x) for x in banned]
    if len(banned) > MAX_BANNED:
        raise ValueError(f"classifier_topk: {len(banned)} banned ids, at "
                         f"most {MAX_BANNED}")
    rows, H = h.shape
    V = w.shape[0]
    if w.shape != (V, H) or b.shape != (V,) or rows < 1 or V < 1 or (
            last is not None and last.shape != (rows,)):
        raise ValueError(
            f"classifier_topk shapes: h {tuple(h.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}, last "
            f"{None if last is None else tuple(last.shape)}")
    if not kernel_takes(k, H, h.dtype):
        raise ValueError(
            f"classifier_topk does not take k={k} (at most {MAX_K}) with "
            f"H={H} in {h.dtype} (kernel_takes)")
    if last is not None:
        if last.dtype.is_floating_point or last.dtype == torch.bool:
            raise TypeError(f"classifier_topk: last ids dtype {last.dtype}")
        last = last.to(torch.int64).contiguous()
    h, w, b = (_aligned(t) for t in tensors)
    groups = (vocab_groups(rows, V, _sms(h.device))
              if h.dtype == torch.bfloat16 else -(-V // VOCAB_TILE))
    part_f = torch.empty(groups * rows * (2 + k), dtype=torch.float32,
                         device=h.device)
    part_i = torch.empty(groups * rows * k, dtype=torch.int32,
                         device=h.device)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=h.device)
    out_i = torch.empty((rows, k), dtype=torch.int64, device=h.device)
    ban = (ctypes.c_int * MAX_BANNED)(*banned)
    fn = getattr(_lib(), _FNS[h.dtype])
    with _build.launch("classifier_topk", h, w, b, last, part_f, part_i,
                       out_v, out_i) as stream:
        _build.check(fn(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                        None if last is None else last.data_ptr(), ban,
                        len(banned), rows, H, V, k, groups,
                        part_f.data_ptr(), part_i.data_ptr(),
                        out_v.data_ptr(), out_i.data_ptr(), stream),
                     "classifier_topk")
    _build.count(classifier_topk)
    return out_v, out_i


classifier_topk.launches = 0


def wgmma_product(h, w):
    """The bf16 pass's product alone on the card, ``h @ w^T`` as f32
    ``[rows, V]`` (no bias): the check of the ``wgmma`` mainloop (swizzled
    copies, descriptors, accumulator layout) against a library product.
    h [rows, H], w [V, H], bf16 CUDA tensors that ``kernel_takes`` takes.
    Off the serving path; not counted in ``classifier_topk.launches``."""
    if h.device.type != "cuda" or w.device != h.device or not (
            h.dtype == w.dtype == torch.bfloat16):
        raise ValueError("wgmma_product: bf16 CUDA tensors on one device")
    _build.no_grad_guard("wgmma_product", h, w)
    rows, H = h.shape
    V = w.shape[0]
    if w.shape != (V, H) or not kernel_takes(1, H, h.dtype):
        raise ValueError(f"wgmma_product shapes: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}")
    h, w = _aligned(h), _aligned(w)
    out = torch.empty((rows, V), dtype=torch.float32, device=h.device)
    with _build.launch("wgmma_product", h, w, out) as stream:
        _build.check(getattr(_lib(), _PRODUCT)(
            h.data_ptr(), w.data_ptr(), out.data_ptr(), rows, H, V,
            vocab_groups(rows, V, _sms(h.device)), stream),
            "wgmma_product")
    return out

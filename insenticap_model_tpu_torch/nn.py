"""Primitives on plain tensors, with torch-default initialisers.

Parameters are nested dicts of tensors in PyTorch's own layouts, so the
functions below are thin calls into ``torch.nn.functional``:

  linear   : weight [out, in], bias [out]          (F.linear)
  embedding: weight [num, dim]
  lstm_cell: weight_ih [4H, in], weight_hh [4H, H], bias_ih, bias_hh;
             gate order i, f, g, o (torch.nn.LSTMCell)
  conv2d   : weight [kh, kw, in, out] (HWIO) on NHWC activations — the
             layout of the JAX package's public functions, kept so the
             detector's feature grid needs no transpose at the boundary

``convert.from_jax_numpy`` maps the JAX package's ``w``/``b``/``table``
pytrees onto these names and layouts. Every initialiser draws from an
explicit CPU ``torch.Generator`` and then moves to ``device``, so a seed
gives the same weights on every device.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initialisers (torch defaults)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, dtype, device):
    t = torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound,
                                                         generator=gen)
    return t.to(device=device, dtype=dtype)


def linear_init(gen, in_dim: int, out_dim: int, *, dtype=torch.float32,
                device="cpu"):
    """nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)) for weight and bias."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"weight": _uniform(gen, (out_dim, in_dim), bound, dtype, device),
            "bias": _uniform(gen, (out_dim,), bound, dtype, device)}


def embedding_init(gen, num: int, dim: int, pad_id: Optional[int] = None, *,
                   dtype=torch.float32, device="cpu"):
    """nn.Embedding default: N(0, 1); the padding row zeroed."""
    table = torch.empty((num, dim), dtype=torch.float32).normal_(
        generator=gen)
    if pad_id is not None:
        table[pad_id] = 0.0
    return {"weight": table.to(device=device, dtype=dtype)}


def lstm_cell_init(gen, in_dim: int, hid_dim: int, *, dtype=torch.float32,
                   device="cpu"):
    """nn.LSTMCell default: every parameter U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / math.sqrt(hid_dim)
    return {
        "weight_ih": _uniform(gen, (4 * hid_dim, in_dim), bound, dtype,
                              device),
        "weight_hh": _uniform(gen, (4 * hid_dim, hid_dim), bound, dtype,
                              device),
        "bias_ih": _uniform(gen, (4 * hid_dim,), bound, dtype, device),
        "bias_hh": _uniform(gen, (4 * hid_dim,), bound, dtype, device),
    }


def conv2d_init(gen, in_ch: int, out_ch: int, kh: int, kw: int, *,
                bias: bool = True, dtype=torch.float32, device="cpu"):
    """nn.Conv2d default (kaiming_uniform, a=sqrt(5)): U(-b, b) with
    b = 1/sqrt(fan_in), bias likewise; weight stored HWIO."""
    bound = 1.0 / math.sqrt(in_ch * kh * kw)
    p = {"weight": _uniform(gen, (kh, kw, in_ch, out_ch), bound, dtype,
                            device)}
    if bias:
        p["bias"] = _uniform(gen, (out_ch,), bound, dtype, device)
    return p


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def linear(p, x):
    return F.linear(x, p["weight"], p["bias"])


def embed(p, ids, pad_id: Optional[int] = None):
    """Lookup. With ``pad_id`` the rows of pad ids are hard-zeroed (the
    functional form of torch's padding_idx; reference
    models/captioner.py:133-135)."""
    out = F.embedding(ids.long(), p["weight"])
    if pad_id is not None:
        out = out * (ids != pad_id).unsqueeze(-1).to(out.dtype)
    return out


def lstm_cell(p, x, hc: Tuple[torch.Tensor, torch.Tensor]):
    """One LSTM cell step, gate order (i, f, g, o)."""
    h, c = hc
    gates = (F.linear(x, p["weight_ih"]) + F.linear(h, p["weight_hh"])
             + p["bias_ih"] + p["bias_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


_numerics_lock = threading.RLock()


@contextlib.contextmanager
def exact_numerics():
    """Reference numerics for the library calls inside: no TF32 in f32
    matmuls or cuDNN convolutions (cuDNN's default is TF32), and no
    reduced-precision reduction inside bf16 GEMMs (cuBLAS may otherwise
    sum in bf16), so bf16 products accumulate in f32 as the JAX package's
    ``preferred_element_type=float32`` does. The flags are process-wide:
    they are set under a lock (re-entrant, so calls nest) and restored on
    exit. PyTorch reads them when an op is issued, so the asynchronous
    device work needs no longer hold."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    with _numerics_lock:
        prev = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
                c.allow_tf32)
        m.allow_tf32 = False
        m.allow_bf16_reduced_precision_reduction = False
        c.allow_tf32 = False
        try:
            yield
        finally:
            (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             c.allow_tf32) = prev


def conv2d(p, x, padding: str = "SAME"):
    """Stride-1 NHWC conv with an HWIO weight; ``padding`` 'SAME' or
    'VALID' (odd kernels, as the detector uses)."""
    w = p["weight"]
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding {padding!r}")
    pad = (w.shape[0] // 2, w.shape[1] // 2) if padding == "SAME" else 0
    with exact_numerics():
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                       p.get("bias"), padding=pad)
    return out.permute(0, 2, 3, 1)


def log_softmax(x, dim: int = -1):
    return F.log_softmax(x, dim=dim)

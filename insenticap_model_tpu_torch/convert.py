"""Weight bridge between the JAX package's parameter pytrees and the port's.

``from_jax_numpy`` takes the JAX package's pytree as nested dicts/lists of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns
the port's nested dicts of tensors (layouts in ``nn``):

  {"w" [in, out], "b"}                 -> {"weight" [out, in], "bias"}
  {"w" [kh, kw, in, out], "b"?}        -> {"weight" (HWIO, as is), "bias"?}
  {"table"}                            -> {"weight"}
  {"w_ih" [in, 4H], "w_hh", "b_ih", "b_hh"}
      -> {"weight_ih" [4H, in], "weight_hh" [4H, H], "bias_ih", "bias_hh"}
  {"scale", "bias", "mean", "var"}     -> the same (the encoder's BatchNorm)

A leaf may also be a CPU tensor, as the port's checkpoint reader gives
(``training/checkpoint.py``: numpy has no bfloat16, so bf16 arrays arrive
as ``torch.bfloat16``). ``to_jax_numpy`` is the exact inverse (numpy out),
used by the round-trip test. Neither needs JAX: the arrays cross as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.dtypes import resolve_device

_LSTM = ("w_ih", "w_hh", "b_ih", "b_hh")
_BN = {"scale", "bias", "mean", "var"}


def _tensor(a, device, dtype):
    if torch.is_tensor(a):
        return torch.empty(a.shape, dtype=dtype or a.dtype,
                           device=device).copy_(a)
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"     # ml_dtypes: torch cannot read it
    # a copy: JAX's host arrays are read-only
    t = torch.from_numpy(np.array(a, np.float32 if bf16 else None,
                                  order="C", copy=True))
    if bf16 and dtype is None:
        dtype = torch.bfloat16
    return t.to(device=device, dtype=dtype)


def _transpose(a):
    return a.t() if torch.is_tensor(a) else np.asarray(a).T


def _np(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def from_jax_numpy(tree, *, device="cuda", dtype=None):
    """JAX-package pytree (numpy leaves) -> the port's params on
    ``device``; ``dtype`` None keeps each array's own float type."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if not isinstance(node, dict):
            raise TypeError(f"unexpected pytree node {type(node).__name__}")
        keys = set(node)
        if keys == {"table"}:
            return {"weight": _tensor(node["table"], dev, dtype)}
        if keys == _BN:
            return {k: _tensor(v, dev, dtype) for k, v in node.items()}
        if keys == set(_LSTM):
            return {"weight_ih": _tensor(_transpose(node["w_ih"]), dev,
                                         dtype),
                    "weight_hh": _tensor(_transpose(node["w_hh"]), dev,
                                         dtype),
                    "bias_ih": _tensor(node["b_ih"], dev, dtype),
                    "bias_hh": _tensor(node["b_hh"], dev, dtype)}
        if "w" in keys and keys <= {"w", "b"}:
            w = node["w"]
            out = {"weight": _tensor(_transpose(w) if w.ndim == 2 else w,
                                     dev, dtype)}
            if "b" in node:
                out["bias"] = _tensor(node["b"], dev, dtype)
            return out
        return {k: conv(v) for k, v in node.items()}
    return conv(tree)


def to_jax_numpy(tree):
    """The port's params -> the JAX package's pytree layout, numpy leaves
    (bf16 tensors come back as float32)."""
    if isinstance(tree, (list, tuple)):
        return [to_jax_numpy(v) for v in tree]
    keys = set(tree)
    if keys == _BN:
        return {k: _np(v) for k, v in tree.items()}
    if keys == {"weight"} and tree["weight"].dim() == 2:
        return {"table": _np(tree["weight"])}
    if keys == {"weight_ih", "weight_hh", "bias_ih", "bias_hh"}:
        return {"w_ih": _np(tree["weight_ih"]).T.copy(),
                "w_hh": _np(tree["weight_hh"]).T.copy(),
                "b_ih": _np(tree["bias_ih"]), "b_hh": _np(tree["bias_hh"])}
    if "weight" in keys and keys <= {"weight", "bias"}:
        w = _np(tree["weight"])
        out = {"w": w.T.copy() if w.ndim == 2 else w}
        if "bias" in tree:
            out["b"] = _np(tree["bias"])
        return out
    return {k: to_jax_numpy(v) for k, v in tree.items()}

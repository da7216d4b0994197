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
used by the round-trip test; ``to_jax_tensors`` the same with CPU tensors
of the params' own dtype, for the checkpoint writer. None needs JAX: the
arrays cross as numpy.
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


def to_jax_tensors(tree):
    """The port's params -> the JAX package's pytree layout, contiguous CPU
    tensors of the same dtype (bf16 stays bf16): what the checkpoint writer
    packs."""
    return _to_jax(tree, lambda t: t.detach().cpu().contiguous(),
                   lambda t: t.t().contiguous())


def to_jax_numpy(tree):
    """The port's params -> the JAX package's pytree layout, numpy leaves
    (bf16 tensors come back as float32)."""
    return _to_jax(tree, _np, lambda a: a.T.copy())


def _to_jax(tree, leaf, transpose):
    if isinstance(tree, (list, tuple)):
        return [_to_jax(v, leaf, transpose) for v in tree]
    keys = set(tree)
    if keys == _BN:
        return {k: leaf(v) for k, v in tree.items()}
    if keys == {"weight"} and tree["weight"].dim() == 2:
        return {"table": leaf(tree["weight"])}
    if keys == {"weight_ih", "weight_hh", "bias_ih", "bias_hh"}:
        return {"w_ih": transpose(leaf(tree["weight_ih"])),
                "w_hh": transpose(leaf(tree["weight_hh"])),
                "b_ih": leaf(tree["bias_ih"]), "b_hh": leaf(tree["bias_hh"])}
    if "weight" in keys and keys <= {"weight", "bias"}:
        w = leaf(tree["weight"])
        out = {"w": transpose(w) if w.ndim == 2 else w}
        if "bias" in tree:
            out["b"] = leaf(tree["bias"])
        return out
    return {k: _to_jax(v, leaf, transpose) for k, v in tree.items()}

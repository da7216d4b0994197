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

The ``*_from_torch`` half (the JAX package's convert.py:57-129) reads the
reference's PyTorch state dicts (``.pth``, reference train_xe.py:241-254
and train_rl.py:311-325) into the port's trees. The port's layouts are
PyTorch's, so these mostly rename the reference's keys (Linear [out, in]
and LSTM weights as they are; conv weights OIHW -> HWIO, the port's conv
layout); every leaf is an owning float32 copy on ``device``, as
``from_jax_numpy`` of the JAX function's tree gives it. Layer names follow
the reference modules: Captioner models/captioner.py:121-161,
ConceptDetector models/concept_detector.py:10-18, SentimentDetector
models/sentiment_detector.py:11-28, SentenceSentimentClassifier
models/sent_senti_cls.py:12-36.
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


# ---------------------------------------------------------------------------
# Reference PyTorch state dicts -> the port's trees
# ---------------------------------------------------------------------------

def _f32(sd, name, device):
    """An owning float32 copy of a state-dict entry (a tensor or an
    array) on ``device``."""
    v = sd[name]
    if torch.is_tensor(v):
        return v.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(v, np.float32, copy=True)).to(device)


def _lin(sd, name, device):
    return {"weight": _f32(sd, name + ".weight", device),
            "bias": _f32(sd, name + ".bias", device)}


def _emb(sd, name, device):
    return {"weight": _f32(sd, name + ".weight", device)}


def _lstm(sd, prefix, device, suffix=""):
    return {"weight_ih": _f32(sd, f"{prefix}.weight_ih{suffix}", device),
            "weight_hh": _f32(sd, f"{prefix}.weight_hh{suffix}", device),
            "bias_ih": _f32(sd, f"{prefix}.bias_ih{suffix}", device),
            "bias_hh": _f32(sd, f"{prefix}.bias_hh{suffix}", device)}


def _conv(sd, name, device):
    p = {"weight": _f32(sd, name + ".weight", device).permute(2, 3, 1, 0)
         .contiguous()}
    if name + ".bias" in sd:
        p["bias"] = _f32(sd, name + ".bias", device)
    return p


# The reference's state-dict names, one table for both directions: for each
# kind, (reference module name, path of the node in the port's tree, layer
# type). Types: "lin" Linear (weight [out, in], bias), "emb" Embedding,
# "lstm" LSTMCell, "lstm_l0" a one-layer nn.LSTM (its ``_l0`` suffix),
# "conv" Conv2d (weight OIHW in the reference, HWIO in the port; bias
# where present).
_CAP_LIN = ("fc_embed", "cpt2fc", "att_embed", "att2att", "senti2att")


def _ref_names(kind, num_convs=2, num_fcs=2):
    if kind == "captioner":
        att = "attention."
        return ([(f"{k}.0", (k,), "emb")
                 for k in ("word_embed", "senti_label_embed")]
                + [(f"{k}.0", (k,), "lin") for k in _CAP_LIN]
                + [("att_lstm", ("att_lstm",), "lstm"),
                   ("lang_lstm", ("lang_lstm",), "lstm"),
                   ("classifier", ("classifier",), "lin")]
                + [(att + "cont_att." + k, ("attention", "cont", k), "lin")
                   for k in ("h2att", "att_alpha")]
                + [(att + "senti_att." + k, ("attention", "senti", k), "lin")
                   for k in ("h2word", "label2word", "word_alpha")]
                + [(att + k, ("attention", "fuse", k), "lin") for k in (
                    "h2att", "cont2att", "senti2att", "att_alpha")])
    if kind == "concept":
        # Sequential(Linear, ReLU, Linear, ReLU, Dropout, Linear, Sigmoid)
        return [("output.0", ("fc1",), "lin"), ("output.2", ("fc2",), "lin"),
                ("output.5", ("fc3",), "lin")]
    convs = [(f"convs.conv_{i}", ("convs", i), "conv")
             for i in range(num_convs)] + [
        ("senti_conv", ("senti_conv",), "conv")]
    if kind == "sentiment":
        return convs + [(f"output.{j}", ("fcs", j), "lin")
                        for j in range(num_fcs)]
    if kind == "sentiment_full":
        return convs + [("cls", ("cls",), "lin")]
    if kind == "sent_senti_cls":
        return [("word_embed.0", ("word_embed",), "emb"),
                ("rnn", ("lstm",), "lstm_l0"),
                ("excitation.0", ("excitation1",), "lin"),
                ("excitation.2", ("excitation2",), "lin"),
                ("sent_senti_cls.0", ("cls1",), "lin"),
                ("sent_senti_cls.3", ("cls2",), "lin")]
    raise ValueError(f"unknown kind {kind!r}")


# the composite Detector's submodules (reference train_rl.py:311-325): the
# prefix in its state dict (the key in the port's tree) and their kind
DETECTOR_PARTS = {"captioner": "captioner", "senti_detector": "sentiment",
                  "sent_senti_cls": "sent_senti_cls"}

_READ = {"lin": _lin, "emb": _emb, "lstm": _lstm, "conv": _conv,
         "lstm_l0": lambda sd, name, device: _lstm(sd, name, device, "_l0")}


def _from_ref(sd, names, device):
    tree = {}
    for ref, path, layer in names:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _READ[layer](sd, ref, device)

    def lists(node):    # {0: a, 1: b} -> [a, b]
        if not isinstance(node, dict) or "weight" in node:
            return node
        if all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def reference_state_dict(kind, params):
    """The port's params of ``kind`` (a key of ``_ref_names``, or
    "detector" for the composite) as the reference's state dict: its
    names, its layouts (convs OIHW), float32 CPU tensors that own their
    storage. ``*_from_torch`` reads it back bit for bit; the tests hold
    the names against the JAX package's convert.py."""
    if kind == "detector":
        return {f"{part}.{k}": v for part, sub in DETECTOR_PARTS.items()
                for k, v in reference_state_dict(sub, params[part]).items()}
    counts = {}
    if kind.startswith("sentiment"):
        counts = {"num_convs": len(params["convs"]),
                  "num_fcs": len(params.get("fcs", ()))}
    sd = {}
    for ref, path, layer in _ref_names(kind, **counts):
        node = params
        for p in path:
            node = node[p]
        sfx = "_l0" if layer == "lstm_l0" else ""
        for k, v in node.items():
            v = v.detach().to("cpu", torch.float32)
            if layer == "conv" and k == "weight":
                v = v.permute(3, 2, 0, 1)
            sd[f"{ref}.{k}{sfx}"] = v.contiguous().clone()
    return sd


def captioner_from_torch(sd, *, device="cuda"):
    return _from_ref(sd, _ref_names("captioner"), resolve_device(device))


def concept_detector_from_torch(sd, *, device="cuda"):
    return _from_ref(sd, _ref_names("concept"), resolve_device(device))


def sentiment_detector_from_torch(sd, num_convs: int = 2, num_fcs: int = 2,
                                  *, device="cuda"):
    return _from_ref(sd, _ref_names("sentiment", num_convs, num_fcs),
                     resolve_device(device))


def sentiment_detector_full_from_torch(sd, num_convs: int = 2, *,
                                       device="cuda"):
    """The "full" variant (reference models/sentiment_detector_full.py:
    11-30)."""
    return _from_ref(sd, _ref_names("sentiment_full", num_convs),
                     resolve_device(device))


def sent_senti_cls_from_torch(sd, *, device="cuda"):
    return _from_ref(sd, _ref_names("sent_senti_cls"),
                     resolve_device(device))


def detector_from_torch(sd, *, device="cuda"):
    """The RL stage's composite Detector holds the three models under
    prefixes (reference train_rl.py:311-325)."""
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    fns = {"captioner": captioner_from_torch,
           "sentiment": sentiment_detector_from_torch,
           "sent_senti_cls": sent_senti_cls_from_torch}
    return {part: fns[kind](sub(part + "."), device=device)
            for part, kind in DETECTOR_PARTS.items()}

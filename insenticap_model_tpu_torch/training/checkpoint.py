"""Checkpoints: the JAX package's checkpoint files, read into the port's
parameter layout and written from it, without JAX, flax or msgpack.

Counterpart of ``insenticap_model_tpu/training/checkpoint.py`` (:33-121).
The file format (:11-12) is

    [8-byte little-endian header length][JSON metadata][msgpack payload]

where the payload is flax's ``to_bytes`` of ``{"params": ..., "opt_state":
...?}``: nested maps with ndarray leaves, lists written as maps keyed
``"0".."n-1"``. ``load`` decodes it with the port's own decoder
(``utils/msgpack.py``), turns those maps back into lists, and maps the
arrays through ``convert.from_jax_numpy`` onto the port's layout.

The JAX package restores into a template of the expected structure. With
no template passed in, ``load`` builds one: the port's ``init_params`` for
the metadata's settings, vocabulary size and categories, for each subtree
it knows (``captioner``, ``senti_detector`` and ``sent_senti_cls`` of a
composite checkpoint, or a bare captioner, detector, sentence-classifier,
concept-detector or ResNet-101 tree; the last two as ``train_cpt.py`` and
``convert_checkpoint.py resnet101`` write them, the concept count from the
metadata's ``idx2concept``). Every leaf's shape must match it, or
``CheckpointError`` is raised. The optimizer state (optax's tree, as
``training/optim.to_optax_state`` gives it) comes back only when asked.

``save`` writes the same file from the port's params and optimizer state
(``convert.to_jax_tensors``, then ``msgpack.packb``), which the JAX
package's ``load`` reads back bit for bit.
"""
from __future__ import annotations

import json
import os
import struct
import time
from typing import Any, Dict, Optional, Tuple

import torch

from .. import convert
from ..config import Settings
from ..models import captioner as cap
from ..models import concept_detector as cpt_det
from ..models import encoder
from ..models import sent_senti_cls as ss_cls
from ..models import sentiment_detector as senti_det
from ..parallel import mesh
from ..utils import msgpack
from ..utils.dtypes import resolve_device, to_device


# flax's state dict of the JAX package's optimizer (optax's
# inject_hyperparams state)
OPTAX_STATE_KEYS = {"count", "hyperparams", "hyperparams_states",
                    "inner_state"}


class CheckpointError(RuntimeError):
    pass


def _read(path: str, header_only: bool = False):
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise CheckpointError(f"{path}: no checkpoint header")
        (hlen,) = struct.unpack("<Q", raw)
        metadata = json.loads(f.read(hlen).decode())
        return metadata, (None if header_only else f.read())


def save(path: str, params: Any, opt_state: Any, metadata: Dict) -> None:
    """Write ``params`` (the port's layout, any device and float type,
    each kept) and ``opt_state`` (None, or optax's tree as
    ``optim.to_optax_state`` gives it) as the JAX package's
    ``checkpoint.save`` writes them: the 8-byte header length, the JSON
    metadata (sorted keys), the msgpack payload ``{"params": ...,
    "opt_state": ...}``; through a temporary file and ``os.replace``, so
    a reader never sees half a file. Under data parallelism every rank
    calls it: rank 0 alone writes (the ranks hold the same params), and
    every rank then waits at a barrier, so that none reads the file
    before it is whole (the JAX package's process 0, :53-60).

    On a ``[dp, tp]`` mesh a captioner stage's every rank hands in the
    whole captioner, gathered over its model group
    (``parallel.mesh.gather_captioner``, a collective that every model
    group runs; ``optim.to_optax_state`` gathers the moments likewise),
    so that rank 0 writes the one-process file byte for byte, read by
    either package in one process or at another mesh."""
    if opt_state is not None and set(opt_state) != OPTAX_STATE_KEYS:
        raise ValueError("checkpoint.save: the optimizer state must be "
                         "optax's tree, as optim.to_optax_state gives it "
                         f"(keys {sorted(OPTAX_STATE_KEYS)})")
    if mesh.rank() == 0:
        _write(path, params, opt_state, metadata)
    mesh.barrier()


def _write(path: str, params: Any, opt_state: Any, metadata: Dict) -> None:
    payload = {"params": _state_dict(convert.to_jax_tensors(params))}
    if opt_state is not None:
        payload["opt_state"] = _state_dict(opt_state)
    blob = msgpack.packb(payload)
    header = json.dumps(metadata, sort_keys=True).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(blob)
    os.replace(tmp, path)


def load_metadata(path: str) -> Dict:
    return _read(path, header_only=True)[0]


def _lists(node):
    """flax's list encoding ({"0": a, "1": b, ...}) back into lists."""
    if isinstance(node, dict):
        node = {k: _lists(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
    return node


def _state_dict(node):
    """The tree as the JAX package's ``save`` hands it to msgpack: lists as
    flax's ``to_state_dict`` writes them, maps keyed "0".."n-1" (the
    inverse of ``_lists``), and map keys in sorted order, as JAX's
    ``tree_map`` leaves them."""
    if isinstance(node, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(node)}
    if isinstance(node, dict):
        return {str(k): _state_dict(node[k]) for k in sorted(node)}
    return node


def match_tree(node, tmpl, path: str):
    """``node`` with the structure of ``tmpl``: the same keys, list
    lengths and leaf shapes (else ``CheckpointError``, naming ``path``);
    an empty map stands for an empty list."""
    if isinstance(tmpl, list):
        if node == {}:
            node = []
        if not isinstance(node, list) or len(node) != len(tmpl):
            raise CheckpointError(f"{path}: expected a list of {len(tmpl)}, "
                                  f"got {type(node).__name__}")
        return [match_tree(a, b, f"{path}/{i}")
                for i, (a, b) in enumerate(zip(node, tmpl))]
    if isinstance(tmpl, dict):
        if not isinstance(node, dict) or set(node) != set(tmpl):
            got = sorted(node) if isinstance(node, dict) else \
                type(node).__name__
            raise CheckpointError(f"{path}: keys {got} != expected "
                                  f"{sorted(tmpl)}")
        return {k: match_tree(node[k], tmpl[k], f"{path}/{k}") for k in tmpl}
    if tuple(node.shape) != tuple(tmpl.shape):
        raise CheckpointError(f"{path}: shape {tuple(node.shape)} != "
                              f"expected {tuple(tmpl.shape)}")
    return node


def _templates(tree, metadata) -> Dict[str, Any]:
    """The port's init_params for every subtree of ``tree`` it knows, at
    the metadata's settings; keyed like ``tree`` (a composite) or under
    "" (a bare model tree)."""
    settings = Settings.from_dict(metadata.get("settings", {}))
    cats = metadata.get("sentiment_categories")
    n_cats = len(cats) if cats is not None else 3
    if metadata.get("idx2word") is not None:
        vocab = len(metadata["idx2word"])
    else:
        vocab = metadata.get("vocab_size")
    gen = torch.Generator().manual_seed(0)

    def captioner():
        if vocab is None:
            raise CheckpointError("metadata has neither idx2word nor "
                                  "vocab_size: the captioner's vocabulary "
                                  "size is unknown")
        return cap.init_params(gen, int(vocab), n_cats, settings,
                               device="cpu")

    def detector():
        return senti_det.module_for(settings).init_params(
            gen, n_cats, settings, device="cpu")

    def classifier():
        if vocab is None:
            raise CheckpointError("metadata has neither idx2word nor "
                                  "vocab_size: the classifier's vocabulary "
                                  "size is unknown")
        return ss_cls.init_params(gen, int(vocab), n_cats, settings,
                                  device="cpu")

    def concepts():
        if metadata.get("idx2concept") is None:
            raise CheckpointError("a concept tree needs idx2concept in the "
                                  "metadata: the number of concepts is "
                                  "unknown")
        return cpt_det.init_params(gen, len(metadata["idx2concept"]),
                                   settings, device="cpu")

    makers = {"captioner": captioner, "senti_detector": detector,
              "sent_senti_cls": classifier}
    if set(makers) & set(tree):
        return {k: makers[k]() for k in makers if k in tree}
    # the classifier's tree also has a word_embed: tell it by its own keys
    if "excitation1" in tree and "cls2" in tree:
        return {"": classifier()}
    if "word_embed" in tree:
        return {"": captioner()}
    if "senti_conv" in tree:
        return {"": detector()}
    if "layers" in tree:                  # convert_checkpoint.py resnet101
        return {"": encoder.init_params(gen, device="cpu")}
    if "fc1" in tree:
        return {"": concepts()}
    raise CheckpointError(f"the port has no model for a tree with keys "
                          f"{sorted(tree)}")


def load(path: str, *, device="cuda", dtype: Optional[torch.dtype] = None,
         with_opt_state: bool = False) -> Tuple:
    """Read a checkpoint written by the JAX package's ``checkpoint.save``.
    Returns (params, metadata): params in the port's layout on ``device``,
    each float keeping its stored type unless ``dtype`` is given. A
    composite comes back as a dict of its known parts; a bare model tree
    as that model's params. ``with_opt_state`` returns (params, opt_state,
    metadata), opt_state the stored optax tree (CPU tensors in the JAX
    package's layout, for ``optim.load_optax_state``), or None."""
    dev = resolve_device(device)
    metadata, blob = _read(path)
    try:
        payload = msgpack.unpackb(blob)
    except ValueError as e:
        raise CheckpointError(f"{path}: {e}") from e
    if not isinstance(payload, dict) or "params" not in payload:
        raise CheckpointError(f"{path}: no params in the payload")
    tree = _lists(payload["params"])
    if not isinstance(tree, dict):
        raise CheckpointError(f"{path}: params is not a tree of arrays")
    out = {}
    for key, tmpl in _templates(tree, metadata).items():
        where = f"{path}:{key or 'params'}"
        try:
            port = convert.from_jax_numpy(tree[key] if key else tree,
                                          device="cpu")
        except (TypeError, AttributeError) as e:
            raise CheckpointError(f"{where}: {e}") from e
        out[key] = to_device(match_tree(port, tmpl, where), dev, dtype)
    params = out[""] if "" in out else out
    if not with_opt_state:
        return params, metadata
    opt_state = payload.get("opt_state")
    return params, (None if opt_state is None else _lists(opt_state)), \
        metadata


def validate_metadata(metadata: Dict, *, settings: Settings,
                      idx2word=None, sentiment_categories=None,
                      dataset_name: Optional[str] = None,
                      corpus_type: Optional[str] = None) -> None:
    """Settings/vocabulary/dataset equality with a checkpoint (the
    reference's resume assertions, train_xe.py:42-51)."""
    ck = Settings.from_dict(metadata.get("settings", {}))
    if ck != settings:
        raise CheckpointError(
            f"settings mismatch: checkpoint {ck} != current {settings}")
    if idx2word is not None and metadata.get("idx2word") is not None:
        if list(metadata["idx2word"]) != list(idx2word):
            raise CheckpointError("idx2word mismatch with checkpoint")
    if sentiment_categories is not None and \
            metadata.get("sentiment_categories") is not None:
        if list(metadata["sentiment_categories"]) != list(
                sentiment_categories):
            raise CheckpointError("sentiment_categories mismatch")
    for name, val in (("dataset_name", dataset_name),
                      ("corpus_type", corpus_type)):
        if val is not None and metadata.get(name) is not None \
                and metadata[name] != val:
            raise CheckpointError(
                f"{name} mismatch: {metadata[name]} != {val}")


def checkpoint_name(stage_dir: str, epoch: int, train_loss: float,
                    val_loss: float) -> str:
    """The reference's file name (train_xe.py:252-253:
    model_<epoch>_<train>_<val>_<mmdd-HHMM>, here .ckpt)."""
    stamp = time.strftime("%m%d-%H%M")
    return os.path.join(stage_dir, f"model_{epoch}_{train_loss:.4f}_"
                        f"{val_loss:.4f}_{stamp}.ckpt")

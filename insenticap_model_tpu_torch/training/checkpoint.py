"""Checkpoint reader: the JAX package's checkpoint files, loaded into the
port's parameter layout without JAX, flax or msgpack.

Counterpart of the load side of ``insenticap_model_tpu/training/
checkpoint.py`` (:33-121). The file format (:11-12) is

    [8-byte little-endian header length][JSON metadata][msgpack payload]

where the payload is flax's ``to_bytes`` of ``{"params": ..., "opt_state":
...?}``: nested maps with ndarray leaves, lists written as maps keyed
``"0".."n-1"``. ``load`` decodes it with the port's own decoder
(``utils/msgpack.py``), turns those maps back into lists, and maps the
arrays through ``convert.from_jax_numpy`` onto the port's layout.

The JAX package restores into a template of the expected structure. With
no template passed in, ``load`` builds one: the port's ``init_params`` for
the metadata's settings, vocabulary size and categories, for each subtree
it knows (``captioner`` and ``senti_detector`` of a composite checkpoint,
or a bare captioner, detector, concept-detector or ResNet-101 tree; the
last two as ``train_cpt.py`` and ``convert_checkpoint.py resnet101``
write them, the concept count from the metadata's ``idx2concept``). Every
leaf's shape must match it,
or ``CheckpointError`` is raised. Subtrees the port has no model for yet
(the RL composite's ``sent_senti_cls``) and the optimizer state are left
out, as a JAX template restore leaves out what its template lacks. The
writer comes with the training slice.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import torch

from .. import convert
from ..config import Settings
from ..models import captioner as cap
from ..models import concept_detector as cpt_det
from ..models import encoder
from ..models import sentiment_detector as senti_det
from ..utils import msgpack
from ..utils.dtypes import resolve_device, to_device


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


def load_metadata(path: str) -> Dict:
    return _read(path, header_only=True)[0]


def _lists(node):
    """flax's list encoding ({"0": a, "1": b, ...}) back into lists."""
    if isinstance(node, dict):
        node = {k: _lists(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
    return node


def _match(node, tmpl, path: str):
    """``node`` with the structure of ``tmpl``: the same keys, list
    lengths and leaf shapes; an empty map stands for an empty list."""
    if isinstance(tmpl, list):
        if node == {}:
            node = []
        if not isinstance(node, list) or len(node) != len(tmpl):
            raise CheckpointError(f"{path}: expected a list of {len(tmpl)}, "
                                  f"got {type(node).__name__}")
        return [_match(a, b, f"{path}/{i}")
                for i, (a, b) in enumerate(zip(node, tmpl))]
    if isinstance(tmpl, dict):
        if not isinstance(node, dict) or set(node) != set(tmpl):
            got = sorted(node) if isinstance(node, dict) else \
                type(node).__name__
            raise CheckpointError(f"{path}: keys {got} != expected "
                                  f"{sorted(tmpl)}")
        return {k: _match(node[k], tmpl[k], f"{path}/{k}") for k in tmpl}
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

    def concepts():
        if metadata.get("idx2concept") is None:
            raise CheckpointError("a concept tree needs idx2concept in the "
                                  "metadata: the number of concepts is "
                                  "unknown")
        return cpt_det.init_params(gen, len(metadata["idx2concept"]),
                                   settings, device="cpu")

    if "captioner" in tree or "senti_detector" in tree:
        makers = {"captioner": captioner, "senti_detector": detector}
        return {k: makers[k]() for k in makers if k in tree}
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


def load(path: str, *, device="cuda", dtype: Optional[torch.dtype] = None
         ) -> Tuple[Dict, Dict]:
    """Read a checkpoint written by the JAX package's ``checkpoint.save``.
    Returns (params, metadata): params in the port's layout on ``device``,
    each float keeping its stored type unless ``dtype`` is given. A
    composite comes back as a dict of its known parts; a bare model tree
    as that model's params."""
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
        out[key] = to_device(_match(port, tmpl, where), dev, dtype)
    return (out[""] if "" in out else out), metadata


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

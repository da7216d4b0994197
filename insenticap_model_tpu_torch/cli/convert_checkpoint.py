"""Convert the reference's PyTorch checkpoints (``.pth``) into checkpoint
files, keeping the metadata contract.

    python -m insenticap_model_tpu_torch.cli.convert_checkpoint KIND IN.pth \\
        OUT.ckpt [--device cpu]

KIND: captioner | concept | sentiment | sent_senti_cls | detector |
resnet101

Counterpart of ``insenticap_model_tpu/cli/convert_checkpoint.py``: the
state dict (the blob's ``model``, or the blob itself) goes through the
port's ``convert.*_from_torch`` (``resnet101``: the torchvision state dict
through ``models/encoder.convert_torch_state_dict``) onto ``--device``,
and the port's ``training/checkpoint.save`` writes it with the blob's
metadata, so the file is byte for byte the JAX CLI's for the same
``.pth``. ``torch.load`` keeps its default ``weights_only=True``.
"""
from __future__ import annotations

import argparse

import torch

from .. import convert
from ..training import checkpoint as ckpt

KINDS = ("captioner", "concept", "sentiment", "sent_senti_cls", "detector",
         "resnet101")


def run(kind: str, in_path: str, out_path: str, device="cuda") -> None:
    blob = torch.load(in_path, map_location="cpu")
    if kind == "resnet101":
        from ..models import encoder as enc
        params = enc.convert_torch_state_dict(blob, device=device)
        ckpt.save(out_path, params, None, {"kind": "resnet101",
                                           "epoch": -1})
        print(f"wrote {out_path}")
        return

    sd = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    fn = {
        "captioner": convert.captioner_from_torch,
        "concept": convert.concept_detector_from_torch,
        "sentiment": convert.sentiment_detector_from_torch,
        "sent_senti_cls": convert.sent_senti_cls_from_torch,
        "detector": convert.detector_from_torch,
    }[kind]
    params = fn(sd, device=device)
    metadata = {"kind": kind, "epoch": blob.get("epoch", -1)}
    for key in ("settings", "idx2word", "idx2concept",
                "sentiment_categories", "dataset_name", "corpus_type",
                "max_seq_len"):
        if isinstance(blob, dict) and key in blob:
            metadata[key] = blob[key]
    ckpt.save(out_path, params, None, metadata)
    print(f"wrote {out_path} (epoch {metadata['epoch']})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=KINDS)
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("--device", default="cuda",
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu")
    a = p.parse_args(argv)
    run(a.kind, a.in_path, a.out_path, a.device)


if __name__ == "__main__":
    main()

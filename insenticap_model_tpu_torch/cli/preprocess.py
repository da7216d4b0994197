"""Offline preprocessing CLI (reference preprocess.py __main__, which
toggles stages by editing comments; here subcommands), on the card.

    python -m insenticap_model_tpu_torch.cli.preprocess STAGE [flags] \\
        [--device cpu]

Stages: features | captions | senti_corpus | idx2concept | senti_labels |
idx2word | det_sentiments | senti_captions | anno | lms | corpus_all
(corpus_all = everything after feature extraction and concept detection,
in dependency order).

Counterpart of ``insenticap_model_tpu/cli/preprocess.py``, with its flags
plus ``--device`` (``features`` runs ResNet-101 there; the other stages
are host code and subprocesses). One difference: ``--store_format``
defaults to ``native`` (the ``.isc`` record store), where the JAX CLI's
default is ``h5``; the port writes no HDF5, and ``--store_format h5`` is
refused by name.
"""
from __future__ import annotations

import argparse

from .. import preprocessing as pp


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("stage", choices=[
        "features", "captions", "senti_corpus", "idx2concept",
        "senti_labels", "idx2word", "det_sentiments", "senti_captions",
        "anno", "lms", "corpus_all"])
    # reference preprocess.py:471-484 flag surface
    p.add_argument("--imgs_dir", type=str,
                   default="./data/images/sentiment")
    p.add_argument("--feats_dir", type=str,
                   default="./data/features/sentiment")
    p.add_argument("--resnet101_file", type=str,
                   default="./data/pre_models/resnet101.pth")
    p.add_argument("--caption_datasets_dir", type=str,
                   default="../../dataset/caption/caption_datasets")
    p.add_argument("--dataset_names", type=str, nargs="+",
                   default=["flickr30k", "coco"])
    p.add_argument("--captions_dir", type=str, default="./data/captions/")
    p.add_argument("--corpus_dir", type=str, default="./data/corpus")
    p.add_argument("--senti_imgs_dir", type=str,
                   default="./data/images/sentiment")
    p.add_argument("--img_senti_labels", type=str,
                   default="./data/captions/img_senti_labels.json")
    p.add_argument("--corpus_type", type=str, default="part",
                   choices=["part", "full"])
    p.add_argument("--store_format", type=str, default="native",
                   choices=["h5", "native"],
                   help="native (.isc; the default); h5 is refused: the "
                        "port writes and reads no HDF5")
    p.add_argument("--feat_bucket_mode", type=str, default="resize",
                   choices=["exact", "resize"],
                   help="features stage shape policy: 'resize' (the "
                        "default: a static bucket ladder, raw uint8 batches "
                        "normalised inside conv1) or 'exact' (the images' "
                        "own sizes, as the reference)")
    p.add_argument("--feat_bucket_shapes", type=str,
                   default="448x448,384x512,512x384",
                   help="comma-separated HxW ladder for "
                        "--feat_bucket_mode resize")
    p.add_argument("--feat_batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu")
    return p


def _parse_bucket_shapes(spec: str):
    return tuple(tuple(int(d) for d in part.split("x"))
                 for part in spec.split(","))


def _encoder_params(resnet101_file: str, device="cuda"):
    import torch
    from ..models import encoder as enc
    sd = torch.load(resnet101_file, map_location="cpu")
    return enc.convert_torch_state_dict(sd, device=device)


def main(argv=None):
    a = build_parser().parse_args(argv)
    if a.stage == "features":
        pp.check_store_format(a.store_format)   # before the weights load
        pp.extract_imgs_feat(a.imgs_dir, a.feats_dir,
                             _encoder_params(a.resnet101_file, a.device),
                             store_format=a.store_format,
                             batch_size=a.feat_batch_size,
                             bucket_mode=a.feat_bucket_mode,
                             bucket_shapes=_parse_bucket_shapes(
                                 a.feat_bucket_shapes),
                             device=a.device)
    elif a.stage == "captions":
        pp.process_caption_datasets(a.caption_datasets_dir, a.captions_dir,
                                    a.dataset_names)
    elif a.stage == "senti_corpus":
        pp.process_senti_corpus(a.corpus_dir, a.corpus_type)
    elif a.stage == "idx2concept":
        pp.build_idx2concept(a.captions_dir, a.dataset_names)
    elif a.stage == "senti_labels":
        pp.get_img_senti_labels(a.senti_imgs_dir, a.img_senti_labels,
                                a.seed)
    elif a.stage == "idx2word":
        pp.build_idx2word(a.captions_dir, a.corpus_dir, a.dataset_names,
                          a.corpus_type)
    elif a.stage == "det_sentiments":
        pp.get_img_det_sentiments(a.captions_dir, a.corpus_dir,
                                  a.dataset_names, a.corpus_type)
    elif a.stage == "senti_captions":
        pp.get_senti_captions(a.captions_dir, a.corpus_dir, a.dataset_names,
                              a.corpus_type)
    elif a.stage == "anno":
        pp.get_anno_captions(a.caption_datasets_dir, a.captions_dir,
                             a.dataset_names)
    elif a.stage == "lms":
        pp.get_lm_sents(a.captions_dir, a.dataset_names, a.corpus_type)
    elif a.stage == "corpus_all":
        pp.process_caption_datasets(a.caption_datasets_dir, a.captions_dir,
                                    a.dataset_names)
        pp.process_senti_corpus(a.corpus_dir, a.corpus_type)
        pp.build_idx2concept(a.captions_dir, a.dataset_names)
        pp.build_idx2word(a.captions_dir, a.corpus_dir, a.dataset_names,
                          a.corpus_type)
        pp.get_senti_captions(a.captions_dir, a.corpus_dir, a.dataset_names,
                              a.corpus_type)
        pp.get_anno_captions(a.caption_datasets_dir, a.captions_dir,
                             a.dataset_names)
        pp.get_lm_sents(a.captions_dir, a.dataset_names, a.corpus_type)


if __name__ == "__main__":
    main()

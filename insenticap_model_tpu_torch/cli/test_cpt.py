"""One image's concepts against its ground truth, with the wrong rate
(reference test_cpt.py).

    python -m insenticap_model_tpu_torch.cli.test_cpt -t CONCEPT_CKPT \\
        [-i IMAGE_FILE] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/test_cpt.py``: the concept
checkpoint's top ``num_concepts`` concepts of one test image (``-i``, or
the first test image by name) from the dataset's fc store, printed with
their scores, the image's ground-truth concepts and the share of detected
concepts not among them.
"""
from __future__ import annotations

import os

import torch

from ..config import Opts
from ..models import concept_detector as cpt_det
from . import common
from .detect_concepts import load_concepts
from .opts import parse_opt


def run(opt: Opts):
    """Prints the report; returns (image, concepts, scores, wrong)."""
    rt = common.Runtime(opt)
    params, idx2concept, dataset_name = load_concepts(rt, opt.test_model)
    img_concepts = common.load_json(
        os.path.join(opt.captions_dir, dataset_name, "img_concepts.json"))
    fc = common.open_store(common.sniff_store_path(os.path.join(
        opt.feats_dir, dataset_name, f"{dataset_name}_fc.h5")))
    test_img = opt.image_file or sorted(img_concepts["test"])[0]
    feat = rt.put({"fc": fc.batch([test_img])})["fc"]
    with torch.no_grad():
        _, top_idx, top_scores = cpt_det.sample(params, feat,
                                                opt.num_concepts)
    concepts = [idx2concept[k] for k in top_idx[0].cpu().numpy()]
    scores = top_scores[0].float().cpu().numpy()

    truth = img_concepts["test"][test_img]
    print("test_img: ", test_img)
    print("concepts: ", concepts)
    print("scores: ", scores)
    print("ground truth: ", truth)
    wrong = [c for c in concepts if c not in truth]
    print("\nwrong rate:", len(wrong) / len(concepts))
    print("wrong concepts:", wrong)
    return test_img, concepts, scores, wrong


def main(argv=None):
    run(parse_opt(argv))


if __name__ == "__main__":
    main()

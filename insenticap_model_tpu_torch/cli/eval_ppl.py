"""Perplexity of generated captions under the per-sentiment trigram LMs
(reference eval_ppl.py, which runs SRILM's ``ngram -ppl``): the port's
copy of ``insenticap_model_tpu/cli/eval_ppl.py``. Host subprocesses only,
no tensor work.

    python -m insenticap_model_tpu_torch.cli.eval_ppl PREFIX DATA_TYPE

Scorer, in this order (as the JAX CLI's):
  1. SRILM's ``ngram`` where it is on PATH;
  2. else the repo's C++ trigram tool ``native/build/isclm`` (``make -C
     native``), which reads the same ARPA ``.sri`` files and reports
     SRILM's ppl (OOVs excluded, </s> counted).
Where neither exists it raises; so does a scorer that fails and an input
that is missing: a ppl is never reported as 0.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from ..preprocessing import _isclm_binary

SENTIS = ["positive", "negative", "neutral"]
LM_PATH = "./data/captions/%s/%s/lm/%s_w.sri"


def _run_scorer(cmd, text_file: str, lm_file: str) -> float:
    """Run an LM scorer and parse 'ppl= <value>'. Failures raise (missing
    text/LM file, scorer crash, unparseable output) — silently returning
    0.0 would deflate the printed per-sentiment scores and their sum."""
    for f in (text_file, lm_file):
        if not os.path.exists(f):
            raise FileNotFoundError(f"ppl scorer input missing: {f}")
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed (rc={r.returncode}): "
                           f"{r.stderr.strip() or r.stdout.strip()}")
    out = r.stdout.split()
    try:
        return float(out[out.index("ppl=") + 1])
    except (ValueError, IndexError) as e:
        raise RuntimeError(
            f"could not parse ppl from {cmd[0]} output: "
            f"{r.stdout.strip()!r}") from e


def _ppl_via_ngram(text_file: str, lm_file: str) -> float:
    return _run_scorer(["ngram", "-ppl", text_file, "-lm", lm_file],
                       text_file, lm_file)


def _ppl_via_isclm(binary: str, text_file: str, lm_file: str) -> float:
    return _run_scorer([binary, "ppl", lm_file, text_file],
                       text_file, lm_file)


def compute_ppl(captions_file_prefix: str, data_type: str) -> dict:
    dataset_name = "flickr30k" if "flickr30k" in captions_file_prefix \
        else "coco"
    corpus_type = "full" if "full" in captions_file_prefix else "part"

    use_ngram = shutil.which("ngram") is not None
    isclm = None if use_ngram else _isclm_binary()
    if not use_ngram and isclm is None:
        raise RuntimeError(
            "no LM scorer: neither SRILM 'ngram' nor the in-tree 'isclm' "
            "binary is available (build with `make -C native`)")

    scores = {}
    for senti in SENTIS:
        text = f"{captions_file_prefix}_{senti}_{data_type}_w.txt"
        lm = LM_PATH % (dataset_name, corpus_type, senti)
        scores[senti] = (_ppl_via_ngram(text, lm) if use_ngram
                         else _ppl_via_isclm(isclm, text, lm))
    print("ppl scores:", scores)
    print("ppl scores sum:", sum(scores.values()))
    return scores


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("captions_file_prefix")
    p.add_argument("data_type")
    a = p.parse_args(argv)
    compute_ppl(a.captions_file_prefix, a.data_type)


if __name__ == "__main__":
    main()

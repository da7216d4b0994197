"""The port's quality-metrics anchor: its seven stages as one chain.

The PyTorch port's counterpart of ``tools/build_anchor.py``: the same
stages in the same order and with the same Opts, run by the port's CLIs
(``insenticap_model_tpu_torch.cli``) from the port's own synthetic corpus
(``insenticap_model_tpu_torch/synthetic.py``), scored by the port's
paper-table harness (``cli/reproduce_table``). ``main`` writes
``ANCHOR_TORCH.json`` (the JAX anchor's keys) and the slow test
``tests/test_torch_metrics_anchor.py`` holds a rebuild on the CPU to it,
so a metric-affecting change anywhere in the port's chain (model math,
data layer, beam search, rewards, scorers) shows without COCO.

    python tools/build_anchor_torch.py --device cpu \\
        [--out ANCHOR_TORCH.json] [--compare ANCHOR.json ...]
    python tools/build_anchor_torch.py --out /tmp/card.json \\
        --compare ANCHOR_TORCH.json --bf16 --report chiprun_out/anchor.json

``--device`` is the card by default. ``--compare`` prints, for each
anchor file named, the rebuilt table's violations of its table under its
tolerances (``compare_tables``). ``--bf16`` scores the same tree again
with ``compute_dtype="bfloat16"`` (the card's serving path: v1 and the
three Winograd kernels, their launches counted) and holds it to the f32
table. ``--report`` writes the chain's wall time, the bf16 table, its
launches and the violations.

The tool imports nothing of the JAX package: ``EPOCHS``,
``TOLERANCES``, ``ANCHOR_SETTINGS`` and ``compare_tables`` are copies of
``tools/build_anchor.py``'s (the tests hold them equal). The two
packages' random streams (dropout, scheduled sampling, the RL draws)
differ, so the port's table is its own anchor; its distance from
``ANCHOR.json`` is a finding, not a gate.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the chain's epochs: the tiny models converge (losses plateau, metrics
# stabilise) in minutes on a CPU; senti needs the most (its train split
# is 8 images, an epoch 2 steps, and the detector must clear the 0.7
# neutral threshold on the test images for the dump to carry all three
# sentiments)
EPOCHS = {"concept": 5, "senti": 50, "xe": 8, "rl": 2}

# |rebuilt - anchored| bounds per metric family: a rebuild on one host is
# bit-identical (seeded corpus, seeded trainers, beam decode); these
# absorb another platform's float drift flipping a beam tie or one
# classification
TOLERANCES = {
    "quality_abs": 5.0,      # Bleu-*/METEOR*/CIDEr-D, 0-100 scale
    "ppl_rel": 0.25,         # per-sentiment trigram perplexities
    "cls_abs": 0.2,          # cls accuracy, 0-1 scale
    "wrong_rate_abs": 0.2,   # det_sentis_wrong_rate, 0-1 scale
}

# the chain's architecture (tiny widths)
ANCHOR_SETTINGS = dict(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                       feat_emb_dim=16, rnn_hid_dim=16, att_hid_dim=16,
                       concept_mid_dim=24)

CORPUS = "insenticap_model_tpu_torch/synthetic.py"


@contextlib.contextmanager
def _chdir(d):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(cwd)


def _epoch_of(path):
    return int(os.path.basename(path).split("_")[1].split(".")[0])


def _last(pattern):
    ck = glob.glob(pattern)
    assert ck, f"no checkpoints match {pattern}"
    return sorted(ck, key=_epoch_of)[-1]


def _promote_best(stage_dir):
    shutil.copy(_last(os.path.join(stage_dir, "model_*.ckpt")),
                os.path.join(stage_dir, "model-best.ckpt"))


def ensure_isclm() -> str:
    """``native/build/isclm``, the repo's trigram LM tool that the ppl
    column and the LM stage run, compiled with the host's C++ compiler
    where absent."""
    from insenticap_model_tpu_torch.ops import _build
    path = os.path.join(REPO, "native", "build", "isclm")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run([_build._cxx(), "-O2", "-std=c++17", "-o", path,
                        os.path.join(REPO, "native", "isclm.cc")],
                       check=True)
    return path


def anchor_opts(seed: int = 0, device: str = "cpu", **kw):
    """The Opts every stage of the chain runs with."""
    from insenticap_model_tpu_torch.config import Opts, Settings
    return Opts(settings=Settings(**ANCHOR_SETTINGS), num_concepts=3,
                max_seq_len=8, seed=seed, device=device, **kw)


def score_checkpoint(root: str, seed: int = 0, tag: str = "anchor",
                     out: str = "result/anchor_table.json",
                     device: str = "cpu", **opt_kw) -> dict:
    """Stage 7 alone: the paper-table harness on the last RL checkpoint
    of a ``run_pipeline`` tree. ``opt_kw`` sets serving options, e.g.
    ``compute_dtype="bfloat16"`` for the card's bf16 serving path."""
    from insenticap_model_tpu_torch.cli import reproduce_table
    with _chdir(root):
        return reproduce_table.reproduce(
            anchor_opts(seed=seed, device=device, rl_bs=6, beam_size=2,
                        img_senti_labels="data/captions/"
                                         "img_senti_labels.json", **opt_kw),
            _last("checkpoint/rl/coco/part/model_*.ckpt"),
            tag=tag,
            anno_file="data/captions/coco/anno_captions.json",
            out=out)


def run_pipeline(root: str, seed: int = 0, epochs=EPOCHS,
                 device: str = "cpu") -> dict:
    """Fabricate the synthetic tree under ``root``, run the seven stages
    on ``device`` and return the paper table (the anchor's payload)."""
    import numpy as np

    from insenticap_model_tpu_torch import preprocessing as pp
    from insenticap_model_tpu_torch import synthetic
    from insenticap_model_tpu_torch.cli import (detect_concepts, train_cpt,
                                                train_rl, train_senti,
                                                train_sent_senti_cls_rnn
                                                as tcls, train_xe)
    from insenticap_model_tpu_torch.config import Settings

    def opts(**kw):
        return anchor_opts(seed=seed, device=device, **kw)

    os.makedirs(root, exist_ok=True)
    synthetic.build_tree(root, Settings(**ANCHOR_SETTINGS), seed=seed)
    with _chdir(root):
        # 1. concept detector + batch detection
        train_cpt.train(opts(concept_epochs=epochs["concept"],
                             concept_bs=8))
        detect_concepts.run(opts(
            eval_model=_last("checkpoint/concept/coco/model_*.ckpt")))
        # 2. image sentiment detector
        train_senti.train(opts(
            senti_epochs=epochs["senti"], senti_bs=4,
            img_senti_labels="data/captions/img_senti_labels.json"))
        senti_ck = _last("checkpoint/sentiment/model_*.ckpt")
        # 3. sentence sentiment classifier (the reference's fixed 30 epochs)
        tcls.train(opts())
        _promote_best("checkpoint/sent_senti_cls/coco/part")
        # 4. XE captioner
        train_xe.train(opts(xe_epochs=epochs["xe"], xe_bs=6, beam_size=2))
        _promote_best("checkpoint/xe/coco/part")
        # 5. the RL stage's inputs that the real pipeline's preprocessing
        # makes
        with open("data/captions/coco/img_det_concepts.json") as f:
            det = json.load(f)
        with open("data/captions/coco/part/img_det_sentiments.json",
                  "w") as f:
            json.dump({fn: ["happy", "sad"] for fn in det}, f)
        os.makedirs("data/corpus/part", exist_ok=True)
        with open("data/corpus/part/sentiment_words.json", "w") as f:
            json.dump({"positive": {"happy": 1.0},
                       "negative": {"sad": 1.0}}, f)
        train_rl.train(opts(
            rl_epochs=epochs["rl"], rl_bs=6, beam_size=2,
            rl_senti_resume=senti_ck, rl_senti_times=1,
            img_senti_labels="data/captions/img_senti_labels.json"))
        # 6. scoring inputs: word-form ground truth + per-sentiment LMs
        with open("data/captions/coco/img_captions.json") as f:
            img_captions = json.load(f)
        anno = {fn: [" ".join(c) for c in caps]
                for split in img_captions
                for fn, caps in img_captions[split].items()}
        # the sentiment test images need references too, or the senti
        # split's quality rows come back empty (the real pipeline has
        # SentiCap's ground truth)
        ga = np.random.default_rng(seed + 1)
        with open("data/captions/img_senti_labels.json") as f:
            labels = json.load(f)
        for fn, _ in labels["test"]:
            anno[fn] = [" ".join(
                synthetic.WORDS[int(j)]
                for j in ga.integers(0, len(synthetic.WORDS), 5))
                for _ in range(3)]
        with open("data/captions/coco/anno_captions.json", "w") as f:
            json.dump(anno, f)
        pp.get_lm_sents("./data/captions", ["coco"], "part")
    # 7. the paper-table harness on the last RL checkpoint
    return score_checkpoint(root, seed=seed, device=device)


def compare_tables(anchored: dict, rebuilt: dict, tol=None) -> list:
    """The human-readable violations of ``anchored`` by ``rebuilt``
    (empty: within tolerance)."""
    tol = tol or TOLERANCES
    bad = []

    def num(x):
        return isinstance(x, (int, float)) and not isinstance(x, bool)

    a_wr, r_wr = (anchored["det_sentis_wrong_rate"],
                  rebuilt["det_sentis_wrong_rate"])
    if abs(a_wr - r_wr) > tol["wrong_rate_abs"]:
        bad.append(f"det_sentis_wrong_rate {r_wr} vs anchored {a_wr}")
    for split in anchored["splits"]:
        a_s = anchored["splits"][split]
        r_s = rebuilt["splits"].get(split, {})
        for senti, row in a_s["quality"].items():
            for m, v in row.items():
                if m == "n" or not num(v):
                    continue
                rv = r_s.get("quality", {}).get(senti, {}).get(m)
                if rv is None or abs(rv - v) > tol["quality_abs"]:
                    bad.append(f"{split}/{senti}/{m}: {rv} vs anchored "
                               f"{v} (±{tol['quality_abs']})")
        for section, bound, rel in (("ppl", tol["ppl_rel"], True),
                                    ("cls", tol["cls_abs"], False)):
            a_v = a_s.get(section)
            if not a_v:
                continue
            r_v = r_s.get(section) or {}
            for k, v in a_v.items():
                if not num(v):
                    continue
                rv = r_v.get(k)
                lim = bound * abs(v) if rel else bound
                if rv is None or abs(rv - v) > lim:
                    bad.append(f"{split}/{section}/{k}: {rv} vs anchored "
                               f"{v} (±{lim:.3g})")
    return bad


def _launches():
    """The counters of the kernels the bf16 scoring reaches."""
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    return {"beam_content_attention": fa.beam_content_attention,
            "wino_input": wk.wino_input, "wino_middle": wk.wino_middle,
            "wino_output": wk.wino_output}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "ANCHOR_TORCH.json"))
    ap.add_argument("--workdir", default="",
                    help="keep the chain's tree here (default: temp)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", nargs="*", default=[],
                    help="anchor files to hold the rebuilt table against")
    ap.add_argument("--bf16", action="store_true",
                    help="also score the tree with compute_dtype bfloat16")
    ap.add_argument("--report", default="",
                    help="write times, the bf16 table and violations here")
    a = ap.parse_args(argv)

    ensure_isclm()
    root = a.workdir or tempfile.mkdtemp(prefix="isc_anchor_torch_")
    t0 = time.time()
    table = run_pipeline(root, seed=a.seed, device=a.device)
    chain_s = time.time() - t0
    anchor = {"seed": a.seed, "epochs": EPOCHS, "tolerances": TOLERANCES,
              "corpus": CORPUS, "table": table}
    with open(a.out, "w") as f:
        json.dump(anchor, f, indent=1, sort_keys=True)
    print(f"====> wrote {a.out} (chain on {a.device}: {chain_s:.1f} s; "
          f"tree: {root})")
    report = {"device": a.device, "chain_s": chain_s, "table": table,
              "violations": {}}
    tables = {"float32": table}
    if a.bf16:
        counters = _launches()
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        tables["bfloat16"] = score_checkpoint(
            root, seed=a.seed, tag="anchor_bf16",
            out="result/anchor_table_bf16.json", device=a.device,
            compute_dtype="bfloat16")
        report.update(bf16_score_s=time.time() - t0,
                      bf16_table=tables["bfloat16"],
                      bf16_launches={k: c.launches
                                     for k, c in counters.items()})
        bad = compare_tables(table, tables["bfloat16"])
        report["violations"]["bfloat16 vs float32 (the same tree)"] = bad
        print(f"====> bf16 table scored in {report['bf16_score_s']:.1f} s, "
              f"launches {report['bf16_launches']}; against the f32 table: "
              f"{len(bad)} violations" + "".join(f"\n  {b}" for b in bad))
    for path in a.compare:
        with open(path) as f:
            ref = json.load(f)
        for dtype, t in tables.items():
            bad = compare_tables(ref["table"], t, ref["tolerances"])
            report["violations"][f"{dtype} vs {path}"] = bad
            print(f"====> {dtype} table against {path}: {len(bad)} "
                  "violations" + "".join(f"\n  {b}" for b in bad))
    if a.report:
        os.makedirs(os.path.dirname(os.path.abspath(a.report)),
                    exist_ok=True)
        with open(a.report, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()

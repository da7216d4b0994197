"""The port's evaluation scorers and CLIs against the JAX package's on the
CPU: BLEU (``rewards/bleu``), METEOR* (``rewards/meteor``; also with a tiny
WordNet index and a paraphrase table the test writes, so that the synonym
and paraphrase stages run), ``cli/eval_metrics.compute_metrics``,
``cli/eval_ppl.compute_ppl`` through the repo's ``isclm`` and
``cli/eval_senti.run`` on a synthetic tree.

Tolerances: none. The scores are Python floats computed by the same host
code on the same tokens (the port's tokenizer and stemmer give nltk's, see
``test_torch_text.py``), so they are held equal; ppl comes from the same
subprocess; eval_senti's print-out is held line for line (its detector's
labels and scores go through a threshold, and on these inputs none lies
near one).
"""
import json
import os

import numpy as np
import pytest

from insenticap_model_tpu.cli import eval_metrics as jeval_metrics
from insenticap_model_tpu.cli import eval_ppl as jeval_ppl
from insenticap_model_tpu.cli import eval_senti as jeval_senti
from insenticap_model_tpu.config import Opts as JOpts
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.rewards import bleu as jbleu
from insenticap_model_tpu.rewards import meteor as jmeteor
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import eval_metrics as teval_metrics
from insenticap_model_tpu_torch.cli import eval_ppl as teval_ppl
from insenticap_model_tpu_torch.cli import eval_senti as teval_senti
from insenticap_model_tpu_torch.config import Opts as TOpts
from insenticap_model_tpu_torch.rewards import bleu as tbleu
from insenticap_model_tpu_torch.rewards import meteor as tmeteor
from torch_parity import detector_params, port_settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISCLM = os.path.join(REPO, "native", "build", "isclm")
SENTIS = ("positive", "negative", "neutral")
WORDS = ["a", "the", "dog", "dogs", "cat", "man", "men", "runs", "running",
         "sits", "sitting", "happy", "sad", "red", "big", "small", "tree",
         "park", "in", "on", "with", "jumping", "jumped", "street", "road",
         "quickly", "lovely"]


@pytest.fixture(autouse=True)
def _no_meteor_env(monkeypatch):
    for k in ("ISC_WORDNET_DIR", "ISC_METEOR_PARAPHRASE",
              "ISC_METEOR_FUNCTION_WORDS"):
        monkeypatch.delenv(k, raising=False)


def _caption(g, lo=3, hi=10):
    return [WORDS[int(i)] for i in g.integers(0, len(WORDS),
                                              int(g.integers(lo, hi)))]


def _gts_res(seed, n=40):
    g = np.random.default_rng(seed)
    gts = {f"img{i}": [tuple(_caption(g)) for _ in range(int(
        g.integers(1, 5)))] for i in range(n)}
    res = []
    for fn, refs in gts.items():
        hyp = list(refs[0]) if g.random() < 0.3 else _caption(g, 1, 12)
        res.append({"image_id": fn, "caption": [tuple(hyp)]})
    return gts, res


@pytest.mark.parametrize("seed", [0, 1])
def test_bleu_equals_jax(seed):
    gts, res = _gts_res(seed)
    for n in (1, 4):
        want = jbleu.Bleu(n).compute_score(gts, res)
        got = tbleu.Bleu(n).compute_score(gts, res)
        assert got[0] == want[0]
        assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
        assert tbleu.compute_bleu(gts, res, n) == \
            jbleu.compute_bleu(gts, res, n)


def _wordnet(d):
    """A tiny WordNet index (WNdb format, a licence line first) in which
    dog/hound/pooch, man/guy, run/sprint and happy/glad share synsets."""
    os.makedirs(d, exist_ok=True)
    rows = {"noun": [("dog", ["01", "02"]), ("hound", ["01"]),
                     ("pooch", ["02"]), ("man", ["05"]), ("guy", ["05"]),
                     ("park", ["07"])],
            "verb": [("run", ["11"]), ("sprint", ["11"]), ("runs", ["11"])],
            "adj": [("happy", ["21"]), ("glad", ["21"]), ("sad", ["22"])]}
    for pos, entries in rows.items():
        with open(os.path.join(d, f"index.{pos}"), "w") as f:
            f.write("  1 This software and database is provided as is\n")
            for w, offs in entries:
                f.write(f"{w} n {len(offs)} 1 @ {len(offs)} 0 "
                        + " ".join(f"000000{o}" for o in offs) + "\n")
    with open(os.path.join(d, "index.adv"), "w") as f:
        f.write("quickly r 1 0 1 0 00000031\n")
    return d


def _paraphrases(path):
    with open(path, "w") as f:
        f.write("# phrase pairs\n")
        f.write("big dog ||| large hound\n")
        f.write("[X] ||| in the park ||| at the park ||| 0.5\n")
        f.write("sitting\tseated\n")
        f.write("on the road\nalong the street\n")
    return path


@pytest.mark.parametrize("stages", ["exact+stem", "syn+para"])
def test_meteor_equals_jax(stages, tmp_path):
    gts, res = _gts_res(3)
    g = np.random.default_rng(9)
    extra = ["hound", "pooch", "guy", "sprint", "glad", "large", "seated",
             "at", "along"]
    for r in res[:20]:            # words the syn and para stages match
        cap = list(r["caption"][0])
        cap[int(g.integers(len(cap)))] = extra[int(g.integers(len(extra)))]
        r["caption"] = [tuple(cap)]
    kw = {}
    if stages == "syn+para":
        kw = dict(wordnet_dir=_wordnet(str(tmp_path / "wn")),
                  paraphrase_path=_paraphrases(str(tmp_path / "para.txt")))
    jm, tm = jmeteor.Meteor(**kw), tmeteor.Meteor(**kw)
    assert tm.name == jm.name == "METEOR*"
    assert tm.mode == jm.mode
    assert ("+syn+para" in tm.mode) == (stages == "syn+para")
    want = jm.compute_score(gts, res)
    got = tm.compute_score(gts, res)
    assert got == want
    assert 0 < got[0] < 1


def test_meteor_helpers_equal_jax(tmp_path):
    seqs = [_caption(np.random.default_rng(i)) for i in range(30)]
    assert tmeteor.derive_function_words(seqs, 0.05) == \
        jmeteor.derive_function_words(seqs, 0.05)
    fw = tmp_path / "fw.txt"
    fw.write_text("# words\nThe\na\n\nof\n")
    assert tmeteor.load_function_words(str(fw)) == \
        jmeteor.load_function_words(str(fw)) == {"the", "a", "of"}
    wn = _wordnet(str(tmp_path / "wn"))
    assert tmeteor.WordNetSynonyms(wn).word2synsets == \
        jmeteor.WordNetSynonyms(wn).word2synsets
    para = _paraphrases(str(tmp_path / "p.txt"))
    assert tmeteor.ParaphraseTable(para).table == \
        jmeteor.ParaphraseTable(para).table


def _write_results(d, prefix, seed):
    """Per-sentiment result files of both splits (JSON, and the word form
    _w.txt that eval_ppl reads) and the anno captions."""
    g = np.random.default_rng(seed)
    anno = {f"test_img{i}.jpg": [" ".join(_caption(g)).capitalize() + " ."
                                 for _ in range(3)] for i in range(12)}
    fns = sorted(anno)
    for dt in ("fact", "senti"):
        for k, senti in enumerate(SENTIS):
            if dt == "senti" and senti == "neutral":
                continue
            res = [{"image_id": fn, "caption": " ".join(_caption(g))}
                   for fn in fns[k::3]] + [{"image_id": "unknown.jpg",
                                            "caption": "a dog"}]
            with open(f"{prefix}_{senti}_{dt}.json", "w") as f:
                json.dump(res, f)
            with open(f"{prefix}_{senti}_{dt}_w.txt", "w") as f:
                f.write("".join(r["caption"] + "\n" for r in res))
    anno_file = os.path.join(d, "anno_captions.json")
    with open(anno_file, "w") as f:
        json.dump(anno, f)
    return anno_file


def test_compute_metrics_equals_jax(tmp_path, capsys):
    prefix = str(tmp_path / "result_0")
    anno = _write_results(str(tmp_path), prefix, 4)
    for dt in ("fact", "senti"):
        want = jeval_metrics.compute_metrics(prefix, dt, anno)
        jout = capsys.readouterr().out
        got = teval_metrics.compute_metrics(prefix, dt, anno)
        assert got == want
        assert set(got) == ({"positive", "negative", "neutral"}
                            if dt == "fact" else {"positive", "negative"})
        assert capsys.readouterr().out == jout
    teval_metrics.main([prefix, "fact", anno])
    assert "METEOR*" in capsys.readouterr().out


@pytest.fixture
def lm_root(tmp_path, monkeypatch):
    """cwd with ./data/captions/coco/part/lm/<senti>_w.sri (trained by
    isclm on generated sentences) and result files under res/."""
    if not os.path.exists(ISCLM):
        pytest.skip("native/build/isclm is not built (make -C native)")
    import subprocess
    lm = tmp_path / "data/captions/coco/part/lm"
    lm.mkdir(parents=True)
    g = np.random.default_rng(5)
    for senti in SENTIS:
        txt = lm / f"{senti}_w.txt"
        txt.write_text("".join(" ".join(_caption(g)) + "\n"
                               for _ in range(60)))
        subprocess.run([ISCLM, "train", str(txt), str(lm / f"{senti}_w.sri")],
                       check=True, capture_output=True)
    (tmp_path / "res").mkdir()
    prefix = str(tmp_path / "res" / "result_0")
    _write_results(str(tmp_path / "res"), prefix, 6)
    monkeypatch.chdir(tmp_path)
    return prefix


def test_compute_ppl_equals_jax(lm_root, capsys):
    want = jeval_ppl.compute_ppl(lm_root, "fact")
    jout = capsys.readouterr().out
    got = teval_ppl.compute_ppl(lm_root, "fact")
    assert got == want and set(got) == set(SENTIS)
    assert all(np.isfinite(v) and v > 1 for v in got.values())
    assert capsys.readouterr().out == jout
    assert os.path.samefile(teval_ppl._isclm_binary(),
                            jeval_ppl._isclm_binary())


def test_compute_ppl_raises_where_it_cannot_score(lm_root, monkeypatch):
    """A missing input raises, as does a host with neither scorer: a ppl
    is never reported as 0."""
    with pytest.raises(FileNotFoundError, match="senti_neutral|neutral_senti"):
        teval_ppl.compute_ppl(lm_root, "senti")    # no neutral senti file
    monkeypatch.setattr(teval_ppl, "_isclm_binary", lambda: None)
    with pytest.raises(RuntimeError, match="no LM scorer"):
        teval_ppl.compute_ppl(lm_root, "fact")


def test_eval_senti_equals_jax(tmp_path, monkeypatch, settings, capsys):
    """The threshold sweep's print-out, line for line: the synthetic tree's
    sentiment images (their features as the COCO att store the CLI reads)
    and their labels as the hand-labeled file; a seeded detector whose
    labels are mixed and whose scores spread from 0.7 to 1."""
    import shutil
    s = JSettings(**{**settings.to_dict(), "text_cnn_filters": (3, 4, 5)})
    synthetic.build_tree(str(tmp_path), port_settings(s), seed=0)
    coco = tmp_path / "feats" / "coco"
    coco.mkdir(parents=True)
    shutil.copy(tmp_path / "data/features/sentiment/feats_att.isc",
                coco / "coco_att.isc")
    labeled = {senti: [] for senti in SENTIS}
    for split in json.loads((tmp_path / "data/captions/img_senti_labels"
                             ".json").read_text()).values():
        for fn, senti in split:
            labeled[senti].append(fn)
    (tmp_path / "data/labeled_data").mkdir()
    (tmp_path / "data/labeled_data/at_most_one_disagree.json").write_text(
        json.dumps(labeled))
    det, _ = detector_params(s, seed=1, scale=10.0)
    jck.save(str(tmp_path / "det.ckpt"), det, None,
             {"settings": s.to_dict(),
              "sentiment_categories": list(SENTIS)})
    monkeypatch.chdir(tmp_path)
    kw = dict(rl_senti_resume="det.ckpt", feats_dir="feats")
    jeval_senti.run(JOpts(**kw, settings=s))
    want = capsys.readouterr().out.splitlines()
    evals = teval_senti.run(TOpts(**kw, settings=port_settings(s),
                                  device="cpu"))
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len([x for x in got if x.startswith("THRESHOLD:")]) == 21
    labels = np.concatenate([e[0] for e in evals.values()])
    scores = np.concatenate([e[1] for e in evals.values()])
    assert len(set(labels.tolist())) > 1 and scores.min() < 0.8

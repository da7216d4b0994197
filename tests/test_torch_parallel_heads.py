"""The port's head stages data-parallel on the CPU (gloo): the concept,
image-sentiment and sentence-classifier train steps at 2 ranks against
one process on the same global batch, and their CLIs (``train_cpt``,
``train_senti``, ``train_sent_senti_cls_rnn``) under ``--mesh_shape
[2]`` against one process whose training loaders yield the two ranks'
stripes concatenated (``torch_ranks.GlobalLoader``).

Tolerances: the steps in float64 with dropout 0.5, as
``test_torch_parallel_xe.py``'s (losses within 1e-5 relative, gradients
within 1e-6 of each leaf's largest magnitude, params within 1e-6, the
ranks' params bit for bit alike); the CLIs in float32: every number in
``metrics.jsonl`` within 1e-5 relative, the checkpoints' params within
1e-6 with their epochs and learning rates equal, the same checkpoint
epochs, and no file opened for writing by rank 1.
"""
import json
import os

import numpy as np
import pytest
import torch

from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.cli import train_cpt, train_senti
from insenticap_model_tpu_torch.cli import train_sent_senti_cls_rnn as \
    train_cls
from insenticap_model_tpu_torch.config import Opts, Settings
from insenticap_model_tpu_torch.models import concept_detector as cpt_det
from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
from insenticap_model_tpu_torch.models import sentiment_detector as sd
from insenticap_model_tpu_torch.training import checkpoint as tck
from torch_ranks import (cli_runs, global_loaders, head_steps, numpy_tree,
                         run_ranks, sequence)

LR = 4e-4
GLOBAL_BS = 8
SETTINGS = Settings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                    feat_emb_dim=16, dropout_p=0.5, rnn_hid_dim=16,
                    att_hid_dim=16, concept_mid_dim=24)
N_CONCEPTS, VOCAB, T = 8, 24, 7
STAGES = ("concept", "senti", "cls")
CLI_STAGES = {  # CLI -> (its stage directory, its Opts keywords)
    "train_cpt": (("concept", "coco"), dict(concept_bs=6, concept_epochs=2)),
    "train_senti": (("sentiment",), dict(senti_bs=4, senti_epochs=2)),
    "train_sent_senti_cls_rnn": (("sent_senti_cls", "coco", "part"),
                                 dict(senti_resume="<epoch 27>")),
}


def _step_inputs(stage):
    """(params, two global batches) of a head stage, from seeds."""
    g = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(4)
    if stage == "concept":
        params = cpt_det.init_params(gen, N_CONCEPTS, SETTINGS, device="cpu")
        batches = [{"fc": g.normal(size=(GLOBAL_BS, SETTINGS.fc_feat_dim)),
                    "cpts": (g.random((GLOBAL_BS, N_CONCEPTS)) < 0.3)
                    .astype(np.float32)} for _ in range(2)]
    elif stage == "senti":
        params = sd.init_params(gen, 3, SETTINGS, device="cpu")
        batches = [{"att": g.normal(size=(GLOBAL_BS, 14, 14,
                                          SETTINGS.att_feat_dim)),
                    "labels": g.integers(0, 3, GLOBAL_BS).astype(np.int32)}
                   for _ in range(2)]
    else:
        params = ss_cls.init_params(gen, VOCAB, 3, SETTINGS, device="cpu")
        batches = []
        for _ in range(2):
            lengths = g.integers(1, T + 1, GLOBAL_BS).astype(np.int32)
            caps = g.integers(4, VOCAB, (GLOBAL_BS, T)).astype(np.int32)
            caps[np.arange(T)[None, :] >= lengths[:, None]] = 0
            batches.append({"caps": caps, "lengths": lengths,
                            "labels": g.integers(0, 3, GLOBAL_BS)
                            .astype(np.int32)})
    return (stage, numpy_tree(params), batches, SETTINGS.to_dict(),
            torch.float64, LR)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The artefact tree and the classifier's epoch-27 checkpoint (seeded
    weights, no optimizer state) that the classifier runs resume from."""
    root = tmp_path_factory.mktemp("heads_tree")
    synthetic.build_tree(str(root), SETTINGS, seed=0)
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    cls = ss_cls.init_params(torch.Generator().manual_seed(0), len(idx2word),
                             3, SETTINGS, device="cpu")
    resume = root / "cls_epoch27.ckpt"
    tck.save(str(resume), cls, None, {
        "epoch": train_cls.EPOCHS - 3, "lr": LR,
        "settings": SETTINGS.to_dict(), "idx2word": idx2word,
        "sentiment_categories": list(synthetic.CATS),
        "dataset_name": "coco", "corpus_type": "part"})
    return root, str(resume)


def _opts_kw(root, resume, name, who):
    _, extra = CLI_STAGES[name]
    extra = {k: resume if v == "<epoch 27>" else v for k, v in extra.items()}
    return dict(settings=SETTINGS.to_dict(), num_concepts=3, seed=0,
                captions_dir=str(root / "data/captions"),
                feats_dir=str(root / "data/features"),
                img_senti_labels=str(root / "data/captions"
                                     / "img_senti_labels.json"),
                checkpoint=str(root / f"ck_{who}"),
                result_dir=str(root / f"res_{who}"), **extra)


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    """One spawn of 2 ranks: the three steps, then the three CLIs."""
    root, resume = tree
    calls = [(head_steps, _step_inputs(s)) for s in STAGES]
    calls.append((cli_runs, (str(root), [
        (name, _opts_kw(root, resume, name, "two")) for name in CLI_STAGES])))
    res = run_ranks(sequence, 2, tmp_path_factory.mktemp("head_ranks"),
                    calls)
    return {"steps": {s: [r[i] for r in res] for i, s in enumerate(STAGES)},
            "cli": [r[len(STAGES)] for r in res]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("stage", STAGES)
def test_head_step_two_ranks_equal_one_process(stage, ranks):
    one = head_steps(0, 1, *_step_inputs(stage))
    for out in ranks["steps"][stage]:
        assert out["losses"] == pytest.approx(one["losses"], rel=1e-5)
        for gs, ws in zip(out["grads"], one["grads"]):
            for g, w in zip(gs, ws):
                assert g.dtype == w.dtype == torch.float64
                assert float((g - w).abs().max()) <= \
                    1e-6 * float(w.abs().max())
        for a, b in zip(_leaves(out["params"]), _leaves(one["params"])):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    first, second = (_leaves(r["params"]) for r in ranks["steps"][stage])
    assert all(np.array_equal(a, b) for a, b in zip(first, second))


def _metrics(d):
    return [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]


def _ckpts(d):
    return {int(f.split("_")[1]): os.path.join(d, f)
            for f in os.listdir(d) if f.endswith(".ckpt")}


@pytest.mark.parametrize("name", list(CLI_STAGES))
def test_head_cli_two_ranks_equal_one_process(name, tree, ranks,
                                              monkeypatch):
    root, resume = tree
    global_loaders(monkeypatch, tcommon, 2)
    mod = {"train_cpt": train_cpt, "train_senti": train_senti,
           "train_sent_senti_cls_rnn": train_cls}[name]
    kw = _opts_kw(root, resume, name, "one")
    one = mod.train(Opts(**dict(kw, settings=SETTINGS, device="cpu")))
    sub, _ = CLI_STAGES[name]
    d_one, d_two = (os.path.join(root, f"ck_{w}", *sub)
                    for w in ("one", "two"))
    m_one, m_two = _metrics(d_one), _metrics(d_two)
    assert len(m_two) == len(m_one) == 2
    for a, b in zip(m_two, m_one):
        assert set(a) == set(b)
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-5), (k, a, b)
    c_one, c_two = _ckpts(d_one), _ckpts(d_two)
    assert sorted(c_two) == sorted(c_one) and c_one
    for e in c_one:
        pa, sa, ma = tck.load(c_two[e], device="cpu", with_opt_state=True)
        pb, sb, mb = tck.load(c_one[e], device="cpu", with_opt_state=True)
        assert (ma["epoch"], ma["lr"]) == (mb["epoch"], mb["lr"])
        assert int(sa["count"]) == int(sb["count"])
        for a, b in zip(_leaves(numpy_tree(pa)), _leaves(numpy_tree(pb))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    i = list(CLI_STAGES).index(name)
    for r in ranks["cli"]:
        for a, b in zip(_leaves(r["params"][i]),
                        _leaves(numpy_tree(one))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert ranks["cli"][1]["writes"] == []

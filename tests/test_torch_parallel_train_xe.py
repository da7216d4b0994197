"""The port's XE stage entry point data-parallel on the CPU (gloo):
``train_xe`` under ``--mesh_shape [2]`` for epoch 0, then resumed from the
epoch-0 checkpoint rank 0 wrote for epoch 1, against one process that
runs both epochs with training loaders yielding the two ranks' stripes
concatenated (``torch_ranks.GlobalLoader``), on ``synthetic.build_tree``
at the conftest widths, dropout 0.5 and scheduled sampling at 0.05 in
epoch 1.

Tolerances: every number in ``metrics.jsonl`` within 1e-5 relative; the
epoch-0 checkpoint's and the trained params within 1e-6, the two
softmax-invariant attention-score biases within lr a step; the dumps'
captions identical; the ranks' params bit for bit alike; no file opened
for writing by rank 1.
"""
import json
import os

import numpy as np
import pytest
import torch

from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.cli import train_xe
from insenticap_model_tpu_torch.config import Opts, Settings
from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
from insenticap_model_tpu_torch.training import checkpoint as tck
from torch_ranks import cli_runs, global_loaders, numpy_tree, run_ranks

LR = 4e-4
XE_BS = 6            # 3 rows a rank
SETTINGS = Settings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                    feat_emb_dim=16, dropout_p=0.5, rnn_hid_dim=16,
                    att_hid_dim=16, concept_mid_dim=24)
STEPS = synthetic.N_IMG["train"] * 3 // XE_BS
SOFTMAX_INVARIANT = (("attention", "cont", "att_alpha", "bias"),
                     ("attention", "senti", "word_alpha", "bias"))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                       prefix + (k,))]
    return [(prefix, tree)]


def _assert_params(got, want, steps):
    pg, pw = _paths(got), _paths(want)
    assert [p for p, _ in pg] == [p for p, _ in pw]
    for (path, a), (_, b) in zip(pg, pw):
        tol = LR * steps if path in SOFTMAX_INVARIANT else 1e-6
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                                   rtol=0, err_msg="/".join(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tree, the two ranks' runs (epoch 0; epoch 1 resumed) and the
    one-process run of both epochs -> (root, rank results, its params)."""
    root = tmp_path_factory.mktemp("xe_dp_tree")
    synthetic.build_tree(str(root), SETTINGS, seed=0)
    synthetic.write_det_concepts(str(root))
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    cls = ss_cls.init_params(torch.Generator().manual_seed(1), len(idx2word),
                             3, SETTINGS, device="cpu")
    for who in ("one", "two", "resumed"):
        tck.save(str(root / f"ck_{who}" / "sent_senti_cls" / "coco" / "part"
                     / "model-best.ckpt"), cls, None, {
                         "settings": SETTINGS.to_dict(),
                         "idx2word": idx2word,
                         "sentiment_categories": list(synthetic.CATS),
                         "dataset_name": "coco", "corpus_type": "part"})

    def kw(who, **extra):
        return dict(settings=SETTINGS.to_dict(), num_concepts=3,
                    max_seq_len=8, seed=0, xe_bs=XE_BS, beam_size=2,
                    scheduled_sampling_increase_every=1,
                    captions_dir=str(root / "data/captions"),
                    feats_dir=str(root / "data/features"),
                    checkpoint=str(root / f"ck_{who}"),
                    result_dir=str(root / f"res_{who}"), **extra)
    epoch0 = str(root / "ck_two" / "xe" / "coco" / "part" / "model_0_*")
    res = run_ranks(cli_runs, 2, tmp_path_factory.mktemp("xe_dp_ranks"),
                    str(root), [
                        ("train_xe", kw("two", xe_epochs=1)),
                        ("train_xe", kw("resumed", xe_epochs=2,
                                        xe_resume="glob:" + epoch0))])
    with pytest.MonkeyPatch.context() as mp:
        global_loaders(mp, tcommon, 2)
        one = train_xe.train(Opts(**dict(kw("one", xe_epochs=2),
                                         settings=SETTINGS, device="cpu")))
    return root, res, numpy_tree(one)


def _stage(root, who, kind="ck"):
    return os.path.join(root, f"{kind}_{who}", "xe", "coco", "part")


def _metrics(root, who):
    return [json.loads(x)
            for x in open(os.path.join(_stage(root, who), "metrics.jsonl"))]


def test_two_ranks_metrics_equal_one_process(runs):
    root, _, _ = runs
    one = _metrics(root, "one")
    got = _metrics(root, "two") + _metrics(root, "resumed")
    assert [m["epoch"] for m in got] == [m["epoch"] for m in one] == [0, 1]
    assert one[1]["ss_prob"] == 0.05
    for a, b in zip(got, one):
        assert set(a) == set(b)
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-5), (k, a, b)


def test_rank_zero_checkpoint_and_resume(runs):
    """One checkpoint (epoch 0), written by rank 0 alone, equal to the
    one process's; the run resumed from it ends at the one process's
    params, on both ranks alike."""
    root, res, one = runs
    files = [f for f in os.listdir(_stage(root, "two"))
             if f.endswith(".ckpt")]
    assert len(files) == 1 and files[0].startswith("model_0_")
    [mine] = [f for f in os.listdir(_stage(root, "one"))
              if f.startswith("model_0_")]
    p2, s2, m2 = tck.load(os.path.join(_stage(root, "two"), files[0]),
                          device="cpu", with_opt_state=True)
    p1, s1, m1 = tck.load(os.path.join(_stage(root, "one"), mine),
                          device="cpu", with_opt_state=True)
    assert (m2["epoch"], m2["lr"]) == (m1["epoch"], m1["lr"])
    assert int(s2["count"]) == int(s1["count"]) == STEPS
    _assert_params(numpy_tree(p2), numpy_tree(p1), STEPS)
    for r in res:
        _assert_params(r["params"][1], one, 2 * STEPS)
    for (_, a), (_, b) in zip(_paths(res[0]["params"][1]),
                              _paths(res[1]["params"][1])):
        assert np.array_equal(a, b)
    assert res[1]["writes"] == []


def test_rank_zero_dumps_the_whole_test_split(runs):
    root, _, _ = runs
    for epoch, who in ((0, "two"), (1, "resumed")):
        got = json.loads(open(os.path.join(
            _stage(root, who, "res"), f"result_{epoch}.json")).read())
        want = json.loads(open(os.path.join(
            _stage(root, "one", "res"), f"result_{epoch}.json")).read())
        assert len(got) == synthetic.N_IMG["test"]
        assert got == want

"""The port's RL stage entry point data-parallel on the CPU (gloo):
``train_rl`` under ``--mesh_shape [2]`` for epoch 0, then resumed from the
epoch-0 composite checkpoint rank 0 wrote for epoch 1, against one
process that runs both epochs with training loaders yielding the two
ranks' stripes concatenated (``torch_ranks.GlobalLoader``, each stripe's
caption draws from a generator of its own), on ``synthetic.build_tree``
at the conftest widths, dropout 0.5, the real sampler and the RL step's
scheduled sampling. The epoch cap is 2 batches a pass in every run, so
that it cuts the captioned pass (3 batches a rank) and a resume replays
the cut passes.

Tolerances: every number in ``metrics.jsonl`` within 1e-5 relative; the
captioner of each composite checkpoint and the trained params within
1e-6, the two softmax-invariant attention-score biases within lr a step;
the frozen detector and classifier equal; Adam's step count and learning
rate equal, its moments within 1e-5 of each leaf's largest magnitude
(those two biases' within 1e-6 absolute: their gradient is rounding);
every result file, the detected-sentiment files included, byte for byte;
the ranks' params bit for bit alike; no file opened for writing by
rank 1.
"""
import json
import os

import numpy as np
import pytest
import torch

from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.cli import train_rl
from insenticap_model_tpu_torch.config import Opts, Settings
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.training import checkpoint as tck
from torch_ranks import cli_runs, global_loaders, numpy_tree, run_ranks

LR = 4e-5                      # the RL stage's default cap_lr
RL_BS = 4                      # 2 rows a rank
CAP = 2                        # train_rl.MAX_BATCHES_PER_EPOCH in every run
SETTINGS = Settings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                    feat_emb_dim=16, dropout_p=0.5, rnn_hid_dim=16,
                    att_hid_dim=16, concept_mid_dim=24)
# a rank's stripe: 4 sentiment train images (2 batches) and 6 captioned
# ones (3 batches, cut to CAP)
STEPS = min(CAP, synthetic.N_SENTI_IMG["train"] // RL_BS) \
    + min(CAP, synthetic.N_IMG["train"] // RL_BS)
SOFTMAX_INVARIANT = (("attention", "cont", "att_alpha", "bias"),
                     ("attention", "senti", "word_alpha", "bias"))
# the same two biases in the JAX layout of Adam's moments
MOMENTS_INVARIANT = (("attention", "cont", "att_alpha", "b"),
                     ("attention", "senti", "word_alpha", "b"))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                       prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (i,))]
    return [(prefix, np.asarray(tree))]


def _assert_captioner(got, want, steps):
    pg, pw = _paths(got), _paths(want)
    assert [p for p, _ in pg] == [p for p, _ in pw]
    for (path, a), (_, b) in zip(pg, pw):
        tol = LR * steps if path in SOFTMAX_INVARIANT else 1e-6
        np.testing.assert_allclose(a, b, atol=tol, rtol=0,
                                   err_msg="/".join(map(str, path)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tree, the two ranks' runs (epoch 0; epoch 1 resumed) and the
    one-process run of both epochs -> (root, rank results, its params)."""
    root = tmp_path_factory.mktemp("rl_dp_tree")
    synthetic.build_tree(str(root), SETTINGS, seed=0)
    synthetic.write_rl_inputs(str(root))
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    cats = list(synthetic.CATS)
    meta = {"settings": SETTINGS.to_dict(), "idx2word": idx2word,
            "sentiment_categories": cats, "dataset_name": "coco",
            "corpus_type": "part"}
    boot = {"xe": tcap.init_params(torch.Generator().manual_seed(0),
                                   len(idx2word), 3, SETTINGS, device="cpu"),
            "sent_senti_cls": ss_cls.init_params(
                torch.Generator().manual_seed(1), len(idx2word), 3,
                SETTINGS, device="cpu")}
    for who in ("one", "two"):
        for stage, params in boot.items():
            tck.save(str(root / f"ck_{who}" / stage / "coco" / "part"
                         / "model-best.ckpt"), params, None, meta)
    # the detector's output layers scaled, so that its labels are mixed
    det = tsd.init_params(torch.Generator().manual_seed(2), 3, SETTINGS,
                          device="cpu")
    det["fcs"] = [{k: v * 30.0 for k, v in f.items()} for f in det["fcs"]]
    tck.save(str(root / "det.ckpt"), det, None,
             {"settings": SETTINGS.to_dict(), "sentiment_categories": cats})

    def kw(who, **extra):
        return dict(settings=SETTINGS.to_dict(), num_concepts=3,
                    max_seq_len=8, seed=0, rl_bs=RL_BS, beam_size=2,
                    rl_senti_times=1, rl_senti_resume=str(root / "det.ckpt"),
                    img_senti_labels=str(
                        root / "data/captions/img_senti_labels.json"),
                    captions_dir=str(root / "data/captions"),
                    feats_dir=str(root / "data/features"),
                    checkpoint=str(root / f"ck_{who}"),
                    result_dir=str(root / f"res_{who}"), **extra)
    epoch0 = str(root / "ck_two" / "rl" / "coco" / "part" / "model_0.ckpt")
    res = run_ranks(cli_runs, 2, tmp_path_factory.mktemp("rl_dp_ranks"),
                    str(root), [
                        ("train_rl", kw("two", rl_epochs=1)),
                        ("train_rl", kw("resumed", rl_epochs=2,
                                        rl_resume="glob:" + epoch0))],
                    [("train_rl", "MAX_BATCHES_PER_EPOCH", CAP)])
    with pytest.MonkeyPatch.context() as mp:
        global_loaders(mp, tcommon, 2)
        mp.setattr(train_rl, "MAX_BATCHES_PER_EPOCH", CAP)
        one = train_rl.train(Opts(**dict(kw("one", rl_epochs=2),
                                         settings=SETTINGS, device="cpu")))
    return root, res, numpy_tree(one)


def _stage(root, who, kind="ck"):
    return os.path.join(root, f"{kind}_{who}", "rl", "coco", "part")


def _metrics(root, who):
    with open(os.path.join(_stage(root, who), "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def test_two_ranks_metrics_equal_one_process(runs):
    root, _, _ = runs
    one = _metrics(root, "one")
    got = _metrics(root, "two") + _metrics(root, "resumed")
    assert [m["epoch"] for m in got] == [m["epoch"] for m in one] == [0, 1]
    for a, b in zip(got, one):
        assert set(a) == set(b)
        assert "val_fact_reward" in b and "val_xe_loss" in b
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-7), (k, a, b)


def test_rank_zero_checkpoints_and_resume(runs):
    """Rank 0's composite checkpoints (epoch 0, and epoch 1 of the run
    resumed from it) against the one process's: the captioner, the
    frozen parts and Adam's state; the resumed run's params on both
    ranks alike and at the one process's."""
    root, res, one = runs
    assert sorted(os.listdir(_stage(root, "two"))) == [
        "metrics.jsonl", "model_0.ckpt"]
    for epoch, who in ((0, "two"), (1, "resumed")):
        p2, s2, m2 = tck.load(os.path.join(_stage(root, who),
                                           f"model_{epoch}.ckpt"),
                              device="cpu", with_opt_state=True)
        p1, s1, m1 = tck.load(os.path.join(_stage(root, "one"),
                                           f"model_{epoch}.ckpt"),
                              device="cpu", with_opt_state=True)
        assert m2 == m1
        steps = (epoch + 1) * STEPS
        assert int(s2["count"]) == int(s1["count"]) == steps
        assert float(s2["hyperparams"]["learning_rate"]) == \
            float(s1["hyperparams"]["learning_rate"])
        _assert_captioner(numpy_tree(p2["captioner"]),
                          numpy_tree(p1["captioner"]), steps)
        for part in ("senti_detector", "sent_senti_cls"):
            for (_, a), (_, b) in zip(_paths(numpy_tree(p2[part])),
                                      _paths(numpy_tree(p1[part]))):
                assert np.array_equal(a, b), part
        adam2, adam1 = s2["inner_state"][1], s1["inner_state"][1]
        for moment in ("mu", "nu"):
            ma, mb = (_paths(numpy_tree(a[moment])) for a in (adam2, adam1))
            assert [p for p, _ in ma] == [p for p, _ in mb]
            for (path, a), (_, b) in zip(ma, mb):
                tol = 1e-6 if path in MOMENTS_INVARIANT else \
                    1e-5 * float(np.abs(b).max())
                np.testing.assert_allclose(a, b, atol=tol, rtol=0,
                                           err_msg=f"{moment} {path}")
    for r in res:
        _assert_captioner(r["params"][1], one, 2 * STEPS)
    for (_, a), (_, b) in zip(_paths(res[0]["params"][1]),
                              _paths(res[1]["params"][1])):
        assert np.array_equal(a, b)
    assert res[1]["writes"] == []


def test_rank_zero_dumps_equal_one_process(runs):
    """Every result file of both epochs (the per-sentiment captions in
    their three forms and each split's detected sentiments) byte for byte
    the one process's."""
    root, _, _ = runs
    one = sorted(os.listdir(_stage(root, "one", "res")))
    got = {n: who for who in ("two", "resumed")
           for n in os.listdir(_stage(root, who, "res"))}
    assert sorted(got) == one
    assert any(n.startswith("result_0_sentis_") and n.endswith("_fact.json")
               for n in one)
    assert any(n.startswith("result_1_sentis_") and n.endswith("_senti.json")
               for n in one)
    for name, who in got.items():
        with open(os.path.join(_stage(root, who, "res"), name), "rb") as f:
            a = f.read()
        with open(os.path.join(_stage(root, "one", "res"), name), "rb") as f:
            assert a == f.read(), name
    n_fact = sum(len(json.loads(open(os.path.join(
        _stage(root, "one", "res"), n)).read())) for n in one
        if n.startswith("result_0_") and n.endswith("_fact.json")
        and "sentis" not in n)
    assert n_fact == synthetic.N_IMG["test"]

"""The port's XE stage entry point against the JAX package's on one
synthetic artefact tree (the port's ``synthetic.build_tree``; the JAX CLI
takes its ``.isc`` stores), one epoch at the conftest widths, dropout 0,
on the CPU; and the port's resume against an uninterrupted run.

The port's captioner starts from the JAX package's initial weights (its
``init_params`` substituted), both runs read the same classifier
checkpoint. Tolerances: every loss in ``metrics.jsonl`` within 1e-5
relative; the dumped captions and ids identical; the checkpoint's params
within 1e-6 absolute, the two softmax-invariant attention-score biases
within lr * steps (``torch_parity.SOFTMAX_INVARIANT``), and its step
count and learning rate equal.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu.cli import train_xe as jtrain_xe
from insenticap_model_tpu.config import Opts as JOpts
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import train_xe as ttrain_xe
from insenticap_model_tpu_torch.config import Opts as TOpts
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.training import checkpoint as tck
from torch_parity import SOFTMAX_INVARIANT, jax_numpy, port_settings, to_port

LR = 4e-4
XE_BS = 6
STEPS = synthetic.N_IMG["train"] * 3 // XE_BS


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The artefact tree, the classifier checkpoint under each run's
    checkpoint root, and the settings (conftest widths, dropout 0; the
    resume runs take dropout 0.5)."""
    from insenticap_model_tpu.config import Settings
    settings = Settings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                        feat_emb_dim=16, dropout_p=0.0, rnn_hid_dim=16,
                        att_hid_dim=16, concept_mid_dim=24)
    root = tmp_path_factory.mktemp("xe_tree")
    synthetic.build_tree(str(root), port_settings(settings), seed=0)
    synthetic.write_det_concepts(str(root))
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    cls = jss.init_params(jax.random.PRNGKey(1), len(idx2word), 3,
                          settings)
    meta = {"idx2word": idx2word,
            "sentiment_categories": ["positive", "negative", "neutral"],
            "dataset_name": "coco", "corpus_type": "part"}
    for who, p in (("jax", 0.0), ("port", 0.0), ("resumed", 0.5)):
        d = root / f"ck_{who}" / "sent_senti_cls" / "coco" / "part"
        d.mkdir(parents=True)
        s = dataclasses.replace(settings, dropout_p=p)
        jck.save(str(d / "model-best.ckpt"), cls, None,
                 dict(meta, settings=s.to_dict()))
    return root, settings, len(idx2word)


def _kw(root, settings, who, **extra):
    return dict(settings=settings, num_concepts=3, max_seq_len=8, seed=0,
                xe_epochs=1, xe_bs=XE_BS, beam_size=2, mesh_shape=(1,),
                captions_dir=str(root / "data/captions"),
                feats_dir=str(root / "data/features"),
                checkpoint=str(root / f"ck_{who}"),
                result_dir=str(root / f"res_{who}"), **extra)


def _jax_init(vocab_size, settings):
    return jcap.init_params(jax.random.PRNGKey(0), vocab_size, 3, settings)


def _same_start(monkeypatch, vocab_size, settings):
    """The port's captioner starts from the JAX CLI's initial weights."""
    start = to_port(_jax_init(vocab_size, settings))
    monkeypatch.setattr(
        tcap, "init_params",
        lambda gen, v, n, s, device="cuda", dtype=torch.float32:
        tnn.tree_map(lambda x: x.clone().to(device), start))


def _stage_files(root, who):
    ck = root / f"ck_{who}" / "xe" / "coco" / "part"
    res = root / f"res_{who}" / "xe" / "coco" / "part"
    return ck, res


def test_train_xe_matches_jax(tree, monkeypatch):
    root, settings, vocab_size = tree
    jtrain_xe.train(JOpts(**_kw(root, settings, "jax")))
    _same_start(monkeypatch, vocab_size, settings)
    ttrain_xe.train(TOpts(**_kw(root, port_settings(settings), "port"),
                          device="cpu"))

    jck_dir, jres = _stage_files(root, "jax")
    tck_dir, tres = _stage_files(root, "port")
    jm = [json.loads(x) for x in open(jck_dir / "metrics.jsonl")]
    tm = [json.loads(x) for x in open(tck_dir / "metrics.jsonl")]
    assert len(jm) == len(tm) == 1
    assert set(jm[0]) == set(tm[0])
    for k, v in jm[0].items():
        assert tm[0][k] == pytest.approx(v, rel=1e-5), k
    for name in ("result_0.json", "result_0.txt", "result_0_ids.txt"):
        assert (tres / name).read_bytes() == (jres / name).read_bytes(), \
            name
    assert len(json.loads((tres / "result_0.json").read_text())) == \
        synthetic.N_IMG["test"]

    [jfile] = [f for f in os.listdir(jck_dir) if f.endswith(".ckpt")]
    [tfile] = [f for f in os.listdir(tck_dir) if f.endswith(".ckpt")]
    tp, tstate, tmeta = tck.load(str(tck_dir / tfile), device="cpu",
                                 with_opt_state=True)
    jp, jstate, jmeta = tck.load(str(jck_dir / jfile), device="cpu",
                                 with_opt_state=True)
    assert set(tmeta) == set(jmeta)
    assert tmeta["epoch"] == jmeta["epoch"] == 0
    assert int(tstate["count"]) == int(jstate["count"]) == STEPS
    assert float(tstate["hyperparams"]["learning_rate"]) == \
        float(jstate["hyperparams"]["learning_rate"])
    for (path, a), (_, b) in zip(jax_numpy(tp), jax_numpy(jp)):
        tol = LR * STEPS if path in SOFTMAX_INVARIANT else 1e-6
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=path)


def test_resume_continues_the_uninterrupted_run(tree):
    """Two epochs in one run (default dropout and scheduled sampling from
    epoch 1) against epoch 0's checkpoint resumed for epoch 1: the same
    batches and draws, so the same params within rounding (1e-6)."""
    root, settings, _ = tree
    ps = dataclasses.replace(port_settings(settings), dropout_p=0.5)
    kw = dict(xe_epochs=2, scheduled_sampling_increase_every=1,
              device="cpu")
    full = ttrain_xe.train(TOpts(**dict(_kw(root, ps, "resumed"), **kw)))
    ck_dir, res = _stage_files(root, "resumed")
    [epoch0] = [f for f in os.listdir(ck_dir) if f.endswith(".ckpt")]
    m = [json.loads(x) for x in open(ck_dir / "metrics.jsonl")]
    assert [r["ss_prob"] for r in m] == [0.0, 0.05]
    shutil.move(str(res), str(res) + "_full")
    resumed = ttrain_xe.train(TOpts(**dict(
        _kw(root, ps, "resumed"), **kw,
        xe_resume=str(ck_dir / epoch0))))
    m2 = [json.loads(x) for x in open(ck_dir / "metrics.jsonl")]
    assert len(m2) == 3 and m2[2]["epoch"] == 1
    for k, v in m[1].items():
        assert m2[2][k] == pytest.approx(v, rel=1e-5), k
    for a, b in zip(tnn.tree_leaves(resumed), tnn.tree_leaves(full)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0)
    assert sorted(os.listdir(res)) == ["result_1.json", "result_1.txt",
                                       "result_1_ids.txt"]

"""The port's RL stage entry point (``cli/train_rl.py``) and its cls%
evaluator (``cli/eval_cls_rnn.py``) against the JAX package's on one
synthetic artefact tree (the port's ``synthetic.build_tree`` and
``write_rl_inputs``; the JAX CLIs take its ``.isc`` stores), one epoch at
the conftest widths, dropout 0, on the CPU.

Both runs bootstrap from the same files the JAX package's writer made:
the XE captioner, the sentence classifier and an image sentiment detector
(its output layers scaled so that its labels are mixed). The categorical
draws of both packages are forced to argmax(logprobs + G), G one fixed
Gumbel array from numpy, and the RL step's scheduled-sampling
probabilities are 0 on both sides (``test_torch_rl_steps.py`` says why).
The val split is one whole batch: the JAX CLI leaves ``valid`` out of a
placed batch, so its masked sums would count a padded batch's padding
rows (the port's do not).

Tolerances: every result file byte for byte; every number in
``metrics.jsonl`` within 1e-5 relative; the composite checkpoint's
captioner within 1e-6 absolute (the two softmax-invariant attention-score
biases within lr * steps), its detector and classifier and Adam's step
count and learning rate equal. A resume of the port from the JAX
package's checkpoint holds to the same tolerances against its resume from
its own (the JAX CLI restarts its loaders' streams and Adam's state on a
resume, the port replays them, so each is held against itself); the JAX
CLI resumed from the port's checkpoint reads its parts within those
tolerances of its own and runs its epoch.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.cli import eval_cls_rnn as jeval_cls
from insenticap_model_tpu.cli import train_rl as jtrain_rl
from insenticap_model_tpu.config import Opts as JOpts
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu.training import steps as jsteps
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import eval_cls_rnn as teval_cls
from insenticap_model_tpu_torch.cli import train_rl as ttrain_rl
from insenticap_model_tpu_torch.config import Opts as TOpts
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.training import checkpoint as tck
from insenticap_model_tpu_torch.training import steps as tsteps
from torch_parity import (SOFTMAX_INVARIANT, detector_params, jax_numpy,
                          port_settings)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 4e-5                      # the RL stage's default cap_lr
RL_BS = 6
# one senti batch (8 images, drop_last) and two fact batches a pass
STEPS = synthetic.N_SENTI_IMG["train"] // RL_BS \
    + synthetic.N_IMG["train"] // RL_BS
CATS = list(synthetic.CATS)
VOCAB = 4 + len(synthetic.WORDS)
GUMBEL = np.random.default_rng(123).gumbel(size=(128, VOCAB)).astype(
    np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The artefact tree, each run's checkpoint root with the XE captioner
    and the sentence classifier, the detector checkpoint and the settings
    (conftest widths, dropout 0)."""
    settings = JSettings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                         feat_emb_dim=16, dropout_p=0.0, rnn_hid_dim=16,
                         att_hid_dim=16, concept_mid_dim=24)
    root = tmp_path_factory.mktemp("rl_tree")
    synthetic.build_tree(str(root), port_settings(settings), seed=0)
    synthetic.write_rl_inputs(str(root))
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    assert len(idx2word) == VOCAB
    meta = {"idx2word": idx2word, "sentiment_categories": CATS,
            "dataset_name": "coco", "corpus_type": "part",
            "settings": settings.to_dict()}
    models = {"sent_senti_cls": jss.init_params(jax.random.PRNGKey(1),
                                                VOCAB, 3, settings),
              "xe": jcap.init_params(jax.random.PRNGKey(0), VOCAB, 3,
                                     settings)}
    for who in ("jax", "port"):
        for stage, params in models.items():
            d = root / f"ck_{who}" / stage / "coco" / "part"
            d.mkdir(parents=True)
            jck.save(str(d / "model-best.ckpt"), params, None, meta)
    det, _ = detector_params(settings, scale=30.0)
    jck.save(str(root / "det.ckpt"), det, None,
             {"settings": settings.to_dict(), "sentiment_categories": CATS})
    return root, settings


def _force(monkeypatch):
    """Both packages' categorical draws forced to argmax(logprobs + G); the
    RL step's scheduled-sampling probabilities 0 on both sides."""
    g_j, g_t = jnp.asarray(GUMBEL), torch.from_numpy(GUMBEL)
    monkeypatch.setattr(
        jax.random, "categorical", lambda key, logits, axis=-1, **kw:
        jnp.argmax(logits + g_j[:logits.shape[0]], axis=axis))
    monkeypatch.setattr(
        tcap, "_categorical", lambda gen, logprobs:
        (logprobs.float() + g_t[:logprobs.shape[0]]).argmax(dim=-1))
    for m in (jsteps, tsteps):
        monkeypatch.setattr(m, "RL_XE_SS_PROB", 0.0)
        monkeypatch.setattr(m, "RL_SEQ_SS_PROB", 0.0)


@pytest.fixture
def forced(monkeypatch):
    _force(monkeypatch)


def _kw(root, settings, who, **extra):
    return dict(dict(
        settings=settings, num_concepts=3, max_seq_len=8, seed=0,
        rl_epochs=1, rl_bs=RL_BS, beam_size=2, rl_senti_times=1,
        rl_senti_resume=str(root / "det.ckpt"),
        img_senti_labels=str(root / "data/captions/img_senti_labels.json"),
        captions_dir=str(root / "data/captions"),
        feats_dir=str(root / "data/features"),
        checkpoint=str(root / f"ck_{who}"),
        result_dir=str(root / f"res_{who}")), **extra)


def _jopts(root, settings, who, **extra):
    return JOpts(**_kw(root, settings, who, **extra), mesh_shape=(1,))


def _topts(root, settings, who, **extra):
    return TOpts(**_kw(root, port_settings(settings), who, **extra),
                 device="cpu")


def _stage(root, who):
    return (root / f"ck_{who}" / "rl" / "coco" / "part",
            root / f"res_{who}" / "rl" / "coco" / "part")


def _metrics(ck_dir):
    with open(ck_dir / "metrics.jsonl") as f:
        return [json.loads(x) for x in f]


def _assert_metrics_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


def _assert_composites_close(path_a, path_b, steps):
    """Two composite checkpoints (either package's) within the step
    tolerances: the captioner within 1e-6 (the softmax-invariant biases
    within lr * steps), the frozen parts and Adam's count and lr equal."""
    pa, sa, ma = tck.load(str(path_a), device="cpu", with_opt_state=True)
    pb, sb, mb = tck.load(str(path_b), device="cpu", with_opt_state=True)
    assert set(ma) == set(mb) and ma["epoch"] == mb["epoch"]
    assert int(sa["count"]) == int(sb["count"])
    assert float(sa["hyperparams"]["learning_rate"]) == \
        float(sb["hyperparams"]["learning_rate"])
    for part in ("captioner", "senti_detector", "sent_senti_cls"):
        got, want = jax_numpy(pa[part]), jax_numpy(pb[part])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            tol = 0.0 if part != "captioner" else (
                LR * steps if path in SOFTMAX_INVARIANT else 1e-6)
            np.testing.assert_allclose(a, b, atol=tol, rtol=0,
                                       err_msg=f"{part}{path}")


@pytest.fixture(scope="module")
def runs(tree):
    """Both CLIs' epoch 0 on the tree, the draws forced (module scope: one
    JAX run serves every test here)."""
    root, settings = tree
    mp = pytest.MonkeyPatch()
    try:
        _force(mp)
        jtrain_rl.train(_jopts(root, settings, "jax"))
        ttrain_rl.train(_topts(root, settings, "port"))
    finally:
        mp.undo()
    return root, settings


def test_train_rl_matches_jax(runs):
    root, _ = runs
    jck_dir, jres = _stage(root, "jax")
    tck_dir, tres = _stage(root, "port")
    _assert_metrics_close(_metrics(tck_dir), _metrics(jck_dir))
    names = sorted(os.listdir(jres))
    assert sorted(os.listdir(tres)) == names
    # both test splits dumped, with the per-sentiment id and word forms
    assert any(n.endswith("_fact.json") and "sentis" not in n
               for n in names)
    assert any(n.startswith("result_0_sentis_") and n.endswith("_senti.json")
               for n in names)
    for name in names:
        assert (tres / name).read_bytes() == (jres / name).read_bytes(), \
            name
    n_fact = sum(len(json.loads((jres / n).read_text())) for n in names
                 if n.endswith("_fact.json") and "sentis" not in n)
    assert n_fact == synthetic.N_IMG["test"]
    assert sorted(os.listdir(tck_dir)) == ["metrics.jsonl", "model_0.ckpt"]
    _assert_composites_close(tck_dir / "model_0.ckpt",
                             jck_dir / "model_0.ckpt", STEPS)
    _, state, meta = tck.load(str(tck_dir / "model_0.ckpt"), device="cpu",
                              with_opt_state=True)
    assert int(state["count"]) == STEPS and meta["max_seq_len"] == 8
    m = _metrics(tck_dir)[0]
    assert m["val_fact_reward"] != 0.0


def test_each_package_resumes_from_the_others_checkpoint(runs, forced):
    """The port resumed for epoch 1 from the JAX package's epoch-0
    composite against the port resumed from its own; the JAX CLI resumed
    from the port's composite reads each part within the tolerances of
    its own file and runs its epoch."""
    root, settings = runs
    jck_dir, _ = _stage(root, "jax")
    tck_dir, _ = _stage(root, "port")
    for who, src in (("port_own", tck_dir), ("port_from_jax", jck_dir)):
        shutil.copytree(root / "ck_port", root / f"ck_{who}")
        ttrain_rl.train(_topts(root, settings, who, rl_epochs=2,
                               rl_resume=str(src / "model_0.ckpt")))
    own, other = _stage(root, "port_own")[0], _stage(root, "port_from_jax")[0]
    m_own, m_other = _metrics(own), _metrics(other)
    assert [m["epoch"] for m in m_own] == [0, 1]
    _assert_metrics_close(m_other, m_own)
    _assert_composites_close(other / "model_1.ckpt", own / "model_1.ckpt",
                             2 * STEPS)

    template = {"captioner": jcap.init_params(jax.random.PRNGKey(0), VOCAB,
                                              3, settings),
                "senti_detector": detector_params(settings)[0],
                "sent_senti_cls": jss.init_params(jax.random.PRNGKey(1),
                                                  VOCAB, 3, settings)}
    from insenticap_model_tpu.training import optim as jopt
    tx = jopt.make_optimizer(LR)
    jp_port, js_port, _ = jck.load(str(tck_dir / "model_0.ckpt"), template,
                                   tx.init(template["captioner"]))
    jp_own, js_own, _ = jck.load(str(jck_dir / "model_0.ckpt"), template,
                                 tx.init(template["captioner"]))
    assert int(js_port.count) == int(js_own.count) == STEPS
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp_port)[0],
            jax.tree_util.tree_flatten_with_path(jp_own)[0]):
        key = jax.tree_util.keystr(path)
        tol = LR * STEPS if any(key.endswith(s) for s in SOFTMAX_INVARIANT) \
            else 1e-6
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                                   rtol=0, err_msg=key)
    shutil.copytree(root / "ck_jax", root / "ck_jax_from_port")
    jtrain_rl.train(_jopts(root, settings, "jax_from_port", rl_epochs=2,
                           rl_resume=str(tck_dir / "model_0.ckpt")))
    m = _metrics(_stage(root, "jax_from_port")[0])
    assert [r["epoch"] for r in m] == [0, 1]
    assert all(np.isfinite(v) for v in m[1].values())


def test_eval_cls_rnn_matches_jax(runs, capsys):
    """cls% of the id-form result files: the dump's captions given to the
    three sentiments in turn (the dump need not detect every sentiment),
    through both packages' evaluators."""
    root, _ = runs
    _, res = _stage(root, "jax")
    lines = [x for n in sorted(os.listdir(res))
             if n.endswith(".txt") and not n.endswith("_w.txt")
             for x in (res / n).read_text().splitlines()]
    assert len(lines) >= 9
    prefix = str(root / "eval" / "result_0")
    os.makedirs(root / "eval")
    for i, senti in enumerate(CATS):
        with open(f"{prefix}_{senti}_fact.txt", "w") as f:
            f.write("".join(x + "\n" for x in lines[i::3]))
    ck = str(root / "ck_jax")
    want = jeval_cls.compute_cls(prefix, "fact", ck)
    got = teval_cls.compute_cls(prefix, "fact", ck, device="cpu")
    assert got == want
    assert set(got) == {"all", *CATS}
    out = capsys.readouterr().out
    assert "all acc_rate:" in out


@pytest.mark.parametrize("name,args", [
    ("train_rl", []), ("eval_cls_rnn", ["result_0", "fact"])])
def test_entry_point_runs_as_a_module_and_defaults_to_the_card(name, args,
                                                               tmp_path):
    """``python -m`` reaches each CLI's ``main``; with no ``--device`` it
    asks for the card and stops where CUDA is absent (this host); with
    ``--device cpu`` it goes on (and stops at what it then lacks: the
    trainer, data-parallel under ``--mesh_shape [2]``, a torchrun launch)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    mod = f"insenticap_model_tpu_torch.cli.{name}"
    r = subprocess.run([sys.executable, "-m", mod, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-2000:]
    extra = ["--mesh_shape", "[2]"] if name == "train_rl" else \
        ["--checkpoint", str(tmp_path)]
    r = subprocess.run([sys.executable, "-m", mod, *args, "--device", "cpu",
                        *extra], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    want = "WORLD_SIZE is unset" if name == "train_rl" else \
        "no checkpoint under"
    assert want in r.stderr, r.stderr[-2000:]


def test_resume_continues_the_uninterrupted_run(tree):
    """The port's own draws and dropout 0.5 (checkpoints written for those
    settings): two epochs in one run against epoch 0's composite resumed
    for epoch 1. The resume replays the loaders' shuffles, the fact
    loaders' caption draws and the seq2seq batches, and restores Adam's
    state, so it meets the uninterrupted run's batches and draws: the
    same metrics (1e-5) and params within rounding (1e-6)."""
    import dataclasses
    root, settings = tree
    s05 = dataclasses.replace(settings, dropout_p=0.5)
    meta = {"idx2word": json.loads(
        (root / "data/captions/coco/part/idx2word.json").read_text()),
        "sentiment_categories": CATS, "dataset_name": "coco",
        "corpus_type": "part", "settings": s05.to_dict()}
    for stage, params in (
            ("sent_senti_cls", jss.init_params(jax.random.PRNGKey(1),
                                               VOCAB, 3, s05)),
            ("xe", jcap.init_params(jax.random.PRNGKey(0), VOCAB, 3, s05))):
        d = root / "ck_full" / stage / "coco" / "part"
        d.mkdir(parents=True)
        jck.save(str(d / "model-best.ckpt"), params, None, meta)
    jck.save(str(root / "det05.ckpt"), detector_params(s05, scale=30.0)[0],
             None, {"settings": s05.to_dict(), "sentiment_categories": CATS})
    kw = dict(rl_epochs=2, rl_senti_resume=str(root / "det05.ckpt"))
    full = ttrain_rl.train(_topts(root, s05, "full", **kw))
    ck_dir, res = _stage(root, "full")
    shutil.copytree(root / "ck_full", root / "ck_resumed")
    (root / "ck_resumed/rl/coco/part/metrics.jsonl").unlink()
    resumed = ttrain_rl.train(_topts(
        root, s05, "resumed", **kw,
        rl_resume=str(ck_dir / "model_0.ckpt")))
    m_full = _metrics(ck_dir)
    m_res = _metrics(_stage(root, "resumed")[0])
    assert [m["epoch"] for m in m_res] == [1]
    _assert_metrics_close(m_res, m_full[1:])
    for a, b in zip(jax_numpy(resumed), jax_numpy(full)):
        np.testing.assert_allclose(a[1], b[1], atol=1e-6, rtol=0,
                                   err_msg=a[0])
    res_resumed = _stage(root, "resumed")[1]
    for name in os.listdir(res_resumed):
        assert (res_resumed / name).read_bytes() == \
            (res / name).read_bytes(), name

"""The port's head-stage entry points (train_cpt, detect_concepts, test_cpt,
train_senti, train_sent_senti_cls_rnn) against the JAX package's on one
synthetic artefact tree (the port's ``synthetic.build_tree``; the JAX CLIs
take its ``.isc`` stores), at the conftest widths, dropout 0, on the CPU.

Each port trainer starts from the JAX CLI's initial weights (its
``init_params`` substituted). The val and test splits are whole batches
where a loss is read from them: the JAX CLIs leave ``valid`` out of a
placed batch, so their masked sums would count a padded batch's padding
rows (the port's do not). Tolerances: every number in ``metrics.jsonl``
within 1e-5 relative; checkpoint params within 1e-6 absolute, their epoch
and learning rate equal; ``img_det_concepts.json`` byte for byte and
``test_cpt``'s printed concepts identical; ``build_datasets`` identical
item for item. A resume from the other package's checkpoint holds to the
same tolerances against a resume from the package's own (the JAX CLI
restarts its loader's stream on a resume, the port replays the earlier
epochs' shuffles, so each is held against itself).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu.cli import detect_concepts as jdetect
from insenticap_model_tpu.cli import test_cpt as jtest_cpt
from insenticap_model_tpu.cli import train_cpt as jtrain_cpt
from insenticap_model_tpu.cli import train_sent_senti_cls_rnn as jtrain_cls
from insenticap_model_tpu.cli import train_senti as jtrain_senti
from insenticap_model_tpu.config import Opts as JOpts
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.vocab import Vocab as JVocab
from insenticap_model_tpu_torch import nn as tnn
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import detect_concepts as tdetect
from insenticap_model_tpu_torch.cli import test_cpt as ttest_cpt
from insenticap_model_tpu_torch.cli import train_cpt as ttrain_cpt
from insenticap_model_tpu_torch.cli import train_sent_senti_cls_rnn as \
    ttrain_cls
from insenticap_model_tpu_torch.cli import train_senti as ttrain_senti
from insenticap_model_tpu_torch.config import Opts as TOpts
from insenticap_model_tpu_torch.models import concept_detector as tcpt
from insenticap_model_tpu_torch.models import sent_senti_cls as tss
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.models import sentiment_detector_full as \
    tsdf
from insenticap_model_tpu_torch.training import checkpoint as tck
from insenticap_model_tpu_torch.training import optim as topt
from insenticap_model_tpu_torch.vocab import Vocab as TVocab
from torch_parity import jax_flat, jax_numpy, port_settings, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONCEPT_BS = 6      # coco 12 / 6 / 6 images: whole batches
SENTI_BS = 4        # sentiment 8 / 4 / 6 images: the test split padded
N_SENTI_IMG = {"train": 8, "val": 4, "test": 6}
SENTI_EPOCHS = 7    # saves at epochs 0 and 6 (every epoch after 5)
CLIS = ("train_cpt", "detect_concepts", "test_cpt", "train_senti",
        "train_sent_senti_cls_rnn")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(root, JAX settings with dropout 0)."""
    settings = JSettings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                         feat_emb_dim=16, dropout_p=0.0, rnn_hid_dim=16,
                         att_hid_dim=16, concept_mid_dim=24)
    root = tmp_path_factory.mktemp("head_tree")
    synthetic.build_tree(str(root), port_settings(settings), seed=0,
                         n_senti_img=N_SENTI_IMG)
    return root, settings


def _kw(root, settings, who, **extra):
    return dict(settings=settings, num_concepts=3, seed=0,
                mesh_shape=(1,), concept_bs=CONCEPT_BS, senti_bs=SENTI_BS,
                captions_dir=str(root / "data/captions"),
                feats_dir=str(root / "data/features"),
                img_senti_labels=str(root / "data/captions"
                                     / "img_senti_labels.json"),
                checkpoint=str(root / f"ck_{who}"),
                result_dir=str(root / f"res_{who}"), **extra)


def _jopts(root, settings, who, **extra):
    return JOpts(**_kw(root, settings, who, **extra))


def _topts(root, settings, who, **extra):
    return TOpts(**_kw(root, port_settings(settings), who, **extra),
                 device="cpu")


def _same_start(monkeypatch, modules, jax_params):
    """The port's ``init_params`` of ``modules`` give the JAX CLI's
    initial weights."""
    start = to_port(jax_params)

    def init(*args, device="cuda", dtype=torch.float32):
        return tnn.tree_map(lambda x: x.clone().to(device), start)
    for m in modules:
        monkeypatch.setattr(m, "init_params", init)


def _metrics(d):
    return [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]


def _ckpts(d):
    """{epoch: path} of a stage directory's checkpoints."""
    out = {}
    for f in os.listdir(d):
        if f.endswith(".ckpt"):
            out[int(f.split("_")[1])] = os.path.join(d, f)
    return out


def _assert_metrics(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            assert g[k] == pytest.approx(v, rel=1e-5), (k, g, w)


def _assert_ckpt(path_a, path_b, atol=1e-6):
    """Two checkpoints (read by the port's reader): params within
    ``atol``, epoch, step count and learning rate equal."""
    pa, sa, ma = tck.load(path_a, device="cpu", with_opt_state=True)
    pb, sb, mb = tck.load(path_b, device="cpu", with_opt_state=True)
    assert set(ma) == set(mb)
    assert ma["epoch"] == mb["epoch"] and ma["lr"] == mb["lr"]
    assert int(sa["count"]) == int(sb["count"])
    assert float(sa["hyperparams"]["learning_rate"]) == \
        float(sb["hyperparams"]["learning_rate"]) == pytest.approx(ma["lr"])
    got, want = jax_numpy(pa), jax_numpy(pb)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=path)


# ---------------------------------------------------------------------------
# the concept stage: train_cpt, detect_concepts, test_cpt
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def concept_runs(tree):
    """Two epochs of both packages' train_cpt from the same weights ->
    {who: stage directory}."""
    root, settings = tree
    n = len(json.loads((root / "data/captions/coco/idx2concept.json")
                       .read_text()))
    jtrain_cpt.train(_jopts(root, settings, "jax", concept_epochs=2))
    with pytest.MonkeyPatch.context() as mp:
        _same_start(mp, [tcpt], jcpt.init_params(jax.random.PRNGKey(0), n,
                                                 settings))
        ttrain_cpt.train(_topts(root, settings, "port", concept_epochs=2))
    return {who: str(root / f"ck_{who}" / "concept" / "coco")
            for who in ("jax", "port")}


def test_train_cpt_matches_jax(concept_runs):
    _assert_metrics(_metrics(concept_runs["port"]),
                    _metrics(concept_runs["jax"]))
    jfiles, tfiles = (_ckpts(concept_runs[w]) for w in ("jax", "port"))
    assert sorted(jfiles) == sorted(tfiles) == [0, 1]
    for e in (0, 1):
        _assert_ckpt(tfiles[e], jfiles[e])


def test_detect_concepts_matches_jax(tree, concept_runs):
    """Both packages on each package's checkpoint: the same file, byte for
    byte, with an entry for every image of both stores."""
    root, settings = tree
    out = root / "data/captions/coco/img_det_concepts.json"
    for who in ("jax", "port"):
        ck = _ckpts(concept_runs[who])[1]
        jdetect.run(_jopts(root, settings, "x", eval_model=ck))
        want = out.read_bytes()
        got = tdetect.run(_topts(root, settings, "x", eval_model=ck))
        assert out.read_bytes() == want
        n_img = sum(synthetic.N_IMG.values()) + sum(N_SENTI_IMG.values())
        assert len(got) == n_img
        assert all(len(v) == 3 for v in got.values())


def test_test_cpt_matches_jax(tree, concept_runs, capsys):
    root, settings = tree
    ck = _ckpts(concept_runs["port"])[1]
    lines = {}
    for who, run, opts in (("jax", jtest_cpt.run, _jopts),
                           ("port", ttest_cpt.run, _topts)):
        capsys.readouterr()
        run(opts(root, settings, "x", test_model=ck))
        lines[who] = [x for x in capsys.readouterr().out.splitlines()
                      if x.startswith(("test_img", "concepts", "ground",
                                       "wrong"))]
    assert len(lines["port"]) == 5
    assert lines["port"] == lines["jax"]


# ---------------------------------------------------------------------------
# the image sentiment detector: train_senti
# ---------------------------------------------------------------------------

def _senti_settings(settings, head):
    return dataclasses.replace(
        settings, num_kernels_per_sentiment=2 if head == "full" else 0)


@pytest.mark.parametrize("head", ["standard", "full"])
def test_train_senti_matches_jax(tree, head, monkeypatch):
    """SENTI_EPOCHS epochs from the same weights: the metrics, and the
    checkpoints, written at epoch 0 and after epoch 5 only."""
    root, settings = tree
    s = _senti_settings(settings, head)
    jtrain_senti.train(_jopts(root, s, f"jax_{head}",
                              senti_epochs=SENTI_EPOCHS))
    _same_start(monkeypatch, [tsd, tsdf], jsd.module_for(s).init_params(
        jax.random.PRNGKey(0), 3, s))
    ttrain_senti.train(_topts(root, s, f"port_{head}",
                              senti_epochs=SENTI_EPOCHS))
    jd, td = (str(root / f"ck_{w}_{head}" / "sentiment")
              for w in ("jax", "port"))
    _assert_metrics(_metrics(td), _metrics(jd))
    jfiles, tfiles = _ckpts(jd), _ckpts(td)
    assert sorted(jfiles) == sorted(tfiles) == [0, SENTI_EPOCHS - 1]
    for e in tfiles:
        _assert_ckpt(tfiles[e], jfiles[e])


# ---------------------------------------------------------------------------
# the sentence classifier: train_sent_senti_cls_rnn
# ---------------------------------------------------------------------------

def _corpus(sizes, seed=3):
    """A senti_captions corpus of the given class sizes."""
    g = np.random.default_rng(seed)
    words = synthetic.WORDS
    return {senti: [[[words[int(j)] for j in g.integers(0, len(words),
                                                        int(L))],
                     ["cat"], ["happy"]]
                    for L in g.integers(1, 12, n)]
            for senti, n in sizes.items()}


@pytest.mark.parametrize("sizes", [
    None,                                     # the tree's corpus
    {"positive": 2500, "negative": 2100, "neutral": 12000}])
def test_build_datasets_matches_jax(tree, sizes):
    """Item for item, on the tree's corpus (val capped at half of each
    class) and on one past the reference's val sizes (5000/1000/1000)."""
    root, _ = tree
    corpus = json.loads((root / "data/captions/coco/part"
                         / "senti_captions.json").read_text()) \
        if sizes is None else _corpus(sizes)
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    cats = ["positive", "negative", "neutral"]
    jtrain, jval = jtrain_cls.build_datasets(corpus, JVocab(idx2word), cats)
    ttrain, tval = ttrain_cls.build_datasets(corpus, TVocab(idx2word), cats)
    assert ttrain == jtrain and tval == jval
    if sizes is not None:
        assert [len(tval[c]) for c in ("neutral", "positive", "negative")] \
            == [5000, 1000, 1000]


@pytest.fixture(scope="module")
def cls_runs(tree):
    """The 30 hard-coded epochs of both packages' classifier trainer from
    the same weights -> {who: stage directory}."""
    root, settings = tree
    n = len(json.loads((root / "data/captions/coco/part/idx2word.json")
                       .read_text()))
    jtrain_cls.train(_jopts(root, settings, "jax"))
    with pytest.MonkeyPatch.context() as mp:
        _same_start(mp, [tss], jss.init_params(jax.random.PRNGKey(0), n, 3,
                                               settings))
        ttrain_cls.train(_topts(root, settings, "port"))
    return {who: str(root / f"ck_{who}" / "sent_senti_cls" / "coco"
                     / "part") for who in ("jax", "port")}


def test_train_sent_senti_cls_rnn_matches_jax(cls_runs):
    jm, tm = _metrics(cls_runs["jax"]), _metrics(cls_runs["port"])
    assert len(tm) == ttrain_cls.EPOCHS
    _assert_metrics(tm, jm)
    jfiles, tfiles = (_ckpts(cls_runs[w]) for w in ("jax", "port"))
    assert sorted(tfiles) == sorted(jfiles) == list(range(ttrain_cls.EPOCHS))
    for e in (0, ttrain_cls.EPOCHS - 1):
        _assert_ckpt(tfiles[e], jfiles[e])


# ---------------------------------------------------------------------------
# resuming from the other package's checkpoint
# ---------------------------------------------------------------------------

RESUME = {  # stage -> (epoch resumed from, opts of the run)
    "concept": (0, dict(concept_epochs=2)),
    "senti": (0, dict(senti_epochs=SENTI_EPOCHS)),
    "cls": (ttrain_cls.EPOCHS - 3, {}),
}


def _resume(root, settings, stage, who, path, tag):
    """Run ``who``'s trainer of ``stage`` resumed from ``path`` into the
    checkpoint root ``ck_<tag>``; returns the stage directory."""
    _, extra = RESUME[stage]
    flag = {"concept": "concept_resume"}.get(stage, "senti_resume")
    opts = (_jopts if who == "jax" else _topts)(root, settings, tag,
                                                **extra, **{flag: path})
    mod = {("jax", "concept"): jtrain_cpt, ("port", "concept"): ttrain_cpt,
           ("jax", "senti"): jtrain_senti, ("port", "senti"): ttrain_senti,
           ("jax", "cls"): jtrain_cls, ("port", "cls"): ttrain_cls}
    mod[who, stage].train(opts)
    sub = {"concept": ("concept", "coco"), "senti": ("sentiment",),
           "cls": ("sent_senti_cls", "coco", "part")}[stage]
    return os.path.join(opts.checkpoint, *sub)


@pytest.mark.parametrize("stage", list(RESUME))
def test_each_package_resumes_from_the_others_checkpoint(
        tree, concept_runs, cls_runs, stage):
    """The port resumed from the JAX CLI's checkpoint against the port's
    uninterrupted run (its concept and classifier runs above; for the
    detector, a run of its own), and the JAX CLI resumed from the port's
    against the JAX CLI resumed from its own."""
    root, settings = tree
    epoch, _ = RESUME[stage]
    if stage == "senti":
        dirs = {}
        for who, mod, opts in (("jax", jtrain_senti, _jopts),
                               ("port", ttrain_senti, _topts)):
            o = opts(root, settings, f"senti_run_{who}",
                     senti_epochs=SENTI_EPOCHS)
            with pytest.MonkeyPatch.context() as mp:
                _same_start(mp, [tsd], jsd.init_params(
                    jax.random.PRNGKey(0), 3, settings))
                mod.train(o)
            dirs[who] = os.path.join(o.checkpoint, "sentiment")
    else:
        dirs = concept_runs if stage == "concept" else cls_runs
    own = {who: _ckpts(d) for who, d in dirs.items()}

    # the port from the JAX file, against the port's uninterrupted run
    d = _resume(root, settings, stage, "port", own["jax"][epoch],
                f"resume_{stage}_port")
    want = _metrics(dirs["port"])
    _assert_metrics(_metrics(d), [m for m in want if m["epoch"] > epoch])
    assert _ckpts(d) and set(_ckpts(d)) <= set(own["port"])
    for e, path in _ckpts(d).items():
        _assert_ckpt(path, own["port"][e], atol=1e-5)
    # the JAX CLI from the port's file, against it from its own
    d_cross = _resume(root, settings, stage, "jax", own["port"][epoch],
                      f"resume_{stage}_jax_from_port")
    d_self = _resume(root, settings, stage, "jax", own["jax"][epoch],
                     f"resume_{stage}_jax_from_jax")
    _assert_metrics(_metrics(d_cross), _metrics(d_self))
    assert _ckpts(d_cross) and sorted(_ckpts(d_cross)) == sorted(
        _ckpts(d_self))
    for e, path in _ckpts(d_cross).items():
        _assert_ckpt(path, _ckpts(d_self)[e], atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints with the optimizer state, and the entry points
# ---------------------------------------------------------------------------

TREES = {  # name -> (JAX init, metadata extra, settings change)
    "concept": (lambda s: jcpt.init_params(jax.random.PRNGKey(1), 7, s),
                {"idx2concept": [f"c{i}" for i in range(7)]}, {}),
    "detector": (lambda s: jsd.init_params(jax.random.PRNGKey(1), 3, s),
                 {}, {}),
    "detector_no_fcs": (lambda s: jsd.init_params(jax.random.PRNGKey(1), 3,
                                                  s),
                        {}, {"sentiment_fcs_num": 0}),
    "detector_full": (lambda s: jsd.module_for(s).init_params(
        jax.random.PRNGKey(1), 3, s), {}, {"num_kernels_per_sentiment": 2}),
    "classifier": (lambda s: jss.init_params(jax.random.PRNGKey(1), 24, 3,
                                             s),
                   {"idx2word": [f"w{i}" for i in range(24)]}, {}),
}


@pytest.mark.parametrize("name", list(TREES))
def test_checkpoint_round_trips_with_adam_state(settings, tmp_path, name):
    """Each head tree with its Adam state after two steps, written by the
    port: the JAX package's ``load`` restores it into its own templates
    with the same values, and the port's reader and
    ``optim.load_optax_state`` give back the params and moments bit for
    bit."""
    init, extra, change = TREES[name]
    s = dataclasses.replace(settings, **change)
    jp = init(s)
    tp = tnn.tree_map(lambda x: x.requires_grad_(True), to_port(jp))
    adam = topt.Adam(tp, 1e-3)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        adam.zero_grad()
        sum((p * torch.randn(p.shape, generator=g)).sum()
            for p in tnn.tree_leaves(tp)).backward()
        adam.step()
    meta = {"epoch": 3, "lr": 1e-3, "settings": s.to_dict(),
            "sentiment_categories": ["positive", "negative", "neutral"],
            **extra}
    path = str(tmp_path / "m.ckpt")
    tck.save(path, tp, topt.to_optax_state(adam), meta)

    tx = jopt.make_optimizer(1e-3)
    jparams, jstate, jmeta = jck.load(path, jp, tx.init(jp))
    assert jmeta["epoch"] == 3
    want = jax_numpy(tp)
    assert [(p, a.tolist()) for p, a in jax_flat(jparams)] == \
        [(p, a.tolist()) for p, a in want]
    assert int(jstate.count) == 2

    params, state, _ = tck.load(path, device="cpu", with_opt_state=True)
    fresh = topt.Adam(tnn.tree_map(lambda x: x.requires_grad_(True),
                                   params), 0.5)
    topt.load_optax_state(fresh, state)
    assert fresh.count == 2 and fresh.lr == pytest.approx(1e-3)
    for a, b in zip(tnn.tree_leaves(params), tnn.tree_leaves(tp)):
        assert torch.equal(a, b.detach())
    for a, b in zip(tnn.tree_leaves([fresh.mu, fresh.nu]),
                    tnn.tree_leaves([adam.mu, adam.nu])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CLIS)
def test_entry_point_runs_as_a_module_and_defaults_to_the_card(name):
    """``python -m`` reaches each CLI's ``main``; with no ``--device`` it
    asks for the card and stops where CUDA is absent (this host)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", f"insenticap_model_tpu_torch.cli.{name}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-2000:]
    r = subprocess.run(
        [sys.executable, "-m", f"insenticap_model_tpu_torch.cli.{name}",
         "--device", "cpu", "--mesh_shape", "[2]"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    # the trainers run data-parallel, launched by torchrun; the concept
    # CLIs stay on one device
    want = "not ported yet" if name in ("detect_concepts", "test_cpt") \
        else "WORLD_SIZE is unset"
    assert want in r.stderr, r.stderr[-2000:]

"""The port's paper-table harness (``cli/reproduce_table.py``) against the
JAX package's on one synthetic artefact tree on the CPU, from an RL
composite ``.ckpt`` (the JAX package's writer) and from a reference
``.pth`` (the same weights under the reference's names and layouts, with
the reference's settings dict), at the conftest widths in f32: the test
dump through the serving path, then BLEU/METEOR*/CIDEr-D, cls% (the
sentence classifier from the checkpoint tree, or written out of the
composite for the ``.pth``) and ppl (LMs the port's ``get_lm_sents`` trains
with ``isclm``).

Tolerances: none. Both packages decode the same weights in f32 to the same
beams (``test_torch_train_rl_cli.py`` holds their dumps byte for byte), so
the tables are held equal as Python values and every file the dump and
the table write byte for byte. The port at ``--mesh_shape [2]`` (one
process, two CPU slots, each decoding its block of every test batch) and
the JAX CLI at ``mesh_shape=(2,)`` write the one-device run's files. Also:
the six CLIs' ``--help`` with JAX,
h5py, PIL and nltk unimportable, and the device-taking ones stop without
a card unless ``--device cpu`` is given.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu.cli import reproduce_table as jrepro
from insenticap_model_tpu.config import Opts as JOpts
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu_torch import preprocessing as tpp
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import eval_senti as teval_senti
from insenticap_model_tpu_torch.cli import reproduce_table as trepro
from insenticap_model_tpu_torch.config import Opts as TOpts
from insenticap_model_tpu_torch.data.feature_store import (open_store,
                                                          write_native_store)
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from torch_parity import detector_params, port_settings, reference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = list(synthetic.CATS)
VOCAB = 4 + len(synthetic.WORDS)
CLIS = ("preprocess", "eval_metrics", "eval_ppl", "eval_senti",
        "convert_checkpoint", "reproduce_table")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree, its anno captions and LMs; the composite as a .ckpt and
    as a reference .pth; a checkpoint root holding the classifier."""
    s = JSettings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                  feat_emb_dim=16, dropout_p=0.5, rnn_hid_dim=16,
                  att_hid_dim=16, concept_mid_dim=24)
    root = tmp_path_factory.mktemp("repro_tree")
    synthetic.build_tree(str(root), port_settings(s), seed=0)
    synthetic.write_rl_inputs(str(root))
    det, det_port = detector_params(s, scale=30.0)
    _steer_test_features(root, det_port)
    # ground truth of both test splits: the captioned images' own, and
    # the train images' for the sentiment images
    caps = json.loads((root / "data/captions/coco/img_captions.json")
                      .read_text())
    anno = {fn: [" ".join(c) for c in cs] for fn, cs in caps["test"].items()}
    senti = json.loads((root / "data/captions/img_senti_labels.json")
                       .read_text())["test"]
    for (fn, _), cs in zip(senti, caps["train"].values()):
        anno[fn] = [" ".join(c) for c in cs]
    (root / "data/captions/coco/anno_captions.json").write_text(
        json.dumps(anno))
    if tpp._isclm_binary() is None:
        pytest.skip("native/build/isclm is not built (make -C native)")
    tpp.get_lm_sents(str(root / "data/captions"), ["coco"], "part")
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    composite = {
        "captioner": jcap.init_params(jax.random.PRNGKey(0), VOCAB, 3, s),
        "senti_detector": det,
        "sent_senti_cls": jss.init_params(jax.random.PRNGKey(1), VOCAB, 3,
                                          s)}
    meta = {"idx2word": idx2word, "sentiment_categories": CATS,
            "dataset_name": "coco", "corpus_type": "part",
            "settings": s.to_dict(), "max_seq_len": 8, "epoch": 0}
    jck.save(str(root / "rl.ckpt"), composite, None, meta)
    d = root / "ck" / "sent_senti_cls" / "coco" / "part"
    d.mkdir(parents=True)
    jck.save(str(d / "model-best.ckpt"), composite["sent_senti_cls"], None,
             meta)
    ref_settings = {k: v for k, v in s.to_dict().items() if k not in (
        "concept_mid_dim", "text_cnn_filters", "num_kernels_per_sentiment",
        "sentiment_feat_dim", "text_cnn_out_dim")}
    ref_settings["concept_mid_him"] = s.concept_mid_dim
    torch.save({"model": reference_state_dict("detector", composite),
                "settings": ref_settings, "idx2word": idx2word,
                "sentiment_categories": CATS, "dataset_name": "coco",
                "corpus_type": "part", "max_seq_len": 8, "epoch": 0},
               str(root / "rl.pth"))
    return root, s


def _steer_test_features(root, det):
    """Shift each test image's att features (both splits) by one of three
    per-channel vectors that ``det`` labels positive, negative and neutral
    with scores over 0.9 on every test image, image i taking vector i % 3:
    so the dump writes captions for every sentiment in both splits, and
    cls% and ppl have their inputs (on the tree's features alone the
    seeded detector gives every image one label)."""
    feats = root / "data" / "features"
    stores = {}
    for path, prefix in ((feats / "coco" / "coco_att.isc", "test_"),
                         (feats / "sentiment" / "feats_att.isc",
                          "senti_test_")):
        store = open_store(str(path))
        rows = {fn: store.get(fn) for fn in store.keys()}
        stores[path] = rows, sorted(fn for fn in rows
                                    if fn.startswith(prefix))
        del store
    base = torch.from_numpy(np.stack([rows[fn] for rows, tests in
                                      stores.values() for fn in tests]))
    g = np.random.default_rng(0)
    shifts = {}
    while len(shifts) < 3:
        u = (g.normal(size=(base.shape[-1],)) * 3).astype(np.float32)
        labels, _, scores = tsd.sample(det, base + torch.from_numpy(u), 0.0,
                                       2)
        if bool((labels == labels[0]).all()) and float(scores.min()) > 0.9:
            shifts.setdefault(int(labels[0]), u)
    for path, (rows, tests) in stores.items():
        for i, fn in enumerate(tests):
            rows[fn] = rows[fn] + shifts[i % 3]
        write_native_store(str(path), rows.items(),
                           next(iter(rows.values())).shape, dtype="float32")


def _kw(root, s, who, src):
    return dict(settings=s, num_concepts=3, max_seq_len=8, rl_bs=6,
                beam_size=2,
                img_senti_labels=str(root / "data/captions/img_senti_labels"
                                     ".json"),
                captions_dir=str(root / "data/captions"),
                feats_dir=str(root / "data/features"),
                checkpoint=str(root / ("ck" if src == "ckpt"
                                       else f"ck_{who}_{src}")),
                result_dir=str(root / f"res_{who}_{src}"))


@pytest.fixture(scope="module")
def tables(tree):
    """Both packages' ``reproduce`` on the .ckpt and on the .pth (module
    scope: one JAX run of each serves every test here)."""
    root, s = tree
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.chdir(root)                  # eval_ppl's LMs are ./data/...
        for src in ("ckpt", "pth"):
            anno = str(root / "data/captions/coco/anno_captions.json")
            out["jax", src] = jrepro.reproduce(
                JOpts(**_kw(root, s, "jax", src), mesh_shape=(1,)),
                str(root / f"rl.{src}"), tag=src, anno_file=anno,
                out=str(root / f"table_jax_{src}.json"))
            out["port", src] = trepro.reproduce(
                TOpts(**_kw(root, port_settings(s), "port", src),
                      device="cpu"),
                str(root / f"rl.{src}"), tag=src, anno_file=anno,
                out=str(root / f"table_port_{src}.json"))
        # the .ckpt again on a mesh of two: the same tag, so the same file
        # names, in result directories of their own
        out["jax", "mesh"] = jrepro.reproduce(
            JOpts(**dict(_kw(root, s, "jax", "ckpt"),
                         result_dir=str(root / "res_jax_mesh")),
                  mesh_shape=(2,)),
            str(root / "rl.ckpt"), tag="ckpt", anno_file=anno,
            out=str(root / "table_jax_mesh.json"))
        out["port", "mesh"] = trepro.reproduce(
            TOpts(**dict(_kw(root, port_settings(s), "port", "ckpt"),
                         result_dir=str(root / "res_port_mesh")),
                  device="cpu", mesh_shape=(2,)),
            str(root / "rl.ckpt"), tag="ckpt", anno_file=anno,
            out=str(root / "table_port_mesh.json"))
    finally:
        mp.undo()
    return root, out


@pytest.mark.parametrize("src", ["ckpt", "pth"])
def test_reproduce_equals_jax(tables, src):
    root, out = tables
    got, want = out["port", src], out["jax", src]
    assert got == want
    assert set(got["splits"]) == {"fact", "senti"}
    for d in got["splits"].values():
        assert d["quality"] and d["cls"] is not None and d["ppl"] is not None
    assert 0.0 <= got["det_sentis_wrong_rate"] <= 1.0
    assert (root / f"table_port_{src}.json").read_bytes() == \
        (root / f"table_jax_{src}.json").read_bytes()
    jdir = root / f"res_jax_{src}" / "rl" / "coco" / "part"
    tdir = root / f"res_port_{src}" / "rl" / "coco" / "part"
    names = sorted(n for n in os.listdir(jdir) if n.startswith("result_"))
    assert names and names == sorted(
        n for n in os.listdir(tdir) if n.startswith("result_"))
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n


def test_reproduce_on_a_mesh_of_two(tables, monkeypatch):
    """``--mesh_shape [2] --device cpu``: the dump files and the table of
    the one-device run, byte for byte, and those of the JAX CLI at
    ``mesh_shape=(2,)``; the CLI's flag reaches the options."""
    root, out = tables
    assert out["port", "mesh"] == out["port", "ckpt"] == out["jax", "mesh"]
    tables_ = [(root / f"table_{w}.json").read_bytes()
               for w in ("port_mesh", "port_ckpt", "jax_mesh")]
    assert tables_[0] == tables_[1] == tables_[2]
    dirs = [root / d / "rl" / "coco" / "part"
            for d in ("res_port_mesh", "res_port_ckpt", "res_jax_mesh")]
    names = sorted(n for n in os.listdir(dirs[0]) if n.startswith("result_"))
    assert names
    for d in dirs[1:]:
        assert names == sorted(n for n in os.listdir(d)
                               if n.startswith("result_"))
        for n in names:
            assert (dirs[0] / n).read_bytes() == (d / n).read_bytes(), n
    seen = {}
    monkeypatch.setattr(trepro, "reproduce",
                        lambda opt, *a, **kw: seen.update(opt=opt))
    trepro.main(["--rl_model", "x.ckpt", "--device", "cpu", "--mesh_shape",
                 "[2]", "--rl_bs", "5"])
    assert seen["opt"].mesh_shape == (2,) and seen["opt"].device == "cpu"


def test_pth_and_ckpt_give_one_table(tables):
    """The reference .pth (converted in memory, its classifier written out
    of the composite) and the .ckpt of the same weights."""
    root, out = tables
    assert out["port", "pth"] == out["port", "ckpt"]
    assert (root / "res_port_pth/rl/coco/part/_repro_ckpt/sent_senti_cls/"
            "coco/part/model-best.ckpt").exists()


def test_ppl_and_cls_degrade_to_null_as_in_jax(tree, capsys, monkeypatch):
    """No LMs under the working directory and a bare state dict without
    metadata: ppl and cls null, the quality columns still there."""
    root, s = tree
    bare = root / "bare.pth"
    blob = torch.load(str(root / "rl.pth"))
    torch.save(blob["model"], str(bare))
    empty = root / "elsewhere"
    empty.mkdir()
    monkeypatch.chdir(empty)
    anno = str(root / "data/captions/coco/anno_captions.json")
    kw = _kw(root, port_settings(s), "port", "bare")
    table = trepro.reproduce(TOpts(**kw, device="cpu"), str(bare),
                             tag="bare", anno_file=anno)
    for d in table["splits"].values():
        assert d["quality"] and d["cls"] is None and d["ppl"] is None
    out = capsys.readouterr().out
    assert "cls unavailable" in out and "ppl skipped" in out


_BLOCKED_HELP = """
import runpy, sys
for name in ("jax", "h5py", "PIL", "nltk", "flax", "optax", "msgpack",
             "insenticap_model_tpu"):
    sys.modules[name] = None
for cli in sys.argv[1:]:
    sys.argv = [cli, "--help"]
    try:
        runpy.run_module("insenticap_model_tpu_torch.cli." + cli,
                         run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (cli, e.code)
    print("HELP-OK", cli)
"""


def test_clis_help_without_jax_h5py_pil_or_nltk():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_HELP, *CLIS],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert [x for x in r.stdout.splitlines() if x.startswith("HELP-OK")] \
        == [f"HELP-OK {c}" for c in CLIS]


def test_clis_stop_without_a_card_unless_asked_for_the_cpu(tree):
    """``python -m`` reaches reproduce_table's ``main``, which with no
    ``--device`` asks for the card and stops where CUDA is absent; with
    ``--device cpu`` it goes on (and stops at what it then lacks). The
    same for eval_senti in the process."""
    root, _ = tree
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    mod = "insenticap_model_tpu_torch.cli.reproduce_table"
    r = subprocess.run([sys.executable, "-m", mod, "--rl_model",
                        str(root / "rl.ckpt")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-2000:]
    with pytest.raises(FileNotFoundError, match="img_captions"):
        trepro.main(["--rl_model", str(root / "rl.ckpt"), "--device",
                     "cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval_senti.main(["--rl_senti_resume", str(root / "rl.ckpt")])

"""The 2-D data x model mesh on the CPU (gloo): the captioner's word
embedding and classifier sharded by vocabulary over the model axis
(``parallel/mesh.py``'s grid and shard rules, ``parallel/vocab.py``'s
operations), the batch over the data axis. The ranks are processes
(``torch_ranks.run_ranks``); the one-process reference runs the same
rank function with no process group.

- The six vocabulary operations (``cap.embed_word``, ``cap.log_probs``:
  the classifier's input and log-softmax, ``cap._pick``, ``cap._greedy``,
  ``cap._categorical``) at [1, 2], V = 200: values within 1e-6 of the
  largest magnitude, ids identical, and the gradients of one loss
  through them all within 1e-6 of their norm.
- The XE train step (dropout 0.5, scheduled sampling at 0.25, the
  seq2seq and domain-alignment terms on) at [1, 2] and [2, 2] against
  one process on the global batch, two steps in float64: losses within
  1e-5 relative, each gradient within 1e-6 of its leaf's norm (a sharded
  leaf's against its slice of the one-process gradient; the two
  softmax-invariant attention-score biases, whose gradient is rounding,
  within 1e-12), params within 1e-6 (those biases within lr a step); the
  replicated leaves bit for bit alike on every rank, a shard on every
  rank of its data group.
- The deterministic XE step (dropout 0, ss_prob 0) at [2, 2] against the
  JAX package's step on a (2, 2) mesh placed by ``captioner_shardings``
  (4 of the 8 virtual CPU devices), two steps in float32: losses within
  1e-5 relative, params within 1e-5 (the two biases within lr a step),
  and
  each device's addressable shard of JAX's ``word_embed.table``,
  ``classifier.w`` and ``classifier.b``, converted, equal to the port
  rank's shard before the steps and within 1e-6 after them.
- The RL fact step at [1, 2] in float64, the real sampler: the sampled
  and greedy rollouts' tokens identical to one process's (and their
  log-probs within 1e-9), the step's losses within 1e-5 relative.
- ``Runtime`` at [2, 2]: ``round_bs`` over dp, ``host_shard`` per data
  group, V/2 rows of params and moments, the JAX package's warning and
  replication where tp does not divide V, the exits of a 3-axis mesh and
  of a mesh that disagrees with the group.
- The CLIs at [1, 2] on ``synthetic.build_tree`` (V = 20): ``train_xe``
  for epoch 0 and resumed for epoch 1, ``train_rl`` for epoch 0 and
  ``train_cpt`` (data-parallel over a data axis of one, its work repeated
  across the model axis), against one process: metrics within 1e-5
  relative; rank 0's checkpoints load in one process (and the XE one in
  the JAX package's reader) with params within 1e-6 (the two biases
  within lr a step); the XE dump bit for bit one process's
  ``decode_split`` of the checkpoint's params; the RL dump files byte for
  byte the one process's; no file written by rank 1.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.parallel import mesh as jmesh
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu.training import optim as jopt
from insenticap_model_tpu.training import steps as jsteps
from insenticap_model_tpu_torch import synthetic
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.cli import train_cpt, train_rl, train_xe
from insenticap_model_tpu_torch.config import Opts, Settings
from insenticap_model_tpu_torch.models import captioner as tcap
from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
from insenticap_model_tpu_torch.models import sentiment_detector as tsd
from insenticap_model_tpu_torch.parallel import mesh as tmesh
from insenticap_model_tpu_torch.training import checkpoint as tck
from torch_parity import SOFTMAX_INVARIANT as JAX_SOFTMAX_INVARIANT
from torch_parity import (JIDS, caption_batches, detector_params, jax_flat,
                          jax_numpy, port_settings, to_port)
from torch_ranks import (cli_runs, numpy_tree, rl_steps, run_ranks,
                         runtime_grid, sequence, tensors, vocab_ops,
                         xe_steps)

VOCAB = 200
LR = 4e-4
GLOBAL_BS = 8          # rows: 4 a data group at [2, 2]
MAXLEN = 6
STEPS = 2
SS_PROB = 0.25
SOFTMAX_INVARIANT = ("attention/cont/att_alpha/bias",
                     "attention/senti/word_alpha/bias")
VOCAB_PATHS = ("classifier/bias", "classifier/weight", "word_embed/weight")
# the same two biases in the JAX layout of Adam's moments
MOMENTS_INVARIANT = ("attention/cont/att_alpha/b",
                     "attention/senti/word_alpha/b")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _sliced(path, full, shard):
    """The one-process value of a leaf on a rank of ``shard`` (start,
    size): its rows for a vocab leaf, else the whole."""
    if shard is None or path not in VOCAB_PATHS:
        return full
    return full[shard[0]:shard[0] + shard[1]]


def _corpus(fns):
    g = np.random.default_rng(2)
    return {fn: [[JIDS.sos] + list(map(int, g.integers(4, VOCAB, size=4)))
                 + [JIDS.eos] for _ in range(int(g.integers(2, 5)))]
            for fn in fns}


def _rl_batch(settings, seed, fns):
    """A fact batch at GLOBAL_BS rows (14 x 14 grids, each image's
    channels shifted, so that the detector's labels differ) and its
    seq2seq batch."""
    b, scs = caption_batches(settings, GLOBAL_BS, seed, maxlen=MAXLEN,
                             vocab=VOCAB)
    g = np.random.default_rng(100 + seed)
    C = settings.att_feat_dim
    b["att"] = (g.normal(size=(GLOBAL_BS, 14, 14, C))
                + 2.0 * g.normal(size=(GLOBAL_BS, 1, 1, C))).astype(
                    np.float32)
    b["sentis"] = g.integers(4, VOCAB, size=(GLOBAL_BS, 6)).astype(np.int32)
    b["img_rows"] = np.arange(len(fns), dtype=np.int32)
    return b, scs


@pytest.fixture(scope="module")
def inputs(settings):
    """The JAX captioner (V = VOCAB) and classifier, their port copies,
    the specs of the rank functions and the deterministic settings."""
    jp = jcap.init_params(jax.random.PRNGKey(0), VOCAB, 3, settings)
    jc = jss.init_params(jax.random.PRNGKey(1), VOCAB, 3, settings)
    tp, tc = to_port(jp), to_port(jc)
    batches = [caption_batches(settings, GLOBAL_BS, seed=i, maxlen=MAXLEN,
                               vocab=VOCAB) for i in range(STEPS)]
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    drop = (numpy_tree(tp), numpy_tree(tc), batches,
            port_settings(settings).to_dict(), SS_PROB, torch.float64, LR)
    plain = (numpy_tree(tp), numpy_tree(tc), batches,
             port_settings(nodrop).to_dict(), 0.0, torch.float32, LR)
    g = np.random.default_rng(0)
    H = settings.rnn_hid_dim
    ops = {"params": {k: numpy_tree(tp[k])
                      for k in ("word_embed", "classifier")},
           "h": g.normal(size=(12, H)).astype(np.float32),
           "ids": g.integers(0, VOCAB, size=(12, 5)).astype(np.int64),
           "targets": g.integers(0, VOCAB, size=(12,)).astype(np.int64),
           "weights": (0.01 * g.normal(size=(12, VOCAB))).astype(
               np.float32)}
    ops["ids"][:, 0] = 0                   # pad ids embed to zeros
    fns = [f"img{i}" for i in range(GLOBAL_BS)]
    jpe = dict(jp, classifier=dict(jp["classifier"], b=jp["classifier"]["b"]
                                   .at[JIDS.eos].add(1.5)))
    _, td = detector_params(settings, scale=30.0)
    rl = dict(params=numpy_tree(to_port(jpe)),
              frozen=(numpy_tree(td), numpy_tree(tc)), corpus=_corpus(fns),
              settings=port_settings(settings).to_dict(),
              dtype=torch.float64, lr=LR, max_seq_len=MAXLEN,
              data_type="fact", rollouts=True,
              batches=[_rl_batch(settings, i, fns) for i in range(STEPS)])
    return {"jp": jp, "jc": jc, "tp": tp, "drop": drop, "plain": plain,
            "ops": ops, "rl": rl, "nodrop": nodrop, "batches": batches}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """One spawn of 2 ranks ([1, 2]: the operations, the XE step, the RL
    step) and one of 4 ([2, 2]: the XE step with and without dropout,
    the Runtime)."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    two = run_ranks(sequence, 2, tmp, [
        (vocab_ops, (inputs["ops"],)),
        (xe_steps, inputs["drop"] + ((1, 2),)),
        (rl_steps, (dict(inputs["rl"], grid=(1, 2)),))])
    four = run_ranks(sequence, 4, tmp, [
        (xe_steps, inputs["drop"] + ((2, 2),)),
        (xe_steps, inputs["plain"] + ((2, 2),)),
        (runtime_grid, ([VOCAB, 25],))])
    return {"ops": [r[0] for r in two], ("xe", 2): [r[1] for r in two],
            "rl": [r[2] for r in two], ("xe", 4): [r[0] for r in four],
            "plain": [r[1] for r in four], "runtime": [r[2] for r in four]}


def test_vocab_operations_equal_one_process(inputs, ranks):
    one = vocab_ops(0, 1, inputs["ops"])
    assert one["stats"]["collectives"] == 0
    for out in ranks["ops"]:
        start, size = out["shard"]
        cols = slice(start, start + size)
        assert size == VOCAB // 2
        # forward: embed, log-softmax, pick, argmax, categorical (2);
        # backward: the log-softmax's sum of g, the classifier's input
        assert out["stats"]["collectives"] == 8
        for key, want in (("embed", one["embed"]),
                          ("logprobs", one["logprobs"][:, cols]),
                          ("picked", one["picked"]), ("best", one["best"])):
            got = out[key]
            assert got.shape == want.shape, key
            assert float((got - want).abs().max()) <= \
                1e-6 * float(want.abs().max()), key
        assert torch.equal(out["greedy"], one["greedy"])
        assert torch.equal(out["draws"], one["draws"])
        assert float((out["h_grad"] - one["h_grad"]).norm()) <= \
            1e-6 * float(one["h_grad"].norm())
        for got, want in zip(out["grads"], one["grads"]):
            want = want[cols]
            assert got.shape == want.shape
            assert float((got - want).norm()) <= 1e-6 * float(want.norm())
    a, b = ranks["ops"]
    assert torch.equal(a["greedy"], b["greedy"])
    assert torch.equal(a["draws"], b["draws"])
    assert torch.equal(a["picked"], b["picked"])


def _hold_steps(outs, one, rank_coords):
    """Each rank's XE or RL step record against the one-process one (see
    the module docstring); ``rank_coords`` the ranks' (data, model)
    coordinates."""
    paths = _paths(one["params"])
    for out in outs:
        shard = out["shard"]
        assert shard is not None and shard[1] == VOCAB // 2
        for got, want in zip(out["losses"], one["losses"]):
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
        for step, (gs, ws) in enumerate(zip(out["grads"], one["grads"])):
            for path, g, w in zip(paths, gs, ws):
                w = _sliced(path, w, shard)
                assert g.shape == w.shape, path
                tol = 1e-12 if path in SOFTMAX_INVARIANT else \
                    1e-6 * float(w.norm())
                assert float((g - w).norm()) <= tol, (step, path)
        for path, a, b in zip(paths, _leaves(out["params"]),
                              _leaves(one["params"])):
            tol = LR * STEPS if path in SOFTMAX_INVARIANT else 1e-6
            np.testing.assert_allclose(a, _sliced(path, b, shard), atol=tol,
                                       rtol=0, err_msg=path)
    # the replicated leaves alike on every rank, each shard on every rank
    # of its data group (the same model coordinate)
    for i, path in enumerate(paths):
        for r, out in enumerate(outs):
            q = 0 if path not in VOCAB_PATHS else \
                [m for _, m in rank_coords].index(rank_coords[r][1])
            assert np.array_equal(_leaves(out["params"])[i],
                                  _leaves(outs[q]["params"])[i]), (r, path)


@pytest.mark.parametrize("world", [2, 4])
def test_xe_step_on_a_grid_equals_one_process(world, inputs, ranks):
    """[1, 2] (world 2) and [2, 2] (world 4)."""
    one = xe_steps(0, 1, *inputs["drop"])
    tp = 2
    coords = [(r // tp, r % tp) for r in range(world)]
    _hold_steps(ranks[("xe", world)], one, coords)
    assert all(set(o["losses"][0]) == {"xe_loss", "da_loss", "cap_loss",
                                       "seq2seq_loss", "all_loss"}
               for o in ranks[("xe", world)])


def _port_shard(tp_params, m):
    """The port's shard m of 2 of a captioner (``shard_captioner``)."""
    size = VOCAB // 2
    return tmesh.shard_captioner(tp_params, tmesh.VocabShard(
        VOCAB, m * size, size, m, 2, None))


def test_xe_step_2x2_equals_jax_mesh(inputs, ranks):
    """The JAX step on a (2, 2) data x model mesh, its captioner placed by
    ``captioner_shardings``, against the port's [2, 2] ranks; and the
    layout: JAX's device (d, m) holds the port rank 2d + m's shard."""
    m = jmesh.make_mesh((2, 2))
    jp = jmesh.place(inputs["jp"], jmesh.captioner_shardings(m, inputs["jp"]))
    devices = list(m.devices.flat)

    def device_shards(params):
        """{rank: (word_embed rows, classifier rows, bias)} in the port's
        layout, from each device's addressable shard."""
        out = {}
        for r, dev in enumerate(devices):
            got = []
            for leaf in (params["word_embed"]["table"],
                         params["classifier"]["w"], params["classifier"]["b"]):
                [s] = [s for s in leaf.addressable_shards if s.device == dev]
                got.append(np.asarray(s.data))
            out[r] = (got[0], got[1].T, got[2])
        return out

    for r, (emb, w, b) in device_shards(jp).items():
        mine = _port_shard(inputs["tp"], r % 2)
        assert np.array_equal(emb, mine["word_embed"]["weight"].numpy())
        assert np.array_equal(w, mine["classifier"]["weight"].numpy())
        assert np.array_equal(b, mine["classifier"]["bias"].numpy())
    cls = jmesh.replicate(m, inputs["jc"])
    tx = jopt.make_optimizer(LR)
    state = tx.init(jp)
    jtrain, _ = jsteps.make_xe_steps(inputs["nodrop"], tx)
    jlosses = []
    for i, (b, scs) in enumerate(inputs["batches"]):
        jp, state, jl = jtrain(jp, state, cls, jmesh.shard_batch(m, b),
                               jmesh.shard_batch(m, scs),
                               jax.random.PRNGKey(i), jnp.float32(0.0))
        jlosses.append({k: float(v) for k, v in jl.items()})
    assert jp["classifier"]["w"].sharding.spec == \
        jax.sharding.PartitionSpec(None, "model")
    outs = ranks["plain"]
    for out in outs:
        for got, want in zip(out["losses"], jlosses):
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for r, (emb, w, b) in device_shards(jp).items():
        p = outs[r]["params"]
        for got, want in ((p["word_embed"]["weight"], emb),
                          (p["classifier"]["weight"], w),
                          (p["classifier"]["bias"], b)):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the whole params: the replicated leaves of rank 0, the vocab leaves
    # of the model group of data coordinate 0 (ranks 0 and 1)
    whole = tensors(outs[0]["params"])
    for key, name in tmesh.VOCAB_LEAVES:
        whole[key][name] = torch.cat([torch.from_numpy(
            outs[r]["params"][key][name]) for r in (0, 1)])
    got, want = jax_numpy(whole), jax_flat(jp)
    assert [q for q, _ in got] == [q for q, _ in want]
    for (path, a), (_, b) in zip(got, want):
        tol = LR * STEPS if path in JAX_SOFTMAX_INVARIANT else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=path)


def test_rl_fact_step_on_a_grid_equals_one_process(inputs, ranks):
    """[1, 2], float64, the real sampler: the rollouts' tokens identical
    to one process's and alike on both ranks, then the fact step."""
    one = rl_steps(0, 1, inputs["rl"])
    outs = ranks["rl"]
    for out in outs:
        for name in ("sampled", "greedy"):
            seq, lp = out["rollouts"][name]
            want_seq, want_lp = one["rollouts"][name]
            assert torch.equal(seq, want_seq), name
            np.testing.assert_allclose(lp.numpy(), want_lp.numpy(),
                                       atol=1e-9, rtol=0, err_msg=name)
    assert one["rollouts"]["sampled"][0].ne(
        one["rollouts"]["greedy"][0]).any()
    _hold_steps(outs, one, [(0, 0), (0, 1)])
    assert {"fact_reward", "xe_loss", "cap_loss"} <= set(
        outs[0]["losses"][0])


def test_runtime_on_a_2x2_grid(ranks):
    outs = ranks["runtime"]
    for r, out in enumerate(outs):
        assert out["round_bs"] == 4                     # dp 2, not 4
        assert out["host_shard"] == (r // 2, 2)
        assert out["coords"] == (r // 2, r % 2)
        assert f"rank {r} of 4" in out["printed"]
        assert "NOTE: the model axis only shards the captioner" in \
            out["printed"]
        sharded, odd = out["placed"][VOCAB], out["placed"][25]
        assert sharded["rows"] == [VOCAB // 2] * 9
        assert sharded["shard"] == ((r % 2) * VOCAB // 2, VOCAB // 2)
        assert sharded["printed"] == ""
        assert odd["rows"] == [25] * 9 and odd["shard"] is None
        assert "WARNING: vocab 25 does not divide model axis 2; captioner " \
            "params replicated instead" in odd["printed"]
        three, wrong = out["exits"]
        assert "a mesh of 3 axes" in three
        assert "[4, 2] disagrees with the process group's 4 ranks" in wrong


# ---------------------------------------------------------------------------
# The CLIs at [1, 2]
# ---------------------------------------------------------------------------

SETTINGS = Settings(word_emb_dim=16, fc_feat_dim=32, att_feat_dim=32,
                    feat_emb_dim=16, dropout_p=0.5, rnn_hid_dim=16,
                    att_hid_dim=16, concept_mid_dim=24)
XE_BS = 6
RL_BS = 4
CAP = 2                # train_rl.MAX_BATCHES_PER_EPOCH in every RL run
XE_STEPS = synthetic.N_IMG["train"] * 3 // XE_BS


def _stage(root, who, stage, kind="ck"):
    return os.path.join(root, f"{kind}_{who}", *stage)


XE_STAGE = ("xe", "coco", "part")
RL_STAGE = ("rl", "coco", "part")
CPT_STAGE = ("concept", "coco")


def _metrics(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _hold_metrics(got, want):
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-7), (k, a, b)


def _hold_params(got, want, steps, shard=None):
    """A captioner (or any tree) against the one-process one: within 1e-6,
    the softmax-invariant biases within lr a step; ``shard`` (start,
    size): ``got``'s vocab leaves are that shard's rows."""
    for path, a, b in zip(_paths(want), _leaves(got), _leaves(want)):
        tol = LR * steps if path in SOFTMAX_INVARIANT else 1e-6
        np.testing.assert_allclose(np.asarray(a),
                                   _sliced(path, np.asarray(b), shard),
                                   atol=tol, rtol=0, err_msg=path)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The tree (XE and RL inputs, the bootstrap checkpoints), one spawn
    of 2 ranks running the CLIs at [1, 2] (train_xe epoch 0, train_xe
    resumed for epoch 1, train_rl epoch 0, train_cpt), and the one
    process's runs -> (root, the ranks' results, the one process's
    trained params by run)."""
    root = tmp_path_factory.mktemp("tp_cli_tree")
    synthetic.build_tree(str(root), SETTINGS, seed=0)
    synthetic.write_rl_inputs(str(root))
    idx2word = json.loads((root / "data/captions/coco/part/idx2word.json")
                          .read_text())
    assert len(idx2word) % 2 == 0
    cats = list(synthetic.CATS)
    meta = {"settings": SETTINGS.to_dict(), "idx2word": idx2word,
            "sentiment_categories": cats, "dataset_name": "coco",
            "corpus_type": "part"}
    boot = {"xe": tcap.init_params(torch.Generator().manual_seed(0),
                                   len(idx2word), 3, SETTINGS, device="cpu"),
            "sent_senti_cls": ss_cls.init_params(
                torch.Generator().manual_seed(1), len(idx2word), 3,
                SETTINGS, device="cpu")}
    for who in ("one", "two", "resumed", "one_resumed"):
        for stage, params in boot.items():
            if stage == "xe" and who in ("resumed", "one_resumed"):
                continue
            tck.save(str(root / f"ck_{who}" / stage / "coco" / "part"
                         / "model-best.ckpt"), params, None, meta)
    det = tsd.init_params(torch.Generator().manual_seed(2), 3, SETTINGS,
                          device="cpu")
    det["fcs"] = [{k: v * 30.0 for k, v in f.items()} for f in det["fcs"]]
    tck.save(str(root / "det.ckpt"), det, None,
             {"settings": SETTINGS.to_dict(), "sentiment_categories": cats})

    def kw(who, **extra):
        return dict(settings=SETTINGS.to_dict(), num_concepts=3,
                    max_seq_len=8, seed=0, xe_bs=XE_BS, rl_bs=RL_BS,
                    beam_size=2, scheduled_sampling_increase_every=1,
                    rl_senti_times=1, rl_senti_resume=str(root / "det.ckpt"),
                    concept_bs=6, concept_epochs=1,
                    img_senti_labels=str(
                        root / "data/captions/img_senti_labels.json"),
                    captions_dir=str(root / "data/captions"),
                    feats_dir=str(root / "data/features"),
                    checkpoint=str(root / f"ck_{who}"),
                    result_dir=str(root / f"res_{who}"), **extra)
    epoch0 = str(root / "ck_two" / "xe" / "coco" / "part" / "model_0_*")
    res = run_ranks(cli_runs, 2, tmp_path_factory.mktemp("tp_cli_ranks"),
                    str(root), [
                        ("train_xe", kw("two", xe_epochs=1)),
                        ("train_xe", kw("resumed", xe_epochs=2,
                                        xe_resume="glob:" + epoch0)),
                        ("train_rl", kw("two", rl_epochs=1)),
                        ("train_cpt", kw("two"))],
                    [("train_rl", "MAX_BATCHES_PER_EPOCH", CAP)], (1, 2))
    [ck0] = [f for f in os.listdir(_stage(root, "two", XE_STAGE))
             if f.startswith("model_0_")]

    def one(mod, who, **extra):
        return numpy_tree(mod.train(Opts(**dict(
            kw(who, **extra), settings=SETTINGS, device="cpu"))))
    ones = {"xe": one(train_xe, "one", xe_epochs=1),
            "xe_resumed": one(train_xe, "one_resumed", xe_epochs=2,
                              xe_resume=os.path.join(
                                  _stage(root, "two", XE_STAGE), ck0)),
            "cpt": one(train_cpt, "one")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_rl, "MAX_BATCHES_PER_EPOCH", CAP)
        ones["rl"] = one(train_rl, "one", rl_epochs=1)
    return root, res, ones, kw, ck0


def test_train_xe_cli_on_a_grid(cli):
    """Epoch 0 at [1, 2] and its resume at [1, 2] against one process and
    a one-process resume from the same checkpoint; the checkpoint read in
    one process by both packages; the dump against one process's decode
    of the checkpoint's params."""
    root, res, ones, kw, ck0 = cli
    _hold_metrics(_metrics(_stage(root, "two", XE_STAGE)),
                  _metrics(_stage(root, "one", XE_STAGE)))
    _hold_metrics(_metrics(_stage(root, "resumed", XE_STAGE)),
                  _metrics(_stage(root, "one_resumed", XE_STAGE)))
    path = os.path.join(_stage(root, "two", XE_STAGE), ck0)
    p2, s2, m2 = tck.load(path, device="cpu", with_opt_state=True)
    [mine] = [f for f in os.listdir(_stage(root, "one", XE_STAGE))
              if f.startswith("model_0_")]
    p1, s1, m1 = tck.load(os.path.join(_stage(root, "one", XE_STAGE), mine),
                          device="cpu", with_opt_state=True)
    assert (m2["epoch"], m2["lr"]) == (m1["epoch"], m1["lr"])
    assert int(s2["count"]) == int(s1["count"]) == XE_STEPS
    _hold_params(numpy_tree(p2), numpy_tree(p1), XE_STEPS)
    adam2, adam1 = s2["inner_state"][1], s1["inner_state"][1]
    for moment in ("mu", "nu"):
        want = numpy_tree(adam1[moment])
        for leaf, a, b in zip(_paths(want), _leaves(numpy_tree(
                adam2[moment])), _leaves(want)):
            assert a.shape == b.shape
            # the two biases' gradient is rounding: their moments too
            tol = 1e-6 if leaf in MOMENTS_INVARIANT else \
                1e-5 * np.abs(b).max()
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=leaf)
    jtmpl = jcap.init_params(jax.random.PRNGKey(0), len(m2["idx2word"]), 3,
                             JSettings(**SETTINGS.to_dict()))
    jparams, jstate, jmeta = jck.load(path, jtmpl, jopt.make_optimizer(
        LR).init(jtmpl))
    assert int(jstate.count) == XE_STEPS
    assert jmeta == m2
    assert np.array_equal(np.asarray(jparams["word_embed"]["table"]),
                          p2["word_embed"]["weight"].numpy())
    assert np.array_equal(np.asarray(jparams["classifier"]["w"]).T,
                          p2["classifier"]["weight"].numpy())
    # the dump: one process's decode of the checkpoint's params
    opt = Opts(**dict(kw("dump"), settings=SETTINGS, device="cpu"))
    rt = tcommon.Runtime(opt)
    vocab = tcommon.load_vocab(opt)
    ids = tcommon.token_ids(vocab, opt.sentiment_categories)
    fc, att = (tcommon.open_store(p) for p in tcommon.feature_paths(opt))
    fns = sorted(tcommon.load_json(tcommon.dataset_path(
        opt, "img_captions.json"))["test"])
    want = train_xe.decode_split(p2, fc, att, fns, rt.round_bs(XE_BS), rt,
                                 opt, ids, vocab)
    with open(os.path.join(_stage(root, "two", XE_STAGE, "res"),
                           "result_0.json")) as f:
        got = json.load(f)
    assert got == [{"image_id": r["image_id"], "caption": r["caption"]}
                   for r in want]
    assert len(got) == synthetic.N_IMG["test"]
    # each rank returns its shard of the trained params
    for r, out in enumerate(res):
        size = len(m2["idx2word"]) // 2
        _hold_params(out["params"][0], ones["xe"], XE_STEPS,
                     (r * size, size))
        _hold_params(out["params"][1], ones["xe_resumed"], 2 * XE_STEPS,
                     (r * size, size))
    assert res[1]["writes"] == []


def test_train_rl_cli_on_a_grid(cli):
    root, res, ones, _, _ = cli
    _hold_metrics(_metrics(_stage(root, "two", RL_STAGE)),
                  _metrics(_stage(root, "one", RL_STAGE)))
    p2, s2, _ = tck.load(os.path.join(_stage(root, "two", RL_STAGE),
                                      "model_0.ckpt"), device="cpu",
                         with_opt_state=True)
    p1, s1, _ = tck.load(os.path.join(_stage(root, "one", RL_STAGE),
                                      "model_0.ckpt"), device="cpu",
                         with_opt_state=True)
    steps = int(s1["count"])
    assert int(s2["count"]) == steps > 0
    _hold_params(numpy_tree(p2["captioner"]), numpy_tree(p1["captioner"]),
                 steps)
    one_res = sorted(os.listdir(_stage(root, "one", RL_STAGE, "res")))
    assert sorted(os.listdir(_stage(root, "two", RL_STAGE, "res"))) == \
        one_res and one_res
    for name in one_res:
        with open(os.path.join(_stage(root, "two", RL_STAGE, "res"), name),
                  "rb") as f:
            a = f.read()
        with open(os.path.join(_stage(root, "one", RL_STAGE, "res"), name),
                  "rb") as f:
            assert a == f.read(), name
    for r, out in enumerate(res):
        size = len(p1["captioner"]["classifier"]["bias"]) // 2
        _hold_params(out["params"][2], ones["rl"], steps, (r * size, size))


def test_head_cli_on_a_grid_repeats_one_process(cli):
    """train_cpt at [1, 2]: a data axis of one, the work repeated on both
    model ranks, equal to one process."""
    root, res, ones, _, _ = cli
    _hold_metrics(_metrics(_stage(root, "two", CPT_STAGE)),
                  _metrics(_stage(root, "one", CPT_STAGE)))
    for out in res:
        _hold_params(out["params"][3], ones["cpt"], 1)
    assert all(np.array_equal(a, b) for a, b in zip(
        _leaves(res[0]["params"][3]), _leaves(res[1]["params"][3])))

"""Shared CLI plumbing: the counterpart of
``insenticap_model_tpu/cli/common.py`` for the ported entry points.

Inference side (:34-83): JSON artefact reading, the decode's special ids,
the concept checkpoint bootstrap and the detected-concepts ->
sentiment-word ids step. Training side (:39-50, :86-143, :341-486): the
artefact paths (``sniff_store_path``: the ``.isc`` store beside a
reference ``.h5`` path) and reference-compatible tokenizers, the
``Runtime`` (the rank's device and process group under data parallelism,
batch placement from pinned memory and the dtype policy), each step's
seed, the caption, sentiment-corpus, RL fact and sentiment-image,
concept, sentiment-image and sentence loaders (each rank's stripe,
``host_shard``), stage directories, checkpoint selection and result and
metrics writing (rank 0's).

Data parallelism in training (``--mesh_shape [n]``, n processes launched
by ``torchrun --nproc_per_node n``): each rank loads ``round_bs(bs) / n``
rows of its stripe of the train split a step, and the steps
(``training/steps.py``) all-reduce the counts and the gradients, so that
the ranks' step is the one-process step on the global batch (the ranks'
batches concatenated in rank order). The eval loaders are not striped:
every rank evaluates the whole split, so the val loss, and the
learning-rate halving that reads it, are the same on every rank. The
entry points that serve (``reproduce_table``) take ``--mesh_shape [n]``
as n devices driven by one process (``Runtime(opt, serving=True)``);
``serve`` alone also runs a mesh over processes (``serving_mesh``).

Artefact schemas are the reference's JSON contracts (SURVEY.md §1):
idx2word.json (list), img_captions.json ({split: {fn: [[word, ...],
...]}}), img_det_concepts.json ({fn: [word]}), senti_captions.json
({senti: [[cap_words, cpt_words, senti_words], ...]}).
"""
from __future__ import annotations

import atexit
import functools
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import nn
from ..config import Opts
from ..data import collate
from ..data.feature_store import open_store  # noqa: F401 (re-export, as
#   the JAX module: the trainers open stores as common.open_store)
from ..data.loaders import Loader, device_prefetch
from ..parallel import mesh
from ..training import checkpoint as ckpt
from ..training import optim
from ..utils.dtypes import resolve_device
from ..vocab import Vocab, token_ids, upsample_to_neutral  # noqa: F401

# batch keys that stay on the host (``valid``, the count of true rows of a
# padded eval batch, goes through as a Python int)
HOST_KEYS = ("fns", "ground_truth")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_concept_model(path: str, *, device="cuda"):
    """Concept checkpoint written by either package -> (params on
    ``device``, idx2concept, metadata)."""
    params, meta = ckpt.load(path, device=device)
    if "fc1" not in params:
        raise ckpt.CheckpointError(f"{path}: not a concept-detector "
                                   f"checkpoint (keys {sorted(params)})")
    return params, meta["idx2concept"], meta


def senti_word_ids(concepts, senti_table, vocab,
                   num_sentiments: int) -> np.ndarray:
    """Detected concepts -> ranked sentiment-word id row [num_sentiments]
    int32, PAD-padded (the per-image det_sentiments pipeline, reference
    preprocess.py:280-302, as caption and serve use it)."""
    from ..preprocessing import _rank_sentis
    words = _rank_sentis(concepts, senti_table)[:num_sentiments]
    row = np.full((num_sentiments,), vocab.pad_id, np.int32)
    ids = vocab.encode_filter(words)
    row[:len(ids)] = ids
    return row


# ---------------------------------------------------------------------------
# Artefacts and tokenization (reference train_xe.py:76-120)
# ---------------------------------------------------------------------------

def corpus_path(opt: Opts, *names):
    return os.path.join(opt.captions_dir, opt.dataset_name, opt.corpus_type,
                        *names)


def dataset_path(opt: Opts, *names):
    return os.path.join(opt.captions_dir, opt.dataset_name, *names)


def load_vocab(opt: Opts) -> Vocab:
    return Vocab(load_json(corpus_path(opt, "idx2word.json")))


def sniff_store_path(path: str) -> str:
    """The native (``.isc``) store at ``path``'s stem where one exists,
    else ``path`` itself (a reference ``.h5``, which ``open_store``
    refuses by name)."""
    stem, _ = os.path.splitext(path)
    return stem + ".isc" if os.path.exists(stem + ".isc") else path


def feature_paths(opt: Opts):
    """<feats_dir>/<ds>/<ds>_fc.isc and _att.isc (the reference's
    <ds>_fc.h5 layout, train_xe.py:122-123, in the native format; an .h5
    path is returned where only it exists, for ``open_store`` to refuse
    by name)."""
    base = os.path.join(opt.feats_dir, opt.dataset_name)
    out = []
    for kind in ("fc", "att"):
        stem = os.path.join(base, f"{opt.dataset_name}_{kind}")
        out.append(stem + ".h5" if not os.path.exists(stem + ".isc")
                   and os.path.exists(stem + ".h5") else stem + ".isc")
    return tuple(out)


def tokenize_captions(img_captions: Dict, vocab: Vocab) -> Dict:
    """{split: {fn: [[w..]..]}} -> ids with SOS/EOS (train_xe.py:81-94)."""
    return {split: {fn: [vocab.encode_caption(seq) for seq in seqs]
                    for fn, seqs in caps.items()}
            for split, caps in img_captions.items()}


def tokenize_concepts(img_det_concepts: Dict, vocab: Vocab) -> Dict:
    """Strict lookup (train_xe.py:97-100)."""
    return {fn: vocab.encode_strict(ws)
            for fn, ws in img_det_concepts.items()}


def tokenize_sentiments(img_det_sentiments: Dict, vocab: Vocab) -> Dict:
    """Filtered lookup (train_rl.py:126-131 indexes words already
    restricted to the vocabulary; the filter keeps it OOV-safe)."""
    return {fn: vocab.encode_filter(ws)
            for fn, ws in img_det_sentiments.items()}


def tokenize_senti_corpus(senti_captions: Dict, vocab: Vocab,
                          sentiment_categories,
                          upsample: bool = True) -> List:
    """-> [[cap_ids, cpt_ids, senti_ids, senti_label], ...] with the
    integer-ratio pos/neg upsampling (train_xe.py:102-120)."""
    if upsample:
        senti_captions = upsample_to_neutral(senti_captions)
    label2idx = {w: i for i, w in enumerate(sentiment_categories)}
    out = []
    for senti, caps in senti_captions.items():
        sid = label2idx[senti]
        for cap, cpts, sentis in caps:
            out.append([vocab.encode_caption(cap),
                        vocab.encode_filter(cpts),
                        vocab.encode_strict(sentis), sid])
    return out


def flatten_caption_items(captions_id: Dict, concepts_id: Dict) -> List:
    """One row per caption, images repeated (dataloader.py:164-181)."""
    return [(fn, cap, concepts_id[fn])
            for fn, caps in captions_id.items() for cap in caps]


# ---------------------------------------------------------------------------
# Runtime: the rank's device and process group, placement and dtype policy
# ---------------------------------------------------------------------------

def mesh_devices(mesh_shape) -> int:
    """The devices of a ``--mesh_shape``: () and (1,) one, (n,) n; a mesh
    of more than one axis exits with a message (the JAX package's 2-D
    ``data x model`` mesh is not ported)."""
    shape = tuple(mesh_shape or ())
    if len(shape) > 1:
        raise SystemExit(
            f"--mesh_shape {list(shape)}: the 2-D data x model mesh is not "
            "ported yet (it comes after sharded and multi-host serving); "
            "give a 1-D --mesh_shape [n] for data parallelism")
    return int(shape[0]) if shape else 1


def serving_world(processes: bool = False) -> int:
    """The processes a serving entry point runs in: the joined group's, or
    ``WORLD_SIZE`` (1 without either). Above 1 it exits with a message
    unless ``processes`` (``serve``, the one entry point with a mesh over
    processes)."""
    world = mesh.world_size() if mesh.initialized() \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not processes:
        raise SystemExit(
            f"WORLD_SIZE={world}: only serve runs a mesh over processes "
            "(multi-host serving, followers mirroring process 0); this "
            "entry point has no process-aware path, as in the JAX package: "
            "run it in one process")
    return world


def serving_mesh(mesh_shape, device, processes: bool = False):
    """The mesh of a serving entry point's ``--mesh_shape`` (None without
    one). In one process a ``DeviceMesh``: n devices of ``device``. Under
    a ``WORLD_SIZE`` above 1, for ``processes=True`` (``serve``), a
    ``ProcessMesh`` over the ranks (multi-host serving): the process joins
    the gloo group through ``env://`` as torchrun starts it (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or uses a group the
    caller joined (``mesh.init``), and drives n / WORLD_SIZE devices
    (``mesh.local_devices``). Exits with a message under a ``WORLD_SIZE``
    above 1 for the other entry points, without a ``--mesh_shape`` or a
    ``RANK`` there, where the processes do not divide n, for a mesh of
    more than one axis, and where fewer cards are visible than the
    process drives."""
    world = serving_world(processes)
    if not mesh_shape:
        if world > 1:
            raise SystemExit(
                f"WORLD_SIZE={world} but no --mesh_shape: multi-host serving "
                f"needs --mesh_shape '[n]', n a multiple of {world}")
        return None
    shape = tuple(mesh_shape)
    if len(shape) != 1:
        # serving only shards over `data`; a silent extra axis would
        # replicate all serving work across it
        raise SystemExit(
            f"--mesh_shape must be 1-D for serving (got {shape}); "
            f"use '[{int(np.prod(shape))}]'")
    if world == 1:
        return mesh.make_device_mesh(shape[0], device)
    if not mesh.initialized():
        if "RANK" not in os.environ:
            raise SystemExit(
                f"WORLD_SIZE={world} but RANK is unset: multi-host serving "
                "joins its group through env:// as torchrun starts a process "
                "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        rank = int(os.environ["RANK"])
        # the split and this process's cards, before any rank waits on it
        mesh.local_devices(shape[0], world,
                           int(os.environ.get("LOCAL_RANK", rank)), device)
        mesh.init(world, rank, "gloo", "env://")
        atexit.register(mesh.teardown)
    return mesh.make_process_mesh(shape[0], device)


class Runtime:
    """Device, process group and dtype policy for a CLI run: the card
    unless ``opt.device`` says cpu, float32 or bfloat16 compute.

    ``--mesh_shape [n]`` names n devices in all, and a process drives
    n / world size of them: a trainer's n ranks one device each, a
    serving entry point's one process all n.

    The trainers (``data_parallel=True``) train data-parallel over n
    ranks, launched as n processes by ``torchrun`` (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``): the rank's device is
    ``cuda:LOCAL_RANK`` (or the CPU under ``--device cpu``), its backend
    NCCL on the card and gloo on the CPU. A process group the caller
    joined already (``mesh.init``) is used as it is. Exits with a message
    where n disagrees with the world size, the mesh is not 1-D, or
    ``LOCAL_RANK`` has no card of its own. An explicit ``--mesh_shape
    [1]`` under torchrun joins a group of one rank; without a
    ``--mesh_shape`` the run is one process.

    The entry points that serve (``serving=True``: ``reproduce_table``)
    run in one process, rank 0 of 1, on ``self.mesh``, a
    ``parallel.mesh.DeviceMesh`` of n devices (``serving_mesh``: exits
    where fewer cards are visible), or on one device without a
    ``--mesh_shape``; ``self.device`` is the mesh's first device,
    ``replicate`` copies params to every device, and ``close()`` stops
    the mesh's workers. Under a ``WORLD_SIZE`` above 1 they exit with a
    message: only ``serve`` runs a mesh over processes (it calls
    ``serving_mesh`` itself), since the JAX package's ``reproduce_table``
    has no process-aware path.

    ``round_bs`` rounds a batch to a multiple of the n devices either
    way. For the other entry points (``unported``: why) a mesh of more
    than one device exits with a message."""

    def __init__(self, opt: Opts, data_parallel: bool = False,
                 serving: bool = False,
                 unported: str = "multi-device runs of this entry point "
                 "are not ported yet; run it on one device"):
        n = mesh_devices(opt.mesh_shape)
        if n > 1 and not (data_parallel or serving):
            raise SystemExit(f"--mesh_shape {list(opt.mesh_shape)}: "
                             f"{unported}; leave --mesh_shape unset")
        env_world = os.environ.get("WORLD_SIZE")
        self.opt = opt
        self.device = resolve_device(opt.device)
        self.mesh = None
        self.devices = n
        if serving:
            self.mesh = serving_mesh(opt.mesh_shape, self.device)
            if self.mesh is not None:
                self.device = self.mesh.devices[0]
        elif mesh.initialized():
            if mesh.world_size() != n:
                raise SystemExit(
                    f"--mesh_shape [{n}] disagrees with the process group's "
                    f"{mesh.world_size()} ranks")
        elif opt.mesh_shape and env_world is not None:
            self._join_env(n, int(env_world))
        elif n > 1:
            raise SystemExit(
                f"--mesh_shape [{n}]: launch {n} processes, e.g. torchrun "
                f"--nproc_per_node {n} -m <this module> --mesh_shape "
                f"'[{n}]' (WORLD_SIZE is unset)")
        elif env_world not in (None, "1"):
            raise SystemExit(
                f"WORLD_SIZE={env_world} but no --mesh_shape: give "
                f"--mesh_shape '[{env_world}]' to train data-parallel")
        self.ranks = mesh.world_size()
        self.dtype = torch.bfloat16 if opt.compute_dtype == "bfloat16" \
            else torch.float32
        group = f" over {mesh.backend()}" if mesh.initialized() else ""
        on = "" if self.mesh is None else f" (mesh {self.mesh})"
        print(f"====> device: {self.device}{on}, compute dtype "
              f"{opt.compute_dtype}, rank {mesh.rank()} of {self.ranks}"
              f"{group}")

    def _join_env(self, n: int, world: int) -> None:
        """Join torchrun's process group (``env://``) as rank RANK."""
        if world != n:
            raise SystemExit(f"--mesh_shape [{n}] disagrees with "
                             f"WORLD_SIZE={world}")
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if self.device.type == "cuda":
            cards = torch.cuda.device_count()
            if local >= cards:
                raise SystemExit(
                    f"LOCAL_RANK {local} has no card of its own ({cards} "
                    "visible): one rank a card, or --device cpu for gloo")
            torch.cuda.set_device(local)
            self.device = torch.device("cuda", local)
        mesh.init(n, rank, mesh.backend_for(self.device), "env://")
        atexit.register(mesh.teardown)

    def round_bs(self, bs: int) -> int:
        """The global batch size: ``bs`` rounded up to a multiple of the
        mesh's devices (a trainer's rank loads ``round_bs(bs) / ranks``
        rows a step; a serving mesh splits them over its devices)."""
        return -(-bs // self.devices) * self.devices

    def replicate(self, tree):
        """``tree`` copied to every device of the serving mesh
        (``Replicas``); ``tree`` itself without one."""
        return tree if self.mesh is None else self.mesh.replicate(tree)

    def close(self) -> None:
        """Stop the serving mesh's worker threads, if there is a mesh."""
        if self.mesh is not None:
            self.mesh.close()

    def put(self, batch: Dict) -> Dict:
        """Array values to the device (from pinned memory, not blocking,
        on the card), float ones cast to the compute dtype; host-only keys
        left out, ``valid`` kept as an int."""
        out = {}
        for k, v in batch.items():
            if k in HOST_KEYS:
                continue
            if k == "valid":
                out[k] = int(v)
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.dtype) if t.is_floating_point() else t
        return out

    def cast(self, tree):
        """Float32 leaves to the compute dtype."""
        return nn.tree_map(lambda t: t.to(self.dtype)
                           if t.dtype == torch.float32 else t, tree)


def start_training(rt: Runtime, params, lr: float, resume: str, validate):
    """The trainable params and their Adam for a stage: ``params`` (float32,
    from the stage's ``init_params``), or the checkpoint ``resume`` with
    its optimizer state and learning rate, which must have ``params``'
    structure and shapes and pass ``validate(metadata)``. The params are
    cast to the compute dtype, broadcast from rank 0 under data
    parallelism (``mesh.replicate``; a resume loads on every rank, and so
    do its Adam moments), and then require grad; Adam keeps float32
    moments. Returns (adam, lr, the first epoch to run)."""
    epoch0, opt_state = 0, None
    if resume:
        print(f"====> loading checkpoint '{resume}'")
        loaded, opt_state, meta = ckpt.load(
            resume, device=rt.device, dtype=torch.float32,
            with_opt_state=True)
        params = ckpt.match_tree(loaded, params, resume)
        validate(meta)
        lr = meta.get("lr", lr)
        epoch0 = meta["epoch"] + 1
        print(f"====> loaded checkpoint, epoch: {meta['epoch']}")
    params = nn.tree_map(lambda t: t.requires_grad_(True),
                         mesh.replicate(rt.cast(params)))
    adam = optim.Adam(params, lr, rt.opt.grad_clip)
    if opt_state is not None:
        optim.load_optax_state(adam, opt_state)
        mesh.replicate([adam.mu, adam.nu])
        optim.set_lr(adam, lr)
    return adam, lr, epoch0


def step_seed(seed: int, *keys: int) -> int:
    """The seed of a step's generator: ``step_seed(seed, epoch, i)`` for
    step i of an epoch (the RL stage adds its phase and pass)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


# ---------------------------------------------------------------------------
# Loader builders (the reference's get_*_dataloader factories,
# dataloader.py:275-370)
# ---------------------------------------------------------------------------

def host_shard():
    """This rank's item stripe, (rank, ranks), under data parallelism;
    None for one process. Every training loader takes it (the JAX
    package's ``host_shard`` on a 1-D mesh, cli/common.py:272-299)."""
    n = mesh.world_size()
    return (mesh.rank(), n) if n > 1 else None


def _loader(items, bs: int, fn, *, shuffle=True, drop_last=True, seed=0,
            stripe=None) -> Loader:
    """The Loader of a ``*_loader`` function: with ``stripe`` (training), this
    rank's stripe of the items in batches of ``bs / ranks`` rows, ``bs``
    being the global batch (``Runtime.round_bs``); else every item, in
    batches of ``bs``."""
    if stripe is not None:
        bs //= stripe[1]
    return Loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                  seed=seed, shard=stripe)


def caption_loader(fc_store, att_store, captions_id, concepts_id, vocab,
                   opt: Opts, bs: int, shuffle=True, drop_last=True,
                   seed=0) -> Loader:
    items = flatten_caption_items(captions_id, concepts_id)
    fn = functools.partial(collate.caption_batch,
                           max_seq_len=opt.max_seq_len,
                           num_concepts=opt.num_concepts, pad_id=vocab.pad_id,
                           fc_store=fc_store, att_store=att_store)
    return _loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, stripe=host_shard() if shuffle else None)


def scs_loader(senti_corpus_id, vocab, opt: Opts, bs: int, seed=0) -> Loader:
    fn = functools.partial(collate.scs_batch, max_seq_len=opt.max_seq_len,
                           num_concepts=opt.num_concepts,
                           num_sentiments=opt.num_sentiments,
                           pad_id=vocab.pad_id)
    return _loader(senti_corpus_id, bs, fn, seed=seed, stripe=host_shard())


def rl_fact_loader(fc_store, att_store, captions_id, concepts_id,
                   sentiments_id, vocab, opt: Opts, bs: int, fn2row=None,
                   shuffle=True, drop_last=True, seed=0) -> Loader:
    """One row an image, with its ground-truth captions and one of them,
    drawn by the collate's own generator (``collate.rl_fact_batch``),
    which the loader keeps as ``caption_rng`` (a resume replays its
    draws)."""
    items = [(fn, caps, concepts_id[fn], sentiments_id[fn])
             for fn, caps in captions_id.items()]
    rng = np.random.default_rng(seed)
    fn = functools.partial(collate.rl_fact_batch, max_seq_len=opt.max_seq_len,
                           num_concepts=opt.num_concepts,
                           num_sentiments=opt.num_sentiments,
                           pad_id=vocab.pad_id, fc_store=fc_store,
                           att_store=att_store, rng=rng, fn2row=fn2row)
    loader = _loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                     seed=seed, stripe=host_shard() if shuffle else None)
    loader.caption_rng = rng
    return loader


def rl_senti_loader(fc_store, att_store, senti_imgs, concepts_id,
                    sentiments_id, label2idx, vocab, opt: Opts, bs: int,
                    shuffle=True, drop_last=True, seed=0) -> Loader:
    """senti_imgs: [[fn, senti_name], ...] (an img_senti_labels.json
    split)."""
    items = [(fn, concepts_id[fn], sentiments_id[fn], label2idx[senti])
             for fn, senti in senti_imgs]
    fn = functools.partial(collate.rl_senti_batch,
                           num_concepts=opt.num_concepts,
                           num_sentiments=opt.num_sentiments,
                           pad_id=vocab.pad_id, fc_store=fc_store,
                           att_store=att_store)
    return _loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, stripe=host_shard() if shuffle else None)


def concept_loader(fc_store, items, num_total_concepts: int, bs: int,
                   shuffle=True, drop_last=True, seed=0) -> Loader:
    """items [(fn, [concept index, ...])] -> {fc, cpts (one-hot)}."""
    fn = functools.partial(collate.concept_batch,
                           num_total_concepts=num_total_concepts,
                           fc_store=fc_store)
    return _loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, stripe=host_shard() if shuffle else None)


def senti_image_loader(att_store, items, bs: int, shuffle=True,
                       drop_last=True, seed=0) -> Loader:
    """items [(fn, label)] -> {att, labels}."""
    fn = functools.partial(collate.senti_image_batch, att_store=att_store)
    return _loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, stripe=host_shard() if shuffle else None)


def senti_sents_loader(items, max_seq_len: int, pad_id: int, bs: int,
                       shuffle=True, drop_last=True, seed=0) -> Loader:
    """items [[label, ids]] -> {caps, lengths, labels}."""
    fn = functools.partial(collate.senti_sents_batch,
                           max_seq_len=max_seq_len, pad_id=pad_id)
    return _loader(items, bs, fn, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, stripe=host_shard() if shuffle else None)


def train_epoch(train_step, loader, rt: Runtime, seed: int,
                epoch: int) -> float:
    """A head stage's train pass over ``loader``: step i draws its dropout
    mask from a generator on the device seeded ``step_seed(seed, epoch,
    i)`` (alike on every rank); the losses, each the global batch's, are
    summed on the device in float64 and read once. Returns the mean loss,
    the same on every rank."""
    tot, n = 0.0, 0
    for i, b in enumerate(device_prefetch(loader, rt.put)):
        gen = torch.Generator(device=rt.device).manual_seed(
            step_seed(seed, epoch, i))
        tot = tot + train_step(b, gen).double()
        n += 1
    return float(tot) / max(n, 1)


def masked_mean(eval_step, loader, rt: Runtime) -> float:
    """A head stage's eval loss over a split: ``eval_step``'s masked sums
    and row counts, summed on the device and divided once, so that the
    eval loader's padding rows add nothing and the batching does not move
    the result. The eval loaders are not striped: every rank reads the
    whole split and gets the same loss, with no collective."""
    tot = cnt = 0.0
    for b in device_prefetch(loader, rt.put):
        s, c, _ = eval_step(b)
        tot, cnt = tot + s.double(), cnt + c.double()
    return float(tot) / max(float(cnt), 1.0)


# ---------------------------------------------------------------------------
# Results / checkpoints
# ---------------------------------------------------------------------------

def ensure_dir(path: str) -> str:
    """``path``, made on rank 0 (the one rank that writes files)."""
    if mesh.rank() == 0:
        os.makedirs(path, exist_ok=True)
    return path


def stage_dirs(opt: Opts, stage: str):
    ck = ensure_dir(os.path.join(opt.checkpoint, stage, opt.dataset_name,
                                 opt.corpus_type))
    rs = ensure_dir(os.path.join(opt.result_dir, stage, opt.dataset_name,
                                 opt.corpus_type))
    return ck, rs


def best_checkpoint(opt: Opts, stage: str) -> str:
    """<checkpoint>/<stage>/<ds>/<corpus>/model-best.ckpt (the reference
    picks the best by hand, train_xe.py:60), else the newest epoch
    checkpoint there."""
    d = os.path.join(opt.checkpoint, stage, opt.dataset_name, opt.corpus_type)
    best = os.path.join(d, "model-best.ckpt")
    if os.path.exists(best):
        return best
    cands = sorted((os.path.getmtime(os.path.join(d, f)),
                    os.path.join(d, f)) for f in os.listdir(d)
                   if f.endswith(".ckpt")) if os.path.isdir(d) else []
    if not cands:
        raise FileNotFoundError(f"no checkpoint under {d}")
    return cands[-1][1]


def dump_results(result_dir: str, tag: str, results: List[Dict],
                 vocab: Optional[Vocab] = None) -> None:
    """result_<tag>.json + .txt, and the id form .txt when ids are present
    (the input of eval_cls_rnn, reference train_rl.py:283-309); rank 0
    alone writes."""
    if mesh.rank() != 0:
        return
    with open(os.path.join(result_dir, f"result_{tag}.json"), "w") as f:
        json.dump([{"image_id": r["image_id"], "caption": r["caption"]}
                   for r in results], f)
    with open(os.path.join(result_dir, f"result_{tag}.txt"), "w") as f:
        f.write("".join(r["caption"] + "\n" for r in results))
    if results and "ids" in results[0]:
        with open(os.path.join(result_dir, f"result_{tag}_ids.txt"),
                  "w") as f:
            for r in results:
                f.write(" ".join(map(str, r["ids"])) + "\n")


def metrics_line(log_path: str, record: Dict) -> None:
    """One JSON line of metrics, written by rank 0 alone."""
    if mesh.rank() != 0:
        return
    with open(log_path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def run_with_post_mortem(fn, *args):
    """Run a trainer; under ISC_PDB=1 drop into pdb.post_mortem on a
    failure (the reference wraps every entry point so, train_xe.py:257-267;
    here opt-in, so unattended runs fail fast)."""
    if os.environ.get("ISC_PDB") != "1":
        return fn(*args)
    try:
        return fn(*args)
    except BaseException:
        import pdb
        import traceback
        traceback.print_exc()
        print("-" * 60)
        pdb.post_mortem()
        raise

"""Data-parallel ranks of the PyTorch port on the CPU, for the tests.

``run_ranks(fn, world, tmp_path, *args)`` spawns one process a rank
(``torch.multiprocessing``, the spawn method), joins them into a gloo
process group through a file under ``tmp_path`` (a file, not a port, so
that tests on parallel workers cannot clash), runs ``fn(rank, world,
*args)`` in each and returns the ranks' results in rank order. Each rank
is joined with a time limit: a rank that raises, dies or outlives the
limit fails the test and does not hang it.

The rank functions live here, so that a rank imports the port and not the
JAX package; each also runs in the test's own process with
``world=1`` and no process group, as the one-process reference.
"""
import builtins
import contextlib
import copy
import functools
import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 150.0


def _rank_main(rank, world, pg_file, out_dir, fn, args):
    torch.set_num_threads(1)
    from insenticap_model_tpu_torch.parallel import mesh
    try:
        mesh.init(world, rank, "gloo", "file://" + pg_file, timeout_s=120)
        result = fn(rank, world, *args)
        mesh.teardown()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world, tmp_path, *args, timeout=RANK_TIMEOUT_S):
    out = tmp_path / f"ranks_{fn.__name__}_{world}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(out / "pg"), str(out), fn, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errs = {r: (out / f"rank{r}.err").read_text() for r in range(world)
            if (out / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} ran past {timeout} s; errors: {errs}"
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    assert not bad, f"ranks exited with {bad}: {errs}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def tensors(tree, dtype=None):
    """A numpy tree -> CPU tensors (floats cast to ``dtype`` if given)."""
    if isinstance(tree, dict):
        return {k: tensors(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def numpy_tree(tree):
    """A tensor tree -> numpy, for passing to the ranks."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy().copy()


def _grads(params):
    """Each leaf's gradient (zeros for a leaf without one: the summed
    gradient of a leaf no rank reached)."""
    from insenticap_model_tpu_torch import nn
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for p in nn.tree_leaves(params)]


def _rows(batch, rank, world):
    """This rank's rows of a global numpy batch."""
    from insenticap_model_tpu_torch.parallel import mesh
    n = len(next(iter(batch.values())))
    sl = mesh.shard_rows(n, rank, world)
    return {k: v[sl] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def collectives(rank, world):
    """``replicate``, ``reduce_gradients`` (f32 and bf16 grads, a leaf
    without a grad on all ranks but 0; and with an f64 grad),
    ``all_reduce_sum``, ``rank_rows``, ``host_shard`` and the Runtime on
    the caller's group."""
    from insenticap_model_tpu_torch.cli import common
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.parallel import mesh
    g = torch.Generator().manual_seed(100 + rank)
    tree = {"a": torch.randn(3, 4, generator=g),
            "b": [torch.randn(5, generator=g).to(torch.bfloat16),
                  torch.arange(3) * (rank + 1)]}
    mesh.replicate(tree)
    out = {"tree": tree}
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        params = {"w": torch.zeros(4, 3, requires_grad=True),
                  "h": [torch.zeros(5, dtype=torch.bfloat16,
                                    requires_grad=True),
                        torch.zeros(2, dtype=dt, requires_grad=True)],
                  "z": torch.zeros(2, requires_grad=True)}
        leaves = [params["w"], *params["h"], params["z"]]
        for i, p in enumerate(leaves):
            if p is params["z"] and rank != 0:
                continue        # no grad on this rank: counts as zeros
            p.grad = grad_of(i, rank, p.shape, p.dtype)
        mesh.reduce_gradients(params)
        out[tag] = [None if p.grad is None else p.grad.clone()
                    for p in leaves]
    out["sum"] = mesh.all_reduce_sum(torch.tensor([rank + 1.0, 0.5]))
    out["sum_bf16"] = mesh.all_reduce_sum(
        torch.tensor([rank + 1.0, 0.5], dtype=torch.bfloat16))
    out["rank_rows"] = mesh.rank_rows(
        lambda n: torch.arange(2 * n).reshape(n, 2), 3)
    out["host_shard"] = common.host_shard()
    rt = common.Runtime(Opts(device="cpu", mesh_shape=(world,)),
                        data_parallel=True)
    out["round_bs"] = [rt.round_bs(b) for b in (5, 8, 1)]
    try:
        common.Runtime(Opts(device="cpu", mesh_shape=(world + 1,)),
                       data_parallel=True)
    except SystemExit as e:
        out["exit"] = str(e)
    mesh.barrier()
    return out


def grad_of(i, rank, shape, dtype):
    """Rank ``rank``'s gradient of leaf ``i`` in ``collectives``."""
    g = torch.Generator().manual_seed(1000 * i + rank)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def xe_steps(rank, world, params_np, cls_np, batches, settings_dict,
             ss_prob, dtype, lr):
    """The port's XE train step on this rank's rows of each global
    (batch, scs_batch), step i's generator seeded i on every rank ->
    {losses, grads (the reduced gradient of each step), params}."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.training import optim, steps
    params = nn.tree_map(lambda x: x.requires_grad_(True),
                         tensors(params_np, dtype))
    cls = tensors(cls_np, dtype)
    adam = optim.Adam(params, lr)
    train_step, _ = steps.make_xe_steps(Settings.from_dict(settings_dict),
                                        adam)
    out = {"losses": [], "grads": []}
    for i, (b, scs) in enumerate(batches):
        losses = train_step(cls, tensors(_rows(b, rank, world), dtype),
                            tensors(_rows(scs, rank, world), dtype),
                            torch.Generator().manual_seed(i), ss_prob)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["grads"].append(_grads(params))
    out["params"] = numpy_tree(params)
    return out


# the conftest vocabulary's special ids (``torch_parity.JIDS``)
RL_IDS = dict(pad=0, unk=1, sos=2, eos=3, neutral=2)


def _rl_tables(corpus, max_seq_len):
    """The port's CIDEr-D tables of ``corpus`` ({fn: [caption ids]}; row i
    the i-th fn), built in the rank from the same data, as every rank of
    ``train_rl`` builds them."""
    from insenticap_model_tpu_torch.ops import ciderd_device as tcd
    from insenticap_model_tpu_torch.rewards.ciderd import build_scorer
    sos, eos = RL_IDS["sos"], RL_IDS["eos"]
    tables, _ = tcd.build_tables(build_scorer({"train": corpus}, sos, eos),
                                 corpus, list(corpus), max_seq_len, sos,
                                 eos)
    return tables


@contextlib.contextmanager
def _rl_draws(gumbel, ss_probs):
    """The RL step's draws for a block: with ``gumbel`` every categorical
    draw forced to argmax(logprobs + G), G's rows those of the global
    batch (``mesh.rank_rows``); with ``ss_probs`` the two
    scheduled-sampling probabilities (xe, seq2seq) in place of the
    step's. Restored on exit."""
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.parallel import mesh
    from insenticap_model_tpu_torch.training import steps
    saved = cap._categorical, steps.RL_XE_SS_PROB, steps.RL_SEQ_SS_PROB
    if gumbel is not None:
        g = torch.from_numpy(gumbel)

        def forced(gen, logprobs):
            rows = mesh.rank_rows(lambda n: g[:n], logprobs.shape[0])
            return (logprobs.float() + rows).argmax(dim=-1)
        cap._categorical = forced
    if ss_probs is not None:
        steps.RL_XE_SS_PROB, steps.RL_SEQ_SS_PROB = ss_probs
    try:
        yield
    finally:
        cap._categorical, steps.RL_XE_SS_PROB, steps.RL_SEQ_SS_PROB = saved


def _rl_setup(spec, dtype):
    """(params, the RL steps on them, the frozen models) of an
    ``rl_steps`` or ``rl_eval`` spec, in ``dtype``."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.ops import lm_device
    from insenticap_model_tpu_torch.training import optim, steps
    params = nn.tree_map(lambda x: x.requires_grad_(True),
                         tensors(spec["params"], dtype))
    lm = None
    if spec.get("lm_paths"):
        lm = lm_device.build_lm_tables(spec["lm_paths"], spec["vocab"])
    rl = steps.make_rl_steps(
        Settings.from_dict(spec["settings"]),
        optim.Adam(params, spec.get("lr", 1e-3)),
        cap.TokenIds(**RL_IDS), spec["max_seq_len"],
        _rl_tables(spec["corpus"], spec["max_seq_len"]), lm_tables=lm,
        lm_flag=spec.get("lm_flag", 0.0))
    frozen = steps.RLModels(*(tensors(t, dtype) for t in spec["frozen"]))
    return params, rl, frozen


def rl_steps(rank, world, spec):
    """The port's RL train step (``spec["data_type"]``: fact or senti) on
    this rank's rows of each global (batch, scs_batch) of
    ``spec["batches"]``, step i's generator seeded i on every rank ->
    {losses, grads (the reduced gradient of each step), params}.

    spec: params, frozen (the detector's and the classifier's numpy
    trees), corpus (the CIDEr-D tables' {fn: [caption ids]}), settings
    (a dict), dtype, lr, max_seq_len; optional lm_paths, vocab and
    lm_flag (the LM reward), gumbel (every draw forced) and ss_probs."""
    dtype = spec["dtype"]
    with _rl_draws(spec.get("gumbel"), spec.get("ss_probs")):
        params, rl, frozen = _rl_setup(spec, dtype)
        step = rl[(spec["data_type"], True)]
        out = {"losses": [], "grads": []}
        for i, (b, scs) in enumerate(spec["batches"]):
            losses = step(frozen, tensors(_rows(b, rank, world), dtype),
                          tensors(_rows(scs, rank, world), dtype),
                          torch.Generator().manual_seed(i))
            out["losses"].append({k: float(v) for k, v in losses.items()})
            out["grads"].append(_grads(params))
    out["params"] = numpy_tree(params)
    return out


def rl_eval(rank, world, spec):
    """The RL fact eval step on the whole of ``spec["batch"]`` on every
    rank (the val pass is not striped), the real sampler, generator
    seeded 0 -> {"sums", "counts"} as floats, and ``mesh.rank_rows`` of
    ``arange`` (3 local rows) outside ``whole_batch``, inside it, and
    after a block left by an exception."""
    from insenticap_model_tpu_torch.parallel import mesh
    dtype = spec["dtype"]
    _, rl, frozen = _rl_setup(spec, dtype)
    sums, counts = rl[("fact", False)](frozen, tensors(spec["batch"], dtype),
                                       torch.Generator().manual_seed(0))

    def draw():
        return mesh.rank_rows(lambda n: torch.arange(n), 3).tolist()
    marks = [draw()]
    with mesh.whole_batch():
        marks.append(draw())
    try:
        with mesh.whole_batch():
            raise KeyError("left")
    except KeyError:
        pass
    marks.append(draw())
    return {"sums": {k: float(v) for k, v in sums.items()},
            "counts": {k: float(v) for k, v in counts.items()},
            "rank_rows": marks}


def head_steps(rank, world, stage, params_np, batches, settings_dict,
               dtype, lr):
    """A head stage's train step (``stage``: concept, senti or cls) on
    this rank's rows of each global batch -> {losses, grads, params}."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.training import optim, steps
    params = nn.tree_map(lambda x: x.requires_grad_(True),
                         tensors(params_np, dtype))
    adam = optim.Adam(params, lr)
    make = {"concept": steps.make_concept_steps,
            "senti": steps.make_senti_steps, "cls": steps.make_cls_steps}
    train_step, _ = make[stage](Settings.from_dict(settings_dict), adam)
    out = {"losses": [], "grads": []}
    for i, b in enumerate(batches):
        loss = train_step(tensors(_rows(b, rank, world), dtype),
                          torch.Generator().manual_seed(i))
        out["losses"].append(float(loss))
        out["grads"].append(_grads(params))
    out["params"] = numpy_tree(params)
    return out


@contextlib.contextmanager
def watch_writes(root):
    """Record the files and directories opened for writing or made under
    ``root`` (``open`` in a writing mode, ``os.makedirs``,
    ``os.replace``)."""
    seen = []
    root = str(root)
    orig = builtins.open, os.makedirs, os.replace

    def under(p):
        return str(os.path.abspath(os.fspath(p))).startswith(root)

    def open_(file, mode="r", *a, **k):
        if isinstance(file, (str, os.PathLike)) and \
                set(mode) & set("wax+") and under(file):
            seen.append(os.fspath(file))
        return orig[0](file, mode, *a, **k)

    def makedirs(p, *a, **k):
        if under(p) and not os.path.isdir(p):
            seen.append(os.fspath(p))
        return orig[1](p, *a, **k)

    def replace(src, dst, *a, **k):
        if under(dst):
            seen.append(os.fspath(dst))
        return orig[2](src, dst, *a, **k)

    builtins.open, os.makedirs, os.replace = open_, makedirs, replace
    try:
        yield seen
    finally:
        builtins.open, os.makedirs, os.replace = orig


def cli_runs(rank, world, root, runs, patches=()):
    """Run each (module name, Opts keywords) of ``runs`` with
    ``--mesh_shape [world]`` on the CPU, each (module name, attribute,
    value) of ``patches`` set first -> {"params": [each run's trained
    params as numpy], "writes": the files a rank other than 0 opened for
    writing under ``root``}."""
    import glob
    import importlib
    from insenticap_model_tpu_torch.config import Opts, Settings
    for name, attr, value in patches:
        setattr(importlib.import_module(
            f"insenticap_model_tpu_torch.cli.{name}"), attr, value)
    out = {"params": [], "writes": []}
    for name, kw in runs:
        mod = importlib.import_module(f"insenticap_model_tpu_torch.cli.{name}")
        # "glob:<pattern>": the one file an earlier run wrote there
        kw = {k: sorted(glob.glob(v[5:]))[0]
              if isinstance(v, str) and v.startswith("glob:") else v
              for k, v in kw.items()}
        kw = dict(kw, settings=Settings.from_dict(kw["settings"]),
                  mesh_shape=(world,), device="cpu")
        with watch_writes(root) as seen:
            params = mod.train(Opts(**kw))
        out["params"].append(numpy_tree(params))
        if rank != 0:
            out["writes"] += seen
    return out


class GlobalLoader:
    """The one-process reference of the striped loaders: step i's batch is
    the ranks' step-i batches concatenated in rank order (each rank's
    ``Loader`` over its stripe, as ``cli/common`` builds it)."""

    def __init__(self, loaders):
        self.loaders = loaders
        self.items = loaders[0].items

    def __len__(self):
        return len(self.loaders[0])

    def _index_batches(self):
        return list(zip(*[ld._index_batches() for ld in self.loaders]))

    def advance(self, passes):
        for ld in self.loaders:
            ld.advance(passes)

    def assemble(self, parts):
        outs = [ld.assemble(b) for ld, b in zip(self.loaders, parts)]
        return {k: (sum(o[k] for o in outs) if k == "valid" else
                    [x for o in outs for x in o[k]]
                    if isinstance(outs[0][k], list) else
                    {x: v for o in outs for x, v in o[k].items()}
                    if isinstance(outs[0][k], dict) else
                    np.concatenate([o[k] for o in outs]))
                for k in outs[0]}

    def iterate(self, limit=None):
        for parts in self._index_batches()[:limit]:
            yield self.assemble(parts)

    def __iter__(self):
        return self.iterate()


def global_loaders(monkeypatch, common, world):
    """Make ``common``'s training loaders (one process) the
    ``GlobalLoader`` of ``world`` ranks' stripes. A collate that draws
    from a generator of its own (``rng``, the RL fact loader's caption
    draws) gets a copy a stripe, as each rank has its own."""
    orig = common._loader

    def own_rng(fn):
        if not isinstance(fn, functools.partial) or "rng" not in fn.keywords:
            return fn
        return functools.partial(fn.func, *fn.args, **dict(
            fn.keywords, rng=copy.deepcopy(fn.keywords["rng"])))

    def loader(items, bs, fn, *, shuffle=True, drop_last=True, seed=0,
               stripe=None):
        if not shuffle:
            return orig(items, bs, fn, shuffle=False, drop_last=drop_last,
                        seed=seed)
        return GlobalLoader([orig(items, bs, own_rng(fn), shuffle=True,
                                  drop_last=drop_last, seed=seed,
                                  stripe=(r, world))
                             for r in range(world)])
    monkeypatch.setattr(common, "_loader", loader)


def sequence(rank, world, calls):
    """Each (rank function, args) of ``calls`` in turn on one group ->
    their results (one spawn of the ranks for several checks)."""
    return [fn(rank, world, *args) for fn, args in calls]


# ---------------------------------------------------------------------------
# multi-host serving (serving/multihost.py)
# ---------------------------------------------------------------------------

def _submit_threads(submit, requests):
    """``submit(request)`` for every request, each from a thread of its
    own, all at once -> the answers in request order (an exception where
    one raised)."""
    import threading
    out = [None] * len(requests)

    def go(i):
        try:
            out[i] = submit(requests[i])
        except Exception as e:  # noqa: BLE001 — returned to the test
            out[i] = e
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(requests))]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=RANK_TIMEOUT_S)
    return out


def _counted(module, name, counts):
    """Wrap ``module.name`` so that each call adds its first argument after
    the batcher to ``counts[name]`` (the opcode of a control vector, the
    stripe of a run)."""
    real = getattr(module, name)
    counts[name] = []

    def wrapped(b, first, *a, **k):
        counts[name].append(first)
        return real(b, first, *a, **k)
    setattr(module, name, wrapped)


def multihost_daemon(rank, world, spec):
    """A ``DynamicBatcher`` on a mesh of ``spec["n"]`` CPU devices over the
    ``world`` ranks (``mesh.make_process_mesh``; with ``world=1`` and no
    group a one-process ``DeviceMesh`` of n slots, the reference). Process
    0 warms (``spec["warm"]``), submits ``spec["requests"]`` from
    concurrent threads and closes twice, after ``spec["idle_s"]`` seconds
    of idleness where given; the others try ``submit``, then mirror from
    ``follower_loop``. With ``idle_s`` the data group takes
    ``spec["timeout_s"]``, and a follower first waits that long on a probe
    group of the same timeout that process 0 never sends on (the premise:
    such a wait times out). With ``fail_follower`` the followers' stripes
    raise, and process 0 records what its requests and its close get."""
    import datetime

    import torch.distributed as dist

    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.models.captioner import TokenIds
    from insenticap_model_tpu_torch.parallel import mesh
    from insenticap_model_tpu_torch.serving import multihost
    from insenticap_model_tpu_torch.serving_daemon import DynamicBatcher

    counts = {}
    for name in ("send_control", "run_stripe"):
        _counted(multihost, name, counts)
    if world > 1:
        mesh.barrier()
        pm = mesh.make_process_mesh(spec["n"], "cpu",
                                    timeout_s=spec.get("timeout_s", 120.0))
    else:
        pm = mesh.make_device_mesh(spec["n"], "cpu")
    out = {}
    try:
        b = DynamicBatcher(
            tensors(spec["cap"]), tensors(spec["det"]),
            settings=Settings.from_dict(spec["settings"]),
            ids=TokenIds(*spec["ids"]), beam_size=spec["beam"],
            max_seq_len=spec["T"], bucket_sizes=spec["buckets"],
            max_wait_s=0.25, num_sentiments=spec["M"], device="cpu",
            compute_dtype=spec.get("dtype", "float32"), mesh=pm)
        if spec.get("idle_s"):
            probe = dist.new_group(backend="gloo", timeout=datetime.timedelta(
                seconds=spec["timeout_s"]))
        if rank != 0:
            if spec.get("idle_s"):
                t0 = time.monotonic()
                try:
                    dist.broadcast(torch.zeros(1), 0, group=probe)
                    out["probe_timed_out"] = False
                except RuntimeError:
                    out["probe_timed_out"] = True
                out["probe_s"] = time.monotonic() - t0
            req = spec["requests"][0]
            try:
                b.submit(req[0], req[1], req[2], forced_label=req[3])
                out["submit_raised"] = ""
            except RuntimeError as e:
                out["submit_raised"] = str(e)
            if spec.get("fail_follower"):
                def fault(*a, **k):
                    raise RuntimeError("device fault in a follower")
                multihost.run_stripe = fault
            t0 = time.monotonic()
            try:
                b.follower_loop()      # returns after process 0's STOP
            except RuntimeError as e:
                out["loop_error"] = str(e)
            out.update(loop_s=time.monotonic() - t0, closed=b._closed,
                       stripes=len(counts["run_stripe"]))
            return out
        if spec.get("idle_s"):
            time.sleep(spec["idle_s"])
        if spec.get("warm"):
            b.warm()
        answers = _submit_threads(
            lambda r: b.submit(r[0], r[1], r[2], forced_label=r[3],
                               timeout=RANK_TIMEOUT_S), spec["requests"])
        stats = b.stats()
        try:
            b.close()
            b.close()                  # sends no second STOP
        except RuntimeError as e:      # a follower gone: STOP cannot go
            out["close_error"] = str(e)
        ops = counts["send_control"]
        from insenticap_model_tpu_torch.serving.multihost import MP_STOP
        out.update(answers=answers, batches=stats["batches"],
                   failed=stats["failed_requests"], buckets=b._buckets,
                   stops=sum(op == MP_STOP for op in ops),
                   dispatches=sum(op != MP_STOP for op in ops),
                   stripes=len(counts["run_stripe"]))
        return out
    finally:
        pm.close()


def multihost_serve(rank, world, argv, payloads):
    """``cli/serve.py`` on a mesh over the ``world`` ranks: process 0 builds
    the ``ServeApp`` and answers ``payloads`` one after another, then
    closes it; the others run ``serve.main(argv)``, whose follower branch
    returns after process 0's close (its print-outs captured). Counts
    ``DynamicBatcher.warm`` calls and the stripes each process ran."""
    import io
    from contextlib import redirect_stdout

    from insenticap_model_tpu_torch.cli import serve
    from insenticap_model_tpu_torch.parallel import mesh
    from insenticap_model_tpu_torch.serving import multihost
    from insenticap_model_tpu_torch.serving_daemon import DynamicBatcher

    counts = {}
    _counted(multihost, "run_stripe", counts)
    real_warm = DynamicBatcher.warm
    counts["warm"] = 0

    def warm(self, *a, **k):
        counts["warm"] += 1
        return real_warm(self, *a, **k)
    DynamicBatcher.warm = warm
    mesh.barrier()
    if rank != 0:
        buf = io.StringIO()
        with redirect_stdout(buf):
            serve.main(argv)
        return {"stdout": buf.getvalue(), "warms": counts["warm"],
                "stripes": len(counts["run_stripe"])}
    app = serve.ServeApp(serve.build_parser().parse_args(argv))
    try:
        answers = {k: app.handle_caption(p) for k, p in payloads.items()}
        info = {"buckets": app.batcher._buckets,
                "enc_buckets": app.enc_batcher._batch_buckets,
                "enc_mesh": app.enc_batcher._mesh,
                "is_follower": app.is_follower}
    finally:
        app.close()
    return dict(info, answers=answers, warms=counts["warm"],
                stripes=len(counts["run_stripe"]))

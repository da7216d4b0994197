"""Data parallelism, two ways: over ``torch.distributed`` (one process a
rank, for training) and over a ``DeviceMesh`` (one process driving n
devices, for serving).

Counterpart of ``insenticap_model_tpu/parallel/mesh.py`` (:31-75) for its
``data`` story, the production default there: where the JAX package
shards a batch over a 1-D ``data`` mesh and lets XLA insert the gradient
all-reduce, each rank here runs the step on its own rows and the
collectives are explicit:

  ``init`` / ``teardown``   the process group; the backend is named by
                            the caller (``backend_for``: ``nccl`` for a
                            CUDA device, ``gloo`` for the CPU) and no
                            other is tried when it fails
  ``rank`` / ``world_size`` 0 and 1 without a process group
  ``replicate``             rank 0's leaves broadcast to every rank
  ``shard_rows``            rank r's block of a global batch's rows
  ``rank_rows``             a draw of the global batch, rank r's block
                            (dropout masks, scheduled-sampling coins and
                            sampling uniforms: every rank seeds the same
                            generator, so row i of the global batch gets
                            the draw it gets in one process)
  ``whole_batch``           marks the draws inside it as those of a pass
                            that every rank runs whole (an unstriped eval
                            pass): ``rank_rows`` then draws the rank's
                            rows alone, as one process does
  ``reduce_gradients``      every leaf's ``.grad`` summed over the ranks
  ``all_reduce_sum``        one tensor summed over the ranks
  ``barrier``

Each collective is the identity, and issues none, when the world size is
1.

Serving needs no collective: a row's beam never reads another row. Where
the JAX package runs its serving programs under ``jax.shard_map``
(params replicated, the batch's rows split over ``data``, each device
running the single-device program on its block), one process here drives
every device of a ``DeviceMesh`` (``make_device_mesh``):

  ``DeviceMesh.replicate``   a param tree copied to each device
                             (``Replicas``)
  ``DeviceMesh.shard_batch`` a batch's rows in n equal blocks, block i on
                             device i (``Shards``)
  ``DeviceMesh.run``         a callable on every block, each on a worker
                             thread of its device's own
  ``shard_map``              a single-device function made a sharded one
                             (in_specs ``P()`` for the params and
                             ``P("data")`` for the batch, out_specs
                             ``P("data")``)
  ``join``                   blocks concatenated in row order

The worker threads are persistent, one a device, each with its CUDA
device set once: ``ops/beam.py`` syncs the host on every decode step, so
one host thread would run the blocks one after another, and PyTorch keeps
its cuBLAS handles and current device per thread.

A serving mesh may also span processes (multi-host serving, the JAX
package's mesh over ``jax.process_count()`` processes):
``make_process_mesh`` gives a ``ProcessMesh`` of n devices over the w
ranks of the process group, each rank driving a ``DeviceMesh`` of its
n / w devices (``cuda:LOCAL_RANK*(n/w)`` and the ones after it, or n / w
CPU slots) and serving rows ``shard_rows(bucket, rank, w)`` of every
batch, which its local mesh splits further, so that the rows come back in
global device order (JAX's process-major mesh). Serving moves host data
only, so its two groups are gloo whatever the device (two ranks may then
share one card, which NCCL refuses): ``control`` for the control vector,
with a timeout that no idle daemon reaches, and ``data`` for the batches
and results, with the caller's (``serving/multihost.py``).

The 2-D ``data x model`` mesh (``captioner_shardings``, :79-103) is not
ported: ``cli/common.mesh_devices`` refuses a mesh of more than one axis.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import contextvars
import datetime
import os
from typing import Callable, Iterator, List, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# set inside ``whole_batch`` only (a context variable: each thread and
# task has its own, and the block's exit restores it)
_WHOLE_BATCH = contextvars.ContextVar("whole_batch", default=False)


def backend_for(device) -> str:
    """The backend of a rank whose tensors live on ``device``."""
    return BACKENDS[torch.device(device).type]


def init(world_size: int, rank: int, backend: str,
         init_method: str = "env://", timeout_s: float = 1800.0) -> None:
    """Join the process group of ``world_size`` ranks as ``rank``
    (``init_method``: ``env://`` under torchrun, ``file://`` or
    ``tcp://`` otherwise)."""
    if backend not in BACKENDS.values():
        raise ValueError(f"backend {backend!r}: one of "
                         f"{sorted(BACKENDS.values())}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def teardown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> str:
    """The process group's backend ("" without one)."""
    return str(dist.get_backend()) if initialized() else ""


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def shard_rows(global_rows: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch: ``[r*b, (r+1)*b)`` with
    ``b = global_rows / world`` (the global batch is the ranks' batches
    concatenated in rank order)."""
    if global_rows % world:
        raise ValueError(f"{global_rows} rows do not split over {world} "
                         "ranks")
    b = global_rows // world
    return slice(rank * b, (rank + 1) * b)


def rank_rows(draw: Callable[[int], torch.Tensor],
              local_rows: int) -> torch.Tensor:
    """``draw(rows)`` -> a tensor of ``rows`` leading rows; returns this
    rank's block of ``draw(local_rows * world)``, so that a draw from a
    generator seeded alike on every rank gives each row the value it
    gets in one process. Inside ``whole_batch`` (every rank holds the
    whole batch) it returns ``draw(local_rows)``."""
    w = world_size()
    if w == 1 or _WHOLE_BATCH.get():
        return draw(local_rows)
    return draw(local_rows * w)[shard_rows(local_rows * w, rank(), w)]


@contextlib.contextmanager
def whole_batch() -> Iterator[None]:
    """Mark the draws inside the block as those of a pass that every rank
    runs on the same whole batch (an unstriped eval pass): each rank then
    draws what one process draws, not its block of a global batch n
    times larger."""
    token = _WHOLE_BATCH.set(True)
    try:
        yield
    finally:
        _WHOLE_BATCH.reset(token)


@torch.no_grad()
def replicate(tree):
    """Broadcast every leaf of ``tree`` from rank 0, in place, in
    ``nn.tree_leaves`` order; returns ``tree``."""
    if world_size() > 1:
        from .. import nn
        for t in nn.tree_leaves(tree):
            dist.broadcast(t, src=0)
    return tree


def _sum_dtype(dtypes) -> torch.dtype:
    """float64 where any operand is, else float32 (bf16 and f16 sum in
    f32)."""
    return torch.float64 if torch.float64 in dtypes else torch.float32


@torch.no_grad()
def reduce_gradients(params) -> None:
    """Sum every leaf's ``.grad`` over the ranks, as one flat buffer in
    ``nn.tree_leaves`` order (float32, or float64 where a gradient is),
    each leaf's sum cast back to its type. A leaf without a gradient
    counts as zeros, so that every rank issues the same collective."""
    if world_size() == 1:
        return
    from .. import nn
    leaves = nn.tree_leaves(params)
    dtype = _sum_dtype({p.grad.dtype for p in leaves if p.grad is not None})
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p))
        .reshape(-1).to(dtype) for p in leaves])
    dist.all_reduce(flat)
    off = 0
    for p in leaves:
        n = p.numel()
        p.grad = flat[off:off + n].view(p.shape).to(p.dtype)
        off += n


@torch.no_grad()
def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the ranks (in float32, or float64, then cast
    back), as a new tensor; ``tensor`` itself with one rank."""
    if world_size() == 1:
        return tensor
    buf = tensor.to(_sum_dtype({tensor.dtype}), copy=True)
    dist.all_reduce(buf)
    return buf.to(tensor.dtype)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# One process, n devices: the serving mesh
# ---------------------------------------------------------------------------

class Shards(tuple):
    """A batch's rows in blocks, block i on the mesh's device i, in row
    order: the port's counterpart of an array sharded over ``data``."""


class Replicas:
    """A param tree copied to each device of a mesh: ``trees[i]`` on
    ``devices[i]`` (a device that the mesh names twice holds one copy)."""

    def __init__(self, devices: Sequence[torch.device], trees: Sequence):
        self.devices = tuple(devices)
        self.trees = tuple(trees)

    def on(self, device):
        """The copy on ``device``."""
        return self.trees[self.devices.index(_device(device))]

    def map(self, fn: Callable) -> "Replicas":
        """``fn`` on each copy, once a copy (the bf16 cast of a device's
        params, say)."""
        done = {}
        for t in self.trees:
            if id(t) not in done:
                done[id(t)] = fn(t)
        return Replicas(self.devices, [done[id(t)] for t in self.trees])


def _device(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device without an index given the
    current one (a tensor's device always has its index)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _to(tree, device):
    """Every tensor of a dict/list/tuple tree moved to ``device``, the
    containers' types kept (a ``ServingParams`` stays one)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def _bind(device: torch.device) -> None:
    """A mesh worker's start: its CUDA device set once, for good."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class DeviceMesh:
    """An ordered tuple of devices that one process drives, each from a
    persistent worker thread of its own (started at its first work, its
    CUDA device set then). The tuple may name a device more than once
    (``["cpu"] * n`` in the tests, ``cuda:0`` twice on a one-card
    machine): each entry is a device of the mesh, with its own thread and
    its own block of every batch. Callers that build a mesh close it."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a device mesh needs at least one device")
        self._pools = [concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix=f"isc-mesh-{i}", initializer=_bind,
            initargs=(d,)) for i, d in enumerate(self.devices)]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"

    def replicate(self, tree) -> Replicas:
        """``tree`` copied to every device of the mesh (leaves already on
        a device are not copied there)."""
        if isinstance(tree, Replicas):
            if tree.devices != self.devices:
                raise ValueError(f"replicas on {tree.devices}, not on "
                                 f"{self.devices}")
            return tree
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = _to(tree, d)
        return Replicas(self.devices, [copies[d] for d in self.devices])

    def shard_batch(self, x) -> Shards:
        """The rows of ``x`` (a tensor or a host array) in ``size`` equal
        blocks, block i moved to device i. Rows that are not a multiple
        of the mesh's size raise ValueError."""
        if isinstance(x, Shards):
            if len(x) != self.size:
                raise ValueError(f"{len(x)} blocks for a mesh of "
                                 f"{self.size}")
            return x
        t = torch.as_tensor(x)
        rows = t.shape[0]
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split into {self.size} "
                             "equal blocks over the mesh's devices")
        b = rows // self.size
        return Shards(t[i * b:(i + 1) * b].to(d)
                      for i, d in enumerate(self.devices))

    def run(self, fn: Callable, *per_device: Sequence) -> List:
        """``fn(args[0][i], args[1][i], ...)`` for every device i, each on
        device i's worker thread, under the caller's grad mode. Returns
        the results in device order once every worker has finished; where
        a worker raised, the first such exception (in device order)
        raises here and no result comes back."""
        grad = torch.is_grad_enabled()

        def call(*args):
            with torch.set_grad_enabled(grad):
                return fn(*args)
        futures = [pool.submit(call, *(a[i] for a in per_device))
                   for i, pool in enumerate(self._pools)]
        concurrent.futures.wait(futures)
        return [f.result() for f in futures]

    def close(self) -> None:
        """Stop the worker threads (after the work they hold)."""
        for pool in self._pools:
            pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def make_device_mesh(n: int, device="cuda") -> DeviceMesh:
    """A mesh of ``n`` devices: ``cuda:0`` to ``cuda:n-1``, or n slots of
    the CPU (the counterpart of the JAX tests' forced host devices) for
    ``device="cpu"``. Where fewer cards are visible it exits with a
    message: it never shrinks ``n`` and never moves to the CPU."""
    from ..utils.dtypes import resolve_device
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"a mesh of {n} devices")
    if dev.type == "cpu":
        return DeviceMesh([dev] * n)
    visible = torch.cuda.device_count()
    if n > visible:
        raise SystemExit(
            f"--mesh_shape [{n}] needs {n} cards in this process, and "
            f"{visible} {'is' if visible == 1 else 'are'} visible ("
            + ", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}"
                        for i in range(visible)) + ")")
    return DeviceMesh([torch.device("cuda", i) for i in range(n)])


def join(shards: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Blocks concatenated in row order on ``device`` (the first block's
    by default)."""
    device = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(device) for s in shards])


def shard_map(fn: Callable, mesh: DeviceMesh) -> Callable:
    """``fn(params, *batch)``, a single-device function, made a sharded
    one over ``mesh``: the returned function takes the params (``Replicas``
    of the mesh, or a tree it replicates at each call) and batch arguments
    (tensors, host arrays or ``Shards``), runs ``fn`` on every device's
    copy and blocks, and returns each output as ``Shards`` where the
    batch came as ``Shards``, else joined in row order on the first batch
    argument's device. The port's ``jax.shard_map`` with in_specs
    ``(P(), P("data"), ...)`` and out_specs ``P("data")``."""
    def sharded(params, *batch):
        reps = mesh.replicate(params)
        blocks = [mesh.shard_batch(x) for x in batch]
        outs = mesh.run(fn, reps.trees, *blocks)
        single = not isinstance(outs[0], tuple)
        cols = [Shards(o if single else o[k] for o in outs)
                for k in range(1 if single else len(outs[0]))]
        if not any(isinstance(x, Shards) for x in batch):
            home = torch.as_tensor(batch[0]).device
            cols = [join(c, home) for c in cols]
        return cols[0] if single else tuple(cols)
    return sharded


# ---------------------------------------------------------------------------
# A serving mesh over processes
# ---------------------------------------------------------------------------

# The control group's timeout. A follower waits on the control vector for
# as long as process 0 receives no request, which may be hours, so the
# wait must outlast any idle time: ten years is beyond any daemon's life,
# and within what gloo's clocks hold. A dead process 0 still ends the wait
# at once, as its sockets close.
CONTROL_TIMEOUT_S = 10 * 365 * 86400.0


class ProcessMesh:
    """A serving mesh of ``size`` devices over the ``world`` processes of
    the process group: this process, rank ``rank``, drives ``local`` (a
    ``DeviceMesh`` of size / world devices, ``devices``) and serves rows
    ``shard_rows(bucket, rank, world)`` of every batch. ``control`` and
    ``data`` are its gloo groups (``make_process_mesh``). Callers that
    build one close it."""

    def __init__(self, local: DeviceMesh, rank: int, world: int,
                 control=None, data=None):
        self.local = local
        self.rank = int(rank)
        self.world = int(world)
        self.control = control
        self.data = data

    @property
    def size(self) -> int:
        """The devices of the whole mesh, over every process."""
        return self.local.size * self.world

    @property
    def devices(self):
        """This process's devices."""
        return self.local.devices

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank {self.rank} of {self.world}, "
                f"{self.size} devices; here {[str(d) for d in self.devices]})")

    def close(self) -> None:
        """Stop the local mesh's worker threads."""
        self.local.close()


def local_devices(n: int, world: int, local_rank: int, device="cuda"):
    """The devices that a process of a ``world``-process mesh of ``n``
    devices drives: ``cuda:local_rank*(n/world)`` and the ``n/world - 1``
    after it, or ``n/world`` CPU slots. Exits with a message where
    ``world`` does not divide ``n`` or this process sees too few cards: it
    never shrinks the mesh and never moves to the CPU."""
    from ..utils.dtypes import resolve_device
    if n < 1 or n % world:
        raise SystemExit(
            f"--mesh_shape [{n}] over WORLD_SIZE={world} processes: the "
            f"mesh's {n} devices must split evenly over the processes (n "
            "a multiple of WORLD_SIZE)")
    k = n // world
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * k
    first, visible = local_rank * k, torch.cuda.device_count()
    if first + k > visible:
        raise SystemExit(
            f"--mesh_shape [{n}] over {world} processes: LOCAL_RANK "
            f"{local_rank} drives cuda:{first} to cuda:{first + k - 1}, and "
            f"{visible} {'is' if visible == 1 else 'are'} visible ("
            + ", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}"
                        for i in range(visible)) + ")")
    return [torch.device("cuda", first + i) for i in range(k)]


def make_process_mesh(n: int, device="cuda",
                      timeout_s: float = 1800.0) -> ProcessMesh:
    """The ``ProcessMesh`` of ``n`` devices over the process group that
    this process joined (``init``): its local devices (``local_devices``,
    ``LOCAL_RANK`` from the environment, the rank without one), the card's
    first set current, and two new gloo groups of every rank, ``control``
    (``CONTROL_TIMEOUT_S``) and ``data`` (``timeout_s``). Every rank calls
    it, in the same order as its other groups."""
    if not initialized():
        raise RuntimeError("a mesh over processes needs the process group "
                           "joined first (mesh.init)")
    w, r = world_size(), rank()
    devices = local_devices(n, w, int(os.environ.get("LOCAL_RANK", r)),
                            device)
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    ranks = list(range(w))
    control = dist.new_group(ranks, backend="gloo",
                             timeout=datetime.timedelta(
                                 seconds=CONTROL_TIMEOUT_S))
    data = dist.new_group(ranks, backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessMesh(DeviceMesh(devices), r, w, control, data)

"""Data parallelism over ``torch.distributed``: one process a rank, the
batch split over the ranks, the parameters replicated.

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
1. The 2-D ``data x model`` mesh
(``captioner_shardings``, :79-103) is not ported: ``cli/common.Runtime``
refuses a mesh of more than one axis.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
from typing import Callable, Iterator

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

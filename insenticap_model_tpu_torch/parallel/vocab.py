"""The captioner's operations on a vocabulary sharded over the model group.

Where the JAX package places the captioner by ``captioner_shardings`` and
lets GSPMD partition the embedding lookup, the classifier, the
log-softmax and the reductions over the vocabulary, each rank here holds
rows ``[start, start + size)`` of ``word_embed.weight`` [V, E] and of
``classifier.weight`` [V, H] / ``classifier.bias`` [V]
(``parallel.mesh.VocabShard``), and every operation that reads the whole
vocabulary is written with explicit collectives over the model group:

  ``embed``          the lookup of the ids in this shard's range (others
                     zeros), summed over the group; backward the identity
                     (every rank of the group computes the same loss)
  ``copy_to_model``  the classifier's input: forward the identity,
                     backward the sum of dL/dh over the group (each shard
                     holds its part of W^T g)
  ``log_softmax``    the shards' (max, sum of exp) combined into the
                     global log-sum-exp; backward g - softmax * S, S the
                     row's sum of g over the whole vocabulary (one sum)
  ``pick``           logprobs at global ids: a masked gather, summed
  ``argmax``         the shards' (max, first index) merged, the lowest
                     global index winning a tie, as ``Tensor.argmax``
                     takes the first maximal index; with the max itself
  ``categorical``    the inverse CDF over the shards: the shards' totals
                     summed into every rank's prefix, the owning shard
                     searches locally, the index summed

Every collective is one SUM all-reduce of a zero-padded buffer (x + 0 =
x exactly), so that gloo can run it on CUDA tensors where two ranks share
one card, and every decision (an argmax's winner, a draw's owning shard)
is taken from values that every rank of the group received from the same
collective: the ranks of a model group take the same tokens bit for bit.
Reductions run in float32 (float64 for float64 operands) and cast once;
a draw's CDF is summed in float64, as the one-process draw's is.

The operations apply inside ``sharded(shard)``, which the train and eval
steps open around a sharded captioner's forward passes
(``training/steps.py``); ``current()`` is None outside it, and the
captioner then runs its one-process code (serving, the dumps on the
gathered captioner). ``stats`` counts the collectives and their bytes.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import VocabShard, _sum_dtype

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("vocab_shard",
                                                         default=None)
# the model-axis collectives issued so far: their count and bytes (reset
# by whoever reads them), and, where "sizes" is a list, each one's
# (elements, dtype) appended to it
stats = {"collectives": 0, "bytes": 0, "sizes": None}


@contextlib.contextmanager
def sharded(shard: Optional[VocabShard]) -> Iterator[None]:
    """The captioner's vocabulary is ``shard`` inside the block (None: the
    whole vocabulary, the one-process code)."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[VocabShard]:
    """The shard of the enclosing ``sharded`` block, or None."""
    return _ACTIVE.get()


def _sum(buf: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """``buf`` (contiguous) summed over the model group, in place."""
    stats["collectives"] += 1
    stats["bytes"] += buf.numel() * buf.element_size()
    if stats["sizes"] is not None:
        stats["sizes"].append((buf.numel(), buf.dtype))
    dist.all_reduce(buf, group=shard.group)
    return buf


def _summed(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """A copy of ``x`` summed over the group in its accumulation type,
    cast back."""
    return _sum(x.to(_sum_dtype({x.dtype}), copy=True).contiguous(),
                shard).to(x.dtype)


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum of the ranks' partial values. Backward: the
    identity, since every rank of the group computes the same loss from
    the sum."""

    @staticmethod
    def forward(ctx, x, shard):
        return _summed(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the sum over the group of the
    ranks' gradients (each shard's product contributes its part)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.shard), None


def _local(ids: torch.Tensor, shard: VocabShard):
    """(the ids' local rows, clamped into the shard; in the shard)."""
    local = ids.long() - shard.start
    hit = (local >= 0) & (local < shard.size)
    return local.clamp(0, shard.size - 1), hit


def embed(weight: torch.Tensor, ids: torch.Tensor,
          shard: VocabShard) -> torch.Tensor:
    """``F.embedding(ids, full weight)`` from this shard's rows."""
    local, hit = _local(ids, shard)
    out = F.embedding(local, weight)
    out = torch.where(hit.unsqueeze(-1), out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))
    return _SumOverModel.apply(out, shard)


def copy_to_model(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The classifier's input, the same on every rank of the group."""
    return _CopyToModel.apply(x, shard)


class _LogSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        xf = x.to(_sum_dtype({x.dtype}))
        m = xf.amax(dim=-1)
        s = (xf - m.unsqueeze(-1)).exp().sum(dim=-1)
        buf = torch.zeros((*x.shape[:-1], 2, shard.tp), dtype=xf.dtype,
                          device=x.device)
        buf[..., 0, shard.index] = m
        buf[..., 1, shard.index] = s
        _sum(buf, shard)
        ms, ss = buf[..., 0, :], buf[..., 1, :]
        gm = ms.amax(dim=-1, keepdim=True)
        # (x - max) - log(sum), the order of F.log_softmax's epilogue
        out = (xf - gm) - (ss * (ms - gm).exp()).sum(dim=-1,
                                                      keepdim=True).log()
        ctx.shard = shard
        ctx.save_for_backward(out)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        gf = g.to(out.dtype)
        total = _sum(gf.sum(dim=-1, keepdim=True).contiguous(), ctx.shard)
        return (gf - out.exp() * total).to(g.dtype), None


def log_softmax(logits: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The log-softmax over the whole vocabulary of this shard's logits
    (the last axis), in the logits' type, reduced in float32 or
    float64."""
    return _LogSoftmax.apply(logits, shard)


def pick(logprobs: torch.Tensor, ids: torch.Tensor,
         shard: VocabShard) -> torch.Tensor:
    """``logprobs[..., ids]`` for global ids (logprobs' leading axes and
    ids' alike): the owning shard's value, summed."""
    local, hit = _local(ids, shard)
    v = logprobs.gather(-1, local.unsqueeze(-1)).squeeze(-1)
    v = torch.where(hit, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return _SumOverModel.apply(v, shard)


class _Argmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        i = x.argmax(dim=-1)
        m = x.gather(-1, i.unsqueeze(-1)).squeeze(-1)
        buf = torch.zeros((*x.shape[:-1], 2, shard.tp), dtype=torch.float64,
                          device=x.device)
        buf[..., 0, shard.index] = m.double()
        buf[..., 1, shard.index] = (i + shard.start).double()
        _sum(buf, shard)
        ms = buf[..., 0, :]
        best = ms.amax(dim=-1, keepdim=True)
        win = (ms == best).int().argmax(dim=-1, keepdim=True)  # first shard
        idx = buf[..., 1, :].gather(-1, win).squeeze(-1).long()
        ctx.shard, ctx.shape = shard, x.shape
        ctx.save_for_backward(i, win.squeeze(-1) == shard.index)
        ctx.mark_non_differentiable(idx)
        return idx, best.squeeze(-1).to(x.dtype)

    @staticmethod
    def backward(ctx, _, g):
        i, mine = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        grad.scatter_(-1, i.unsqueeze(-1),
                      torch.where(mine, g, torch.zeros_like(g)).unsqueeze(-1))
        return grad, None


def argmax(logprobs: torch.Tensor, shard: VocabShard):
    """(the global argmax over the last axis, the first maximal index;
    the max itself, differentiable into the winning shard)."""
    return _Argmax.apply(logprobs, shard)


@torch.no_grad()
def categorical(logprobs: torch.Tensor, u: torch.Tensor,
                shard: VocabShard) -> torch.Tensor:
    """One draw a row of [rows, size] shard log-probs -> global ids [rows]:
    the first index whose cumulative probability over the whole
    vocabulary exceeds u times the row's total (the one-process
    ``captioner._categorical``, in float64 as there, so that the two
    orders of summation part by far less than a token's mass). The
    shards' totals are summed into every rank, each rank finds the owning
    shard from them alike, and the owner's local search gives the index,
    summed."""
    cdf = logprobs.double().exp().cumsum(dim=-1)
    rows = cdf.shape[0]
    totals = torch.zeros((rows, shard.tp), dtype=torch.float64,
                         device=cdf.device)
    totals[:, shard.index] = cdf[:, -1]
    prefix = _sum(totals, shard).cumsum(dim=-1)
    target = u.double() * prefix[:, -1]
    owner = torch.searchsorted(prefix, target[:, None], right=True)[:, 0] \
        .clamp_max(shard.tp - 1)
    before = torch.where(owner > 0, prefix.gather(
        -1, (owner - 1).clamp_min(0)[:, None])[:, 0], torch.zeros_like(target))
    local = torch.searchsorted(cdf, (target - before)[:, None],
                               right=True)[:, 0].clamp_max(shard.size - 1)
    idx = torch.where(owner == shard.index, local + shard.start,
                      torch.zeros_like(local)).double()
    return _sum(idx.contiguous(), shard).long()

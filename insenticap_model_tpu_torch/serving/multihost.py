"""Multi-host serving: the lockstep control plane of a ``DynamicBatcher``
whose mesh spans processes (a ``parallel.mesh.ProcessMesh``).

Counterpart of ``insenticap_model_tpu/serving/multihost.py`` (:34-108).
Process 0 owns HTTP and batching; every other process mirrors each of its
dispatches from ``follower_loop``, and every process runs the one-process
serving body (``DynamicBatcher._run``) on its stripe of the batch, over
its own ``DeviceMesh``. The functions take the batcher as their first
argument, and ``DynamicBatcher`` calls them from its dispatch thread,
``warm()``, ``close()`` and ``follower_loop()``.

The collectives of a dispatch come in one fixed order on every process:

  1. the control vector ``[opcode, bucket, run_detect]`` (int32),
     broadcast from process 0 over the mesh's ``control`` group;
  2. the batch: fc, att, sentis and forced, each scattered from process 0
     over the ``data`` group, process r receiving its rows
     ``shard_rows(bucket, r, world)``;
  3. the results: seqs, scores and labels, each gathered to process 0 over
     the ``data`` group.

Between 2 and 3 each process runs the body on its stripe. So the dispatch
is synchronous on process 0's dispatch thread: the double-buffer pipeline
would interleave two batches' collectives.

Scatter and gather, where the JAX package broadcasts the whole batch and
all-gathers the results: a process reads only its stripe, so process 0
sends (w-1)/w of the batch's bytes once, not (w-1) times all of them (a
bf16 bs=384 batch's att rows alone are 308 MB), and only process 0 reads
the results, which the followers would drop. The answers are the same
either way: each row is computed on the same device block.

The features are cast to the serving dtype on process 0's host before
they are sent (bf16 halves the bytes), and a bfloat16 tensor travels as
the uint8 view of its bytes, viewed back on arrival (gloo refuses int16,
and some versions bfloat16); nothing is widened on the way.

The idle wait: the ``control`` group's timeout (``CONTROL_TIMEOUT_S``) is
one that no idle daemon reaches, so a follower waits on the control
vector through any idle time; the ``data`` group keeps the caller's
timeout, so a follower that hangs inside a batch still fails process 0's
batch through the collective's error, and a process that dies closes its
sockets, which fails the others' next collective at once. Process 0 never
carries on alone.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import shard_rows
from .batching import to_host

MP_EXEC, MP_STOP = 0, 1


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor that gloo sends for ``t``: its bytes for bfloat16 (a
    view: a receive buffer's view fills the buffer), else ``t``."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def send_control(b, opcode: int, bucket: int, run_detect: bool) -> None:
    """Process 0: the control vector to every process."""
    dist.broadcast(torch.tensor([opcode, bucket, int(run_detect)],
                                dtype=torch.int32), 0,
                   group=b._pmesh.control)


def recv_control(b):
    """A follower: the next control vector -> (opcode, bucket,
    run_detect)."""
    ctrl = torch.zeros(3, dtype=torch.int32)
    dist.broadcast(ctrl, 0, group=b._pmesh.control)
    op, bucket, run_detect = (int(v) for v in ctrl)
    return op, bucket, bool(run_detect)


def _batch_specs(b, rows: int):
    """(shape, dtype) of fc, att, sentis and forced for ``rows`` rows."""
    return (((rows,) + b._fc_shape, b._feat_dtype),
            ((rows,) + b._att_shape, b._feat_dtype),
            ((rows, b._m), torch.int64), ((rows,), torch.int32))


def scatter_batch(b, bucket: int, batch=None):
    """Every process: its stripe of the batch (host tensors), scattered from
    process 0, which passes the whole batch's four host arrays."""
    pm = b._pmesh
    sl = shard_rows(bucket, pm.rank, pm.world)
    rows = sl.stop - sl.start
    out = []
    for i, (shape, dtype) in enumerate(_batch_specs(b, rows)):
        buf = torch.empty(shape, dtype=dtype)
        parts = None
        if pm.rank == 0:
            whole = torch.as_tensor(batch[i]).to(dtype).contiguous()
            parts = [_wire(p) for p in whole.split(rows)]
        dist.scatter(_wire(buf), parts, src=0, group=pm.data)
        out.append(buf)
    return out


def run_stripe(b, stripe, run_detect: bool):
    """Every process: the one-process body on its stripe over its local
    mesh -> host tensors (seqs, scores, labels) of the stripe's rows."""
    fc, att, sentis, forced = (b._stage(x) for x in stripe)
    return tuple(torch.from_numpy(np.ascontiguousarray(to_host(x)))
                 for x in b._run(fc, att, sentis, forced, run_detect))


def gather_results(b, out):
    """Every process: its stripe's results to process 0 -> the whole
    batch's (seqs, scores, labels) as host arrays on process 0, None on a
    follower."""
    pm = b._pmesh
    whole = []
    for t in out:
        parts = [torch.empty_like(t) for _ in range(pm.world)] \
            if pm.rank == 0 else None
        dist.gather(t, parts, dst=0, group=pm.data)
        if parts is not None:
            whole.append(torch.cat(parts).numpy())
    return tuple(whole) if pm.rank == 0 else None


def mp_exec(b, bucket: int, run_detect: bool, batch=None):
    """Every process: receive its stripe (process 0 scatters ``batch``),
    run it, gather the results -> the whole batch's host results on
    process 0, None on a follower."""
    stripe = scatter_batch(b, bucket, batch)
    return gather_results(b, run_stripe(b, stripe, run_detect))


def mp_dispatch(b, bucket: int, fc_h, att_h, sentis_h, forced_h,
                run_detect: bool):
    """Process 0: announce the dispatch, ship each process its stripe, run
    the lockstep execution -> (seqs, scores, labels) host arrays."""
    send_control(b, MP_EXEC, bucket, run_detect)
    return mp_exec(b, bucket, run_detect, (fc_h, att_h, sentis_h, forced_h))


def follower_loop(b) -> None:
    """Every process but 0: mirror process 0's dispatches until it closes,
    then close the batcher. No request is served here."""
    if not b._mp or b._pmesh.rank == 0:
        raise RuntimeError("follower_loop is for the processes other than "
                           "0 of a mesh over processes")
    while True:
        op, bucket, run_detect = recv_control(b)
        if op == MP_STOP:
            break
        mp_exec(b, bucket, run_detect)
    b.close()


def mp_stop(b) -> None:
    """Process 0, once, at close(): release the followers."""
    send_control(b, MP_STOP, 0, False)

"""The port's data-parallel layer on the CPU (gloo): ``parallel/mesh.py``'s
collectives at worlds 1, 2 and 4, the loaders' stripes against the JAX
package's ``Loader(shard=)``, ``host_shard`` and the ``Runtime``'s
launches and exits. The ranks are processes (``torch_ranks.run_ranks``);
every comparison is exact but the summed gradients', which are held
within their types' rounding of the float64 sum."""
import numpy as np
import pytest
import torch

from insenticap_model_tpu.data import loaders as jld
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.config import Opts
from insenticap_model_tpu_torch.data import loaders as tld
from insenticap_model_tpu_torch.parallel import mesh
from torch_ranks import collectives, grad_of, run_ranks


def _collate(items):
    return {"ids": np.asarray(items, np.int64)}


def _batches(loader, passes):
    return [[b["ids"].tolist() for b in loader] for _ in range(passes)]


@pytest.mark.parametrize("n,stripe,bs", [(23, (0, 2), 4), (23, (1, 2), 4),
                                         (40, (2, 3), 5), (9, (3, 4), 2)])
def test_loader_stripe_matches_jax(n, stripe, bs):
    """The port's stripe yields the JAX Loader's batches pass for pass, for
    the same items, seed and stripe; ``advance`` replays a pass's shuffle,
    and the padded eval form keeps its ``valid``."""
    items = list(range(100, 100 + n))
    j = jld.Loader(items, bs, _collate, seed=7, shard=stripe)
    t = tld.Loader(items, bs, _collate, seed=7, shard=stripe)
    assert t.items == j.items == items[stripe[0]::stripe[1]][:n // stripe[1]]
    want = _batches(j, 3)
    assert _batches(t, 3) == want
    resumed = tld.Loader(items, bs, _collate, seed=7, shard=stripe)
    resumed.advance(2)
    assert _batches(resumed, 1) == want[2:]
    je = jld.Loader(items, bs, _collate, shuffle=False, drop_last=False,
                    shard=stripe)
    te = tld.Loader(items, bs, _collate, shuffle=False, drop_last=False,
                    shard=stripe)
    assert [(b["ids"].tolist(), b["valid"]) for b in te] == \
        [(b["ids"].tolist(), b["valid"]) for b in je]


def test_loader_empty_stripe_raises_as_jax():
    for mod in (jld, tld):
        with pytest.raises(ValueError, match="shard 2/3 is empty"):
            mod.Loader([1, 2], 1, _collate, shard=(2, 3))


def test_one_process_is_the_identity():
    """Without a process group: rank 0 of 1, no stripe, and every
    collective returns its operand untouched."""
    assert (mesh.rank(), mesh.world_size(), mesh.initialized()) == \
        (0, 1, False)
    assert tcommon.host_shard() is None
    t = torch.arange(4.0)
    assert mesh.all_reduce_sum(t) is t
    tree = {"a": t}
    assert mesh.replicate(tree) is tree and torch.equal(tree["a"], t)
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.full((3,), 2.0)
    g = p.grad
    mesh.reduce_gradients({"p": p})
    assert p.grad is g
    mesh.barrier()
    assert mesh.rank_rows(lambda n: torch.arange(n), 3).tolist() == [0, 1, 2]
    assert mesh.shard_rows(12, 2, 3) == slice(8, 12)
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_rows(10, 0, 3)
    with pytest.raises(ValueError, match="backend"):
        mesh.init(1, 0, "mpi", "file:///nonexistent")
    assert mesh.backend_for("cpu") == "gloo"
    assert mesh.backend_for("cuda:1") == "nccl"


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_across_ranks(world, tmp_path):
    """``replicate`` gives rank 0's leaves on every rank (bf16 and int
    included); ``reduce_gradients`` the sum of the ranks' gradients, each
    in its own type (a leaf without a grad counting as zeros), in float32
    or, with an f64 leaf, float64; ``all_reduce_sum``, ``rank_rows``,
    ``host_shard`` and the Runtime on the caller's group."""
    res = run_ranks(collectives, world, tmp_path)
    want_tree = res[0]["tree"]
    g = torch.Generator().manual_seed(100)
    assert torch.equal(want_tree["a"], torch.randn(3, 4, generator=g))
    for r, out in enumerate(res):
        assert torch.equal(out["tree"]["a"], want_tree["a"])
        assert torch.equal(out["tree"]["b"][0], want_tree["b"][0])
        assert out["tree"]["b"][0].dtype == torch.bfloat16
        assert out["tree"]["b"][1].tolist() == [0, 1, 2]
        for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
            dtypes = (torch.float32, torch.bfloat16, dt, torch.float32)
            for i, (got, d) in enumerate(zip(out[tag], dtypes)):
                shape = [(4, 3), (5,), (2,), (2,)][i]
                ranks = [0] if i == 3 else range(world)
                exact = sum(grad_of(i, q, shape, d).to(torch.float64)
                            for q in ranks)
                assert got.dtype == d
                if i == 3:      # rank 0's gradient alone
                    assert torch.equal(got, grad_of(i, 0, shape, d))
                tol = {torch.bfloat16: 2 ** -8, torch.float32: 1e-6,
                       torch.float64: 1e-12}[d]
                np.testing.assert_allclose(
                    got.double().numpy(), exact.numpy(),
                    atol=tol * float(exact.abs().max()), err_msg=(tag, i))
        assert out["sum"].tolist() == [world * (world + 1) / 2,
                                       0.5 * world]
        assert out["sum_bf16"].dtype == torch.bfloat16
        assert out["sum_bf16"].float().tolist() == out["sum"].tolist()
        assert out["rank_rows"].tolist() == \
            torch.arange(6 * world).reshape(3 * world, 2)[3 * r:3 * r + 3] \
            .tolist()
        assert out["host_shard"] == (r, world)
        assert out["round_bs"] == [-(-b // world) * world for b in (5, 8, 1)]
        assert f"[{world + 1}] disagrees" in out["exit"]


def test_runtime_exits_with_a_message(monkeypatch):
    """A mesh of three axes, a mesh (1-D or 2-D) that disagrees with
    WORLD_SIZE, ranks without torchrun, torchrun without a mesh, a
    LOCAL_RANK with no card of its own, and a data-parallel mesh given to
    an entry point that runs on one device: each exits, naming what is
    wrong."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)

    def exits(match, data_parallel=True, **kw):
        with pytest.raises(SystemExit, match=match):
            tcommon.Runtime(Opts(**dict(dict(device="cpu"), **kw)),
                            data_parallel=data_parallel)
    exits(r"\[1, 2, 2\].*a mesh of 3 axes", mesh_shape=(1, 2, 2))
    exits("WORLD_SIZE is unset", mesh_shape=(2,))
    exits("not ported yet", data_parallel=False, mesh_shape=(2,))
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    exits(r"\[2\] disagrees with WORLD_SIZE=3", mesh_shape=(2,))
    exits("no --mesh_shape", mesh_shape=())
    monkeypatch.setenv("WORLD_SIZE", "2")
    exits(r"\[2, 2\] disagrees with WORLD_SIZE=2", mesh_shape=(2, 2))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(tcommon, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    exits("LOCAL_RANK 1 has no card of its own", mesh_shape=(2,),
          device="cuda")
    assert not mesh.initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tcommon.Runtime(Opts(device="cpu")).round_bs(5) == 5

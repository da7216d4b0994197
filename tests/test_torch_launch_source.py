"""The kernel launch layer under several devices and threads, read from
the sources and tested on the CPU: every ``.cu`` raises its kernels'
shared-memory limits once on each device (``cudaFuncSetAttribute`` acts
on the calling thread's current device only), every ctypes launch in
``ops/`` runs inside ``_build.launch`` (its operands' card made current,
that card's stream handed in), and every launch counter is bumped by
``_build.count``, which stays exact under concurrent callers."""
import ast
import os
import re
import sys
import threading

import pytest
import torch

from insenticap_model_tpu_torch.ops import _build

OPS = os.path.join(os.path.dirname(_build.__file__))
CUDA_SOURCES = sorted(n for n in os.listdir(_build.CSRC)
                      if n.endswith(".cu"))


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_smem_limits_are_raised_per_device(name):
    """No function-local static holds a cudaFuncSetAttribute result: each
    instance keeps one slot a device (``kMaxDevices``), filled on its
    device at its first launch there, found by ``cudaGetDevice``."""
    src = _read(os.path.join(_build.CSRC, name))
    sets = src.count("cudaFuncSetAttribute(")
    if not sets:
        assert "static std::atomic" not in src
        return
    assert not re.search(r"static\s+(const\s+)?(int|cudaError_t)\s+\w+\s*=",
                         src), f"{name}: a limit cached in a plain static"
    slots = re.findall(r"static std::atomic<int> (\w+)\[(\w+)\];", src)
    assert slots and all(size == "kMaxDevices" for _, size in slots)
    assert "constexpr int kMaxDevices = 64;" in src
    assert "cudaGetDevice(&dev)" in src and "#include <atomic>" in src


def _wrapper_sources():
    return sorted(n for n in os.listdir(OPS)
                  if n.endswith(".py") and n != "_build.py")


def test_launches_go_through_the_launch_helper():
    """In every ops wrapper, each ctypes launch (``_build.check`` of a C
    entry point) sits inside ``with _build.launch(...) as stream`` and
    passes that stream; nothing else reads a stream pointer; every
    ``launches`` counter is bumped by ``_build.count``."""
    launching = 0
    for name in _wrapper_sources():
        src = _read(os.path.join(OPS, name))
        assert "stream_ptr" not in src and "cuda_stream" not in src, name
        assert not re.search(r"\.launches(_v2)?\s*\+=", src), name
        tree = ast.parse(src)
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        checks = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
                  and ast.unparse(c.func) == "_build.check"]
        for call in checks:
            node, inside = call, None
            while node in parents:
                node = parents[node]
                if isinstance(node, ast.With) and any(
                        ast.unparse(item.context_expr.func)
                        == "_build.launch" for item in node.items
                        if isinstance(item.context_expr, ast.Call)):
                    inside = node
                    break
            assert inside is not None, (name, ast.unparse(call)[:80])
            stream = inside.items[0].optional_vars.id
            assert stream in {n.id for n in ast.walk(call.args[0])
                              if isinstance(n, ast.Name)}, name
        launching += bool(checks)
        if checks:
            assert "_build.count(" in src, name
    # attention v1/v2, the int8 attention, top-k, pool, tiled_mm, Winograd
    assert launching == 6
    assert "def stream_ptr" not in _read(os.path.join(OPS, "_build.py"))


def test_launch_refuses_operands_on_two_devices():
    a = torch.zeros(2)
    b = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="not on one card"):
        with _build.launch("tiled_mm", a, None, b):
            pass


def test_launch_counter_is_exact_under_threads():
    """8 threads bump one counter 10,000 times each, with the interpreter
    switching threads every microsecond: not one count lost."""
    def fn():
        pass
    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count(fn) for _ in range(10_000)]) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 80_000

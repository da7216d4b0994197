"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, at first use, into
``insenticap_model_tpu_torch/build/`` (git-ignored), and loaded with
``ctypes``. The library's file name carries a hash of its source and
flags, so an edited source is never served from a stale build. Pointers
and the CUDA stream cross as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launch and ``check`` raises on a non-zero
code. There is no fallback: a missing ``nvcc`` or a failed build raises.
``no_grad_guard`` is every wrapper's refusal to launch a kernel where
autograd would record a graph through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_typed: set = set()          # (library, entry point) whose types are set
# ptxas register/shared-memory report of each build, for the smoke run
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> None:
    """Compile every listed source that has no current build, one
    ``nvcc`` process each, all started together."""
    todo = [n for n in names if not os.path.exists(_target(n))]
    if not todo:
        return
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = _target(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        build_logs[n] = out
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{out}")
            continue
        os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def load(name: str, signatures: Dict[str, int]) -> ctypes.CDLL:
    """The loaded library ``name``, built if needed. ``signatures`` maps
    each C entry point to its ``argtypes`` (``c_void_p`` for every pointer
    and the stream, ``c_int`` or ``c_longlong`` for every integer); each
    returns an int. Wrappers that share a library each pass their own
    entry points: every one is typed at its first request."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        for fn, argtypes in signatures.items():
            if (name, fn) not in _typed:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
                _typed.add((name, fn))
        return lib


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled entry function: {"registers", "spill_stores",
    "spill_loads"}} from a build's ``-Xptxas -v`` log (``build_logs``)."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {code}")


def no_grad_guard(what: str, *tensors) -> None:
    """Raise where autograd would record a graph through a kernel: the
    kernels have no backward, so their outputs would carry no ``grad_fn``
    and the operands would silently get no gradient. ``None`` entries are
    skipped."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an operand requires grad, but the CUDA kernel has no "
            "backward; call it under torch.no_grad() or use the plain "
            "version")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

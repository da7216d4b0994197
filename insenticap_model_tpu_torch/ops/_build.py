"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, at first use, into
``insenticap_model_tpu_torch/build/`` (git-ignored), and loaded with
``ctypes``. The library's file name carries a hash of its source and
flags, so an edited source is never served from a stale build. Pointers
and the CUDA stream cross as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launch and ``check`` raises on a non-zero
code. There is no fallback: a missing ``nvcc`` or a failed build raises.
Host code (``csrc/<name>.cc``: the image decoders, the feature-store
gather) builds the same way with the host's C++ compiler (``load_host``),
no ``nvcc`` needed; its name also hashes the machine, its C library and
the compiler's version, so a library built on one host is never loaded
on another.
``no_grad_guard`` is every wrapper's refusal to launch a kernel where
autograd would record a graph through it. ``launch`` is every ctypes
launch's context: the operands' card made the calling thread's current
device (a C entry point launches, and raises its kernel's shared-memory
limit, on the current device) and that card's current stream handed in;
``count`` bumps a wrapper's launch counter under a lock, so that counts
stay exact when several threads launch at once (one worker thread a
device of a ``parallel.mesh.DeviceMesh``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
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
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_typed: set = set()          # (library, entry point) whose types are set
_host_key: bytes = b""       # _host_target's host part, once computed
# ptxas register/shared-memory report of each build, for the smoke run
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def _cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++ on PATH): the "
                       "host libraries cannot be built")


def _target(name: str, ext: str = ".cu", flags=NVCC_FLAGS,
            extra: bytes = b"") -> str:
    src = os.path.join(CSRC, name + ext)
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(flags).encode() + extra)
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _host_target(name: str) -> str:
    """``_target`` of ``csrc/<name>.cc``, its hash also over the machine,
    the C library and ``c++ --version``."""
    global _host_key
    if not _host_key:
        ver = subprocess.run([_cxx(), "--version"], capture_output=True,
                             text=True, check=True).stdout
        _host_key = " ".join([platform.machine(), *platform.libc_ver(),
                              ver]).encode()
    return _target(name, ".cc", CXX_FLAGS, _host_key)


def _compile(jobs, what: str) -> None:
    """Run every (name, source, target, compiler command) at once, the
    command's log kept in ``build_logs[name]``; each writes a temporary
    file that replaces the target when its command succeeds."""
    os.makedirs(BUILD, exist_ok=True)
    procs = []
    for n, src, target, cmd in jobs:
        tmp = target + f".tmp{os.getpid()}"
        procs.append((n, src, target, tmp, subprocess.Popen(
            [*cmd, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, src, target, tmp, p in procs:
        out, _ = p.communicate()
        build_logs[n] = out
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)} (exit {p.returncode}):"
                          f"\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError(f"{what} build failed: " + "\n".join(failed))


def build(names: Iterable[str]) -> None:
    """Compile every listed source that has no current build, one
    ``nvcc`` process each, all started together."""
    todo = [n for n in names if not os.path.exists(_target(n))]
    if not todo:
        return
    nvcc = _nvcc()
    _compile([(n, os.path.join(CSRC, n + ".cu"), _target(n),
               [nvcc, *NVCC_FLAGS]) for n in todo], "CUDA kernel")


def build_host(name: str) -> None:
    """Compile ``csrc/<name>.cc`` with the host's C++ compiler unless it
    has a current build."""
    target = _host_target(name)
    if not os.path.exists(target):
        _compile([(name, os.path.join(CSRC, name + ".cc"), target,
                   [_cxx(), *CXX_FLAGS])], "host library")


def _with_types(name: str, signatures) -> ctypes.CDLL:
    """The loaded library ``name``, every entry point of ``signatures``
    typed at its first request. Called at every launch: it touches no file
    (the build's name hashes its source)."""
    lib = _libs[name]
    for fn, argtypes in signatures.items():
        if (name, fn) not in _typed:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _typed.add((name, fn))
    return lib


def load(name: str, signatures: Dict[str, int]) -> ctypes.CDLL:
    """The loaded library ``name``, built if needed. ``signatures`` maps
    each C entry point to its ``argtypes`` (``c_void_p`` for every pointer
    and the stream, ``c_int`` or ``c_longlong`` for every integer); each
    returns an int. Wrappers that share a library each pass their own
    entry points: every one is typed at its first request."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(_target(name))
        return _with_types(name, signatures)


def load_host(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """``load`` for host code: ``csrc/<name>.cc`` built by ``build_host``;
    every entry point returns an int."""
    with _lock:
        if name not in _libs:
            build_host(name)
            _libs[name] = ctypes.CDLL(_host_target(name))
        return _with_types(name, signatures)


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


@contextlib.contextmanager
def launch(what: str, *tensors):
    """The context of one ctypes launch on ``tensors`` (``None`` entries
    skipped): their card is the calling thread's current device inside,
    and the block gets the pointer of that card's current stream. A
    thread whose current device is another card would otherwise hand the
    C entry point one card's stream and pointers while it launches on
    its own. Operands on two devices raise ValueError."""
    import torch
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: the operands lie on "
                         f"{sorted(map(str, devices))}, not on one card")
    (device,) = devices
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def count(fn, attr: str = "launches") -> None:
    """``fn.<attr> += 1`` under a lock: a bare read-modify-write from two
    threads can lose a count, and the smoke run holds the counts
    exactly."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)

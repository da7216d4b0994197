"""Dtype policy and device selection shared by the serving entry points."""
from __future__ import annotations

import torch


def _map_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _map_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_bf16(tree):
    """The serving cast: float tensors -> bfloat16, integer/bool leaves
    untouched. One definition so the batcher and the smoke run agree on
    which leaves are cast."""
    return _map_floats(tree, torch.bfloat16)


def cast_f32(tree):
    """Inverse policy cast: float tensors (incl. bfloat16) -> float32, the
    same leaves as ``cast_bf16``."""
    return _map_floats(tree, torch.float32)


def to_device(tree, device, dtype=None):
    """Every tensor of a nested dict/list tree moved to ``device`` (lists
    and tuples come back as lists); float tensors cast to ``dtype`` when it
    is given."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device, dtype) for v in tree]
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def resolve_device(device="cuda") -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: a CUDA
    device is refused, not silently replaced, when CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev

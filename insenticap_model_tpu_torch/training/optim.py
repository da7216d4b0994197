"""The optimizer of every stage: Adam behind an element-wise gradient clamp.

Counterpart of ``insenticap_model_tpu/training/optim.py`` (:19-48), with
its semantics:

  * the gradient clamped element-wise to ±grad_clip BEFORE Adam, as the
    reference's clip_gradient() clamps param.grad after backward and
    before step (train_xe.py:19-23, decoder.py:14-18);
  * Adam with torch's defaults: betas 0.9/0.999, eps 1e-8 added outside
    the square root;
  * a mutable learning rate (the halve-on-plateau schedule,
    train_xe.py:234-238), read and set by ``get_lr``/``set_lr``.

The arithmetic is optax's ``scale_by_adam`` as the JAX package runs it:
the moments stay float32 whatever the parameters' type (optax's moments
take the type of the parameters they were initialised from, which the
JAX CLIs keep float32 before casting the parameters to bf16), the update
is formed in float32 and cast to the parameter's type. One int32 step
count serves every parameter, as optax's ``count`` does.
``to_optax_state``/``load_optax_state`` turn the state into the tree that
the JAX package's checkpoints hold (flax's state dict of optax's
``inject_hyperparams`` chain) and back.

Under a ``[dp, tp]`` mesh a captioner's moments shard like its params
(``shard_captioner``: the update is element by element, so a shard's
moments are the whole moments' rows), and ``Adam.shard`` names the
vocabulary rows its trees hold; the checkpoint's tree holds the whole
moments, which ``to_optax_state`` gathers over the model group and
``load_optax_state`` reads before the trees are sharded.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import convert, nn
from ..parallel import mesh

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam over a parameter tree whose float leaves require grad; the
    gradients are read from ``.grad`` after ``backward``. ``shard``: the
    vocabulary rows (``parallel.mesh.VocabShard``) that a captioner's
    params and moments hold, None where they are whole."""

    def __init__(self, params, lr: float, grad_clip: float = 0.1):
        self.params = params
        self.shard = None
        self.lr = float(lr)
        self.grad_clip = float(grad_clip)
        self.count = 0
        self.mu = nn.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        self.nu = nn.tree_map(torch.zeros_like, self.mu)

    def zero_grad(self) -> None:
        for p in nn.tree_leaves(self.params):
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the leaves' ``.grad`` (a leaf without one has a
        zero gradient)."""
        self.count += 1
        # optax's bias corrections, 1 - b**count in float32
        bc1 = float(np.float32(1.0) - np.float32(B1) ** self.count)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** self.count)
        for p, m, v in zip(nn.tree_leaves(self.params),
                           nn.tree_leaves(self.mu), nn.tree_leaves(self.nu)):
            g = p.grad
            g = torch.zeros_like(m) if g is None else \
                g.clamp(-self.grad_clip, self.grad_clip).float()
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).add_(g * g, alpha=1.0 - B2)
            u = (m / bc1) / ((v / bc2).sqrt() + EPS)
            p.copy_(p.float() - self.lr * u)


def shard_captioner(opt: Adam, shard) -> None:
    """Keep this rank's vocabulary ``shard`` of a captioner's params and
    moments (``parallel.mesh.shard_captioner``, each tree replaced) and
    record it as ``opt.shard``; nothing changes where ``shard`` is
    None."""
    opt.params = mesh.shard_captioner(opt.params, shard)
    opt.mu = mesh.shard_captioner(opt.mu, shard)
    opt.nu = mesh.shard_captioner(opt.nu, shard)
    opt.shard = shard


def get_lr(opt: Adam) -> float:
    return opt.lr


def set_lr(opt: Adam, lr: float) -> None:
    """The learning rate of the next steps (plateau halving)."""
    opt.lr = float(lr)


def to_optax_state(opt: Adam) -> Dict:
    """The state as the JAX package's checkpoint holds optax's
    (``inject_hyperparams(chain(clip, scale_by_adam, scale))``, flax's
    state dict): CPU tensors, the moments
    in the JAX package's parameter layout, copies that later steps leave
    alone. Where ``opt.shard`` is set the captioner's sharded moments are
    gathered over the model group first (a collective: every rank of
    every model group calls it)."""
    def moments(tree):
        tree = mesh.gather_captioner(tree, opt.shard)
        return nn.tree_map(torch.clone, convert.to_jax_tensors(tree))
    adam = {"count": torch.tensor(opt.count, dtype=torch.int32),
            "mu": moments(opt.mu), "nu": moments(opt.nu)}
    return {"count": torch.tensor(opt.count, dtype=torch.int32),
            "hyperparams": {"learning_rate": torch.tensor(
                opt.lr, dtype=torch.float32)},
            "hyperparams_states": {},
            "inner_state": [{}, adam, {}]}


def _like(got, want, path: str):
    """``got`` in ``want``'s structure: the same keys, list lengths (the
    detector's conv and fc stacks; an empty list may come as the empty map
    flax stores it as) and leaf shapes, else ValueError."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"optimizer state {path}: keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f" != {sorted(want)}")
        return {k: _like(got[k], want[k], f"{path}/{k}") for k in want}
    if isinstance(want, (list, tuple)):
        if isinstance(got, dict) and not got:
            got = []
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"optimizer state {path}: expected a list of "
                             f"{len(want)}, got {type(got).__name__}")
        return [_like(a, b, f"{path}/{i}")
                for i, (a, b) in enumerate(zip(got, want))]
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"optimizer state {path}: shape {tuple(got.shape)}"
                         f" != {tuple(want.shape)}")
    return got


def load_optax_state(opt: Adam, state: Dict) -> None:
    """Restore ``opt`` from an optax state tree (``to_optax_state``'s
    form; ``inner_state`` as a list or a map keyed "0".."n-1"), the
    moments in the JAX package's layout, each leaf's shape checked
    against the parameters."""
    inner = state["inner_state"]
    if isinstance(inner, dict):
        inner = [inner[str(i)] for i in range(len(inner))]
    if len(inner) != 3 or not isinstance(inner[1], dict) \
            or "mu" not in inner[1]:
        raise ValueError(f"optimizer state: {len(inner)} inner states; "
                         "expected optax's chain of clip, Adam and scale")
    adam = inner[1]
    moments = {}
    for name in ("mu", "nu"):
        tree = _like(convert.from_jax_numpy(adam[name], device="cpu"),
                     opt.params, name)
        moments[name] = nn.tree_map(lambda t: t.float(), tree)
    dev = nn.tree_leaves(opt.params)[0].device
    opt.mu = nn.tree_map(lambda t: t.to(dev), moments["mu"])
    opt.nu = nn.tree_map(lambda t: t.to(dev), moments["nu"])
    opt.count = int(adam["count"])
    opt.lr = float(state["hyperparams"]["learning_rate"])

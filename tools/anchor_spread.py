"""Where the port's metrics anchor parts from the JAX package's.

Runs the two anchor chains (``tools/build_anchor.py`` for the JAX
package, ``tools/build_anchor_torch.py`` for the port) on the CPU with one
input changed at a time, the corpus always seed 0's, and prints each
table's violations (``compare_tables``, the anchors' ``TOLERANCES``):

- ``seeds``: the trainers' seed (``Opts.seed``: initial weights, loader
  shuffles, dropout and sampling draws) of each package's chain, against
  ``ANCHOR.json`` and against the same package's seed-0 table;
- ``streams``: the port's chain with only its step generators changed
  (``cli.common.step_seed`` offset: dropout, scheduled sampling and the
  RL draws), against ``ANCHOR_TORCH.json``;
- ``jax_init``: the port's chain with each stage's initial weights drawn
  by the JAX package's ``init_params`` (keyed by the seed the port's
  generator carries), against ``ANCHOR.json`` and the JAX chain's seed-0
  table.

    python tools/anchor_spread.py [--out anchor_spread.json]

It imports both packages (like the tests), so it is not part of the port;
about 7 minutes on an 8-core CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for d in (REPO, os.path.join(REPO, "tools"), os.path.join(REPO, "tests")):
    if d not in sys.path:
        sys.path.insert(0, d)

JAX_SEEDS = (0, 1, 2, 3)
PORT_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)
STREAM_OFFSETS = (1000, 2000, 3000)


def _anchor(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)["table"]


def _run(tool, root, train_seed):
    """``tool.run_pipeline`` on seed 0's corpus with the trainers' seed
    ``train_seed`` (every stage's Opts come from ``tool.anchor_opts``)."""
    orig = tool.anchor_opts
    tool.anchor_opts = lambda seed=0, **kw: orig(seed=train_seed, **kw)
    try:
        return tool.run_pipeline(root, seed=0)
    finally:
        tool.anchor_opts = orig


def jax_init_patches():
    """(port module, init) pairs that draw the JAX package's initial
    weights in the port's layout."""
    import jax
    import torch

    from insenticap_model_tpu import config as jconfig
    from insenticap_model_tpu.models import captioner as jcap
    from insenticap_model_tpu.models import concept_detector as jcpt
    from insenticap_model_tpu.models import sent_senti_cls as jss
    from insenticap_model_tpu.models import sentiment_detector as jsd
    from insenticap_model_tpu_torch import nn as tnn
    from insenticap_model_tpu_torch.models import captioner as tcap
    from insenticap_model_tpu_torch.models import concept_detector as tcpt
    from insenticap_model_tpu_torch.models import sent_senti_cls as tss
    from insenticap_model_tpu_torch.models import sentiment_detector as tsd
    from torch_parity import to_port

    def jax_init(jmod):
        def init(gen, *args, device="cuda", dtype=torch.float32):
            *args, settings = args
            params = to_port(jmod.init_params(
                jax.random.PRNGKey(gen.initial_seed()), *args,
                jconfig.Settings.from_dict(settings.to_dict())))
            return tnn.tree_map(lambda x: x.to(device=device, dtype=dtype),
                                params)
        return init
    return [(t, jax_init(j)) for t, j in
            ((tcpt, jcpt), (tsd, jsd), (tss, jss), (tcap, jcap))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    import build_anchor as jtool
    import build_anchor_torch as ttool
    from insenticap_model_tpu_torch.cli import common
    ttool.ensure_isclm()
    anchored, port_anchored = _anchor("ANCHOR.json"), \
        _anchor("ANCHOR_TORCH.json")
    cmp = ttool.compare_tables
    out = {"seeds": {}, "streams": {}, "jax_init": {}}
    tmp = tempfile.mkdtemp(prefix="anchor_spread_")
    for pkg, tool, seeds in (("jax", jtool, JAX_SEEDS),
                             ("port", ttool, PORT_SEEDS)):
        tables = {s: _run(tool, os.path.join(tmp, f"{pkg}_{s}"), s)
                  for s in seeds}
        out["seeds"][pkg] = {
            s: {"vs_ANCHOR.json": len(cmp(anchored, t)),
                "vs_own_seed_0": len(cmp(tables[0], t))}
            for s, t in tables.items()}
        if pkg == "jax":
            jax_seed0 = tables[0]
    step_seed = common.step_seed
    for off in STREAM_OFFSETS:
        common.step_seed = lambda seed, *keys, off=off: step_seed(seed + off,
                                                                  *keys)
        try:
            t = ttool.run_pipeline(os.path.join(tmp, f"stream_{off}"))
        finally:
            common.step_seed = step_seed
        out["streams"][off] = {
            "vs_ANCHOR_TORCH.json": len(cmp(port_anchored, t)),
            "equal_to_ANCHOR_TORCH.json": t == port_anchored}
    saved = []
    for mod, init in jax_init_patches():
        saved.append((mod, mod.init_params))
        mod.init_params = init
    try:
        t = ttool.run_pipeline(os.path.join(tmp, "jax_init"))
    finally:
        for mod, init in saved:
            mod.init_params = init
    out["jax_init"] = {"vs_ANCHOR.json": len(cmp(anchored, t)),
                       "equal_to_jax_seed_0": t == jax_seed0}
    print(json.dumps(out, indent=1))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

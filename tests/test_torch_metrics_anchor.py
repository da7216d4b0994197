"""The port's quality-metrics anchor: rebuild the port's seven-stage chain
(``tools/build_anchor_torch.py``) on the CPU from its own synthetic
corpus and hold the paper table to the committed ``ANCHOR_TORCH.json``
within its tolerances; and the same chain started from the JAX package's
initial weights held to the JAX anchor, ``ANCHOR.json``. Catches a
metric-affecting change anywhere in the port's chain (model math, data
layer, beam search, rewards, scorers), and any drift of its math from
the JAX package's."""
import json
import os
import sys

import pytest

pytestmark = pytest.mark.slow  # the whole chain, 0.5-1 min on a CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "tools") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "tools"))


def _anchor(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _rebuild(root, anchor):
    from build_anchor_torch import ensure_isclm, run_pipeline
    ensure_isclm()
    return run_pipeline(str(root), seed=anchor["seed"],
                        epochs=anchor["epochs"], device="cpu")


def test_port_metrics_anchor_reproduces(tmp_path):
    from build_anchor_torch import compare_tables
    anchor = _anchor("ANCHOR_TORCH.json")
    table = _rebuild(tmp_path / "anchor", anchor)
    bad = compare_tables(anchor["table"], table, anchor["tolerances"])
    assert not bad, "metric drift vs ANCHOR_TORCH.json:\n" + "\n".join(bad)

    # the anchor must witness a learned chain, not noise: the fact split
    # has scored rows and a live CIDEr-D
    q = anchor["table"]["splits"]["fact"]["quality"]
    assert q and any(row["CIDEr-D"] > 0 for row in q.values())


def test_port_chain_from_jax_init_reproduces_jax_anchor(tmp_path,
                                                         monkeypatch):
    """Each stage's initial weights drawn by the JAX package's
    ``init_params`` (``anchor_spread.jax_init_patches``): the port's
    chain then meets ``ANCHOR.json``. Its own initial weights are the one
    input the two chains do not share; their dropout, scheduled-sampling
    and RL draws still differ."""
    from anchor_spread import jax_init_patches
    from build_anchor_torch import compare_tables
    for mod, init in jax_init_patches():
        monkeypatch.setattr(mod, "init_params", init)
    anchor = _anchor("ANCHOR.json")
    table = _rebuild(tmp_path / "anchor", anchor)
    bad = compare_tables(anchor["table"], table, anchor["tolerances"])
    assert not bad, "the port's chain from the JAX initial weights vs " \
        "ANCHOR.json:\n" + "\n".join(bad)

"""The port's anchor tool (``tools/build_anchor_torch.py``) against the JAX
package's (``tools/build_anchor.py``), fast: the same epochs, tolerances,
widths and stage options, and ``compare_tables`` returning the same
violations on ``ANCHOR.json`` perturbed in each metric family; and
``ANCHOR_TORCH.json`` with the JAX anchor's keys."""
import copy
import dataclasses
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "tools") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "tools"))

import build_anchor as jtool  # noqa: E402
import build_anchor_torch as ttool  # noqa: E402


def _anchor(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def test_constants_equal_the_jax_tool():
    assert ttool.EPOCHS == jtool.EPOCHS
    assert ttool.TOLERANCES == jtool.TOLERANCES
    assert ttool.ANCHOR_SETTINGS == jtool.ANCHOR_SETTINGS


@pytest.mark.parametrize("kw", [{}, {"rl_bs": 6, "beam_size": 2},
                                {"compute_dtype": "bfloat16"}])
def test_anchor_opts_equal_the_jax_tool(kw):
    """Every option the JAX tool sets, the port's sets alike; the port's
    adds the device."""
    j = dataclasses.asdict(jtool.anchor_opts(seed=3, **kw))
    t = dataclasses.asdict(ttool.anchor_opts(seed=3, device="cpu", **kw))
    assert t.pop("device") == "cpu"
    j["mesh_shape"], t["mesh_shape"] = list(j["mesh_shape"]), \
        list(t["mesh_shape"])
    j["settings"]["text_cnn_filters"] = list(
        j["settings"]["text_cnn_filters"])
    t["settings"]["text_cnn_filters"] = list(
        t["settings"]["text_cnn_filters"])
    assert t == j


def _perturb(table, family, delta):
    """A copy of ``table`` with ``delta`` added to one value of
    ``family``, or the entry removed (``delta`` None)."""
    t = copy.deepcopy(table)
    senti = t["splits"]["senti"]
    if family == "wrong_rate":
        t["det_sentis_wrong_rate"] += delta
        return t
    if family.startswith("quality"):
        split, senti_name, metric = family.split("/")[1:]
        row = t["splits"][split]["quality"][senti_name]
        if delta is None:
            del row[metric]
        else:
            row[metric] += delta
        return t
    section, key = family.split("/")
    if delta is None:
        del senti[section][key]
    elif section == "ppl":
        senti[section][key] *= 1 + delta
    else:
        senti[section][key] += delta
    return t


FAMILIES = {
    "wrong_rate": (0.19, 0.21),
    "quality/fact/neutral/CIDEr-D": (4.9, -5.1),
    "quality/senti/positive/Bleu-1": (-4.9, 5.1),
    "quality/senti/negative/METEOR*": (5.0, 7.0),
    "ppl/neutral": (0.24, -0.26),
    "ppl/positive": (-0.24, 0.3),
    "cls/all": (0.19, -0.21),
    "cls/neutral": (-0.2, -0.5),
}


# the wrong rate is never absent from a table
@pytest.mark.parametrize("family,which", [
    (f, w) for f in sorted(FAMILIES) for w in ("within", "beyond", "missing")
    if (f, w) != ("wrong_rate", "missing")])
def test_compare_tables_matches_the_jax_tool(family, which):
    base = _anchor("ANCHOR.json")["table"]
    within, beyond = FAMILIES[family]
    delta = {"within": within, "beyond": beyond, "missing": None}[which]
    rebuilt = _perturb(base, family, delta)
    want = jtool.compare_tables(base, rebuilt)
    assert ttool.compare_tables(base, rebuilt) == want
    assert ttool.compare_tables(base, rebuilt, ttool.TOLERANCES) == want
    assert bool(want) == (which != "within")


def test_compare_tables_whole_sections_and_self():
    """A table against itself has no violation; one with the senti
    split's ppl or cls gone, or a split gone, violates as in JAX."""
    base = _anchor("ANCHOR.json")["table"]
    assert ttool.compare_tables(base, base) == []
    for drop in (("senti", "ppl"), ("senti", "cls"), ("fact", None)):
        t = copy.deepcopy(base)
        if drop[1] is None:
            del t["splits"][drop[0]]
        else:
            t["splits"][drop[0]][drop[1]] = None
        want = jtool.compare_tables(base, t)
        assert want and ttool.compare_tables(base, t) == want
    mine = _anchor("ANCHOR_TORCH.json")["table"]
    assert ttool.compare_tables(base, mine) == jtool.compare_tables(base,
                                                                    mine)


def test_anchor_torch_json_has_the_jax_keys():
    j, t = _anchor("ANCHOR.json"), _anchor("ANCHOR_TORCH.json")
    assert sorted(t) == sorted(j)
    assert t["corpus"] == "insenticap_model_tpu_torch/synthetic.py"
    assert t["epochs"] == ttool.EPOCHS and t["tolerances"] == \
        ttool.TOLERANCES and t["seed"] == 0
    assert sorted(t["table"]) == sorted(j["table"])
    assert sorted(t["table"]["splits"]) == sorted(j["table"]["splits"])
    for split, s in j["table"]["splits"].items():
        assert sorted(t["table"]["splits"][split]) == sorted(s)

"""The int8-storage attention's CUDA source against the Python side: its
two C entry points live in ``csrc/fused_attention.cu`` beside v1's, take
as many arguments as ``ops/fused_attention_i8._SIGS`` gives, and are
instantiated for every beam the wrapper takes; the wrapper loads that one
library, whose entry points it shares with v1's wrapper; and ptxas's
report, which the smoke run holds the B = 3 instances' spills against, is
read entry by entry. The kernels themselves are held against the plain
twin on the card (``tests/test_torch_cuda.py``)."""
import ctypes
import re
from pathlib import Path

import pytest

from insenticap_model_tpu_torch.ops import _build
from insenticap_model_tpu_torch.ops import fused_attention as fa
from insenticap_model_tpu_torch.ops import fused_attention_i8 as fa8

CSRC = Path(_build.CSRC)
SOURCE = CSRC / "fused_attention.cu"


def _entries(src):
    body = src[src.index('extern "C" {'):]
    return {name: [p.strip() for p in params.split(",")]
            for name, params in re.findall(r"int (isc_\w+)\(([^)]*)\)",
                                           body)}


def test_source_defines_both_int8_entries_with_the_ctypes_arity():
    found = _entries(SOURCE.read_text())
    i8 = {name for name in found if name.startswith("isc_beam_att_i8_bf16")}
    assert i8 == set(fa8._SIGS) == {"isc_beam_att_i8_bf16",
                                    "isc_beam_att_i8_bf16_tanhf"}
    for name, sig in fa8._SIGS.items():
        params = found[name]
        assert len(params) == len(sig), name
        # pointers (and the stream) as c_void_p, the sizes as c_int
        for p, ct in zip(params, sig):
            assert ("*" in p) == (ct is ctypes.c_void_p), (name, p)


def test_v1_entries_keep_their_arity_beside_the_int8_ones():
    found = _entries(SOURCE.read_text())
    v1 = {fn for v in fa.VARIANTS for fn in fa._FNS[v].values()}
    v1.add(fa._V1_BF16_TANHF)
    assert v1 | set(fa8._SIGS) == set(found)
    for name in v1:
        assert len(found[name]) == len(fa._SIG), name


def test_source_instantiates_every_beam_for_both_tanh_entries():
    src = SOURCE.read_text()
    cases = re.search(r"#define ISC_BEAM_CASES\(CASE\)(.*?)\n\n", src,
                      re.S).group(1)
    assert [int(b) for b in re.findall(r"CASE\((\d+)\)", cases)] == list(
        range(1, fa8.MAX_BEAM + 1))
    launch = src[src.index("int launch_i8("):]
    launch = launch[:launch.index("\n}\n")]
    assert "ISC_BEAM_CASES(ISC_I8_CASE)" in launch
    assert "launch_i8_b<BB, kFast>" in launch
    # the default entry takes tanh.approx.f32, the _tanhf one tanhf
    body = src[src.index('extern "C" {'):]
    assert re.search(r"isc_beam_att_i8_bf16\(.*?return launch_i8<true>",
                     body, re.S)
    assert re.search(r"isc_beam_att_i8_bf16_tanhf\(.*?return launch_i8<false>",
                     body, re.S)


def test_the_first_design_source_is_gone():
    assert not (CSRC / "fused_attention_i8.cu").exists()
    assert sorted(p.name for p in CSRC.glob("fused_attention*")) == [
        "fused_attention.cu"]


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("isc_"):
            return self.fns.setdefault(name, _FakeFn())
        raise AttributeError(name)


def test_both_wrappers_type_their_entries_in_the_one_library(monkeypatch):
    """v1's and the int8 wrapper each pass their own entry points for the
    ``fused_attention`` library: whichever loads it first, every entry
    point of both gets its types."""
    built = []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_typed", set())
    monkeypatch.setattr(_build, "build", built.extend)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    lib = fa8._lib()
    assert built == ["fused_attention"]
    assert fa._lib() is lib and built == ["fused_attention"]
    assert set(lib.fns) == set(fa8._SIGS) | {
        fn for v in fa.VARIANTS for fn in fa._FNS[v].values()} | {
        fa._V1_BF16_TANHF}
    for name, f in lib.fns.items():
        assert f.restype is ctypes.c_int, name
        assert f.argtypes == fa8._SIGS.get(name, fa._SIG), name


_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118beam_att_i8_kernelILi3ELb1EEEvPKfPK13__nv_bfloat16PKaS2_S6_S2_PS3_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118beam_att_i8_kernelILi3ELb1EEEvPKfPK13__nv_bfloat16PKaS2_S6_S2_PS3_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118beam_att_i8_kernelILi8ELb0EEEvPKfPK13__nv_bfloat16PKaS2_S6_S2_PS3_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118beam_att_i8_kernelILi8ELb0EEEvPKfPK13__nv_bfloat16PKaS2_S6_S2_PS3_iii
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 408 bytes cmem[0]
"""


@pytest.mark.parametrize("B,fast,regs,spills", [(3, 1, 72, (0, 0)),
                                                (8, 0, 128, (12, 8))])
def test_ptxas_report_reads_each_entry(B, fast, regs, spills):
    report = _build.ptxas_report(_LOG)
    assert len(report) == 2
    (entry,) = [e for e in report
                if f"beam_att_i8_kernelILi{B}ELb{fast}E" in e]
    assert report[entry] == {"registers": regs, "spill_stores": spills[0],
                             "spill_loads": spills[1]}

"""The CUDA Winograd source's compile-time facts against the Python side:
the zero masks by which its kernels skip the transform matrices' zero
terms, and its C entry points' arguments against the ctypes signatures
(``wino_input`` passes x's strides as 64-bit integers). The kernels' strided
reading of the detector's permuted features is held on the card
(``tests/test_torch_cuda.py``); the plain stack on that view is held in
``test_torch_winograd.py``."""
import re
from pathlib import Path

from insenticap_model_tpu_torch.ops import winograd as twino
from insenticap_model_tpu_torch.ops import winograd_kernels as wk

SOURCE = Path(wk.__file__).resolve().parents[1] / "csrc" / "winograd.cu"


def _mask(m):
    return sum(1 << (r * 7 + c) for r in range(m.shape[0])
               for c in range(m.shape[1]) if m[r, c] != 0)


def test_source_zero_masks_match_the_matrices():
    """The kernels skip the zero terms of B^T and A^T by a compile-time
    mask; it must be the nonzero pattern of the matrices the wrappers
    pass (the host entry points refuse any other)."""
    src = SOURCE.read_text()
    bt = int(re.search(r"kBTMask = (0x[0-9a-f]+)ULL", src).group(1), 16)
    at = int(re.search(r"kATMask = (0x[0-9a-f]+)ULL", src).group(1), 16)
    assert bt == _mask(twino._BT5)
    assert at == _mask(twino._AT5)
    assert bin(bt).count("1") == 34 and bin(at).count("1") == 27


def test_source_entry_points_match_the_ctypes_signatures():
    """Every C entry point of the source takes as many arguments as its
    ctypes signature gives, with a 64-bit type where the signature has
    one."""
    src = SOURCE.read_text()
    body = src[src.index('extern "C" {'):]
    found = {}
    for name, params in re.findall(r"int (isc_wino_\w+)\(([^)]*)\)", body):
        found[name] = [p.strip() for p in params.split(",")]
    assert set(found) == set(wk._SIGS)
    for name, sig in wk._SIGS.items():
        params = found[name]
        assert len(params) == len(sig), name
        for p, ct in zip(params, sig):
            assert p.startswith("long long") == (ct is wk._L), (name, p)

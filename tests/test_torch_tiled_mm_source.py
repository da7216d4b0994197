"""The CUDA row-tiled product's compile-time facts against the Python side:
its C entry point against the ctypes signature, and its slab width, panel
depth, ring stages, wgmma n values and shared-memory budget against the
wrapper's ``plan``, the one function that picks the kernel's path (w
resident in shared memory, or streamed with x), its ring depth and its row
groups. The kernel itself is held against its twin on the card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import pytest

from insenticap_model_tpu_torch.ops import tiled_mm as tmm

SOURCE = Path(tmm.__file__).resolve().parents[1] / "csrc" / "tiled_mm.cu"
STUDY = (("att_lstm", 1536), ("lang_lstm", 1024))   # K; N = 2048, 1152 rows


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_source_entry_point_matches_the_ctypes_signature():
    src = SOURCE.read_text()
    body = src[src.index('extern "C" {'):]
    found = {name: [p.strip() for p in params.split(",")]
             for name, params in re.findall(r"int (isc_\w+)\(([^)]*)\)",
                                            body)}
    assert set(found) == set(tmm._SIGS)
    for name, sig in tmm._SIGS.items():
        params = found[name]
        assert len(params) == len(sig), name
        for p, ct in zip(params, sig):
            pointer = p.startswith(("const void*", "void*"))
            assert pointer == (ct is tmm._P), (name, p)


def test_source_constants_match_the_plan():
    src = SOURCE.read_text()
    assert _const(src, "kSlabCols") == tmm.SLAB_COLS
    assert _const(src, "kPanelK") == tmm.PANEL_K
    assert _const(src, "kSmemBudget") == tmm.SMEM_BUDGET == 232_448
    assert _const(src, "kAlignPad") == tmm.ALIGN_PAD
    assert int(re.search(r"kBarrierBytes = 2 \* 8 \* (\d+);", src)
               .group(1)) == tmm.MAX_STAGES
    assert _const(src, "kMaxStageRows") == tmm.MAX_STAGE_ROWS
    assert _const(src, "kNarrowStage") == tmm.NARROW_STAGE
    assert _const(src, "kWideStage") == tmm.WIDE_STAGE
    assert _const(src, "kMinStages") == tmm.MIN_STAGES
    assert _const(src, "kMaxStages") == tmm.MAX_STAGES
    assert _const(src, "kMaxTileRows") == tmm.MAX_TILE_ROWS
    ns = re.search(r"kTileNs\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in ns.split(",")) == tmm.TILE_NS
    # every n the plan can give has its launch, and every stage's rows
    # their wgmma instance
    for n in tmm.TILE_NS:
        assert f"ISC_TILE_CASE({n})" in src
        sr = tmm.plan(n, n, 64, 64).stage_rows
        assert f"wgmma_rows<{sr}>(float (&d)[{sr // 2}]" in src
        assert f"m64n{sr}k16.f32.bf16.bf16" in src


@pytest.mark.parametrize("tile_rows", [24, 48, 96])
@pytest.mark.parametrize("name,K", STUDY)
def test_plan_keeps_w_resident_at_the_study_shapes(name, K, tile_rows):
    """Both LSTM products at every tile size: the slab stays in shared
    memory, the tile pads no row, the ring has at least two stages, the
    block fits the H100's 232,448 bytes, and 32 slabs x 4 row groups fill
    one wave of 132 SMs."""
    p = tmm.plan(1152, tile_rows, K, 2048)
    assert p.resident and p.n == tile_rows
    assert p.stage_rows == min(tile_rows, 48)
    stage = p.panels * p.stage_rows * 128
    assert stage >= (tmm.WIDE_STAGE if p.wide else tmm.NARROW_STAGE)
    assert K % (64 * p.panels) == 0
    slab = K * tmm.SLAB_COLS * 2
    assert p.smem == tmm.ALIGN_PAD + tmm.BARRIER_BYTES + slab + p.stages * stage
    assert p.smem <= tmm.SMEM_BUDGET
    # two groups' stages at least, so one loads while the other computes
    assert 2 * tile_rows // p.stage_rows <= p.stages <= tmm.MAX_STAGES
    # the deepest ring that fits
    assert p.stages == tmm.MAX_STAGES or p.smem + stage > tmm.SMEM_BUDGET
    assert p.groups == 4 and 32 * p.groups <= tmm.H100_SMS


def test_plan_ring_depths_at_the_study_shapes():
    """att_lstm's 192 KB slab leaves room for 5 narrow stages of 6 KB at
    every tile (two panels of 24 rows, one of 48, one of half a 96-row
    tile); lang_lstm's 128 KB for 8 wide ones of 12 KB."""
    att = [tmm.plan(1152, t, 1536, 2048) for t in (24, 48, 96)]
    assert [(p.wide, p.panels, p.stages) for p in att] == [
        (False, 2, 5), (False, 1, 5), (False, 1, 5)]
    lang = [tmm.plan(1152, t, 1024, 2048) for t in (24, 48, 96)]
    assert [(p.wide, p.panels, p.stages) for p in lang] == [
        (True, 4, 8), (True, 2, 8), (True, 2, 8)]


@pytest.mark.parametrize("tile_rows", [5, 24, 96, 128])
def test_plan_streams_w_where_the_slab_does_not_fit(tile_rows):
    """K = 4096 (a 512 KB slab): w streams with x, a stage carries both
    panels, and the ring still fits."""
    p = tmm.plan(4 * tile_rows, tile_rows, 4096, 520)
    assert not p.resident and p.wide
    stage = p.panels * (p.stage_rows * 128 + tmm.PANEL_K * tmm.SLAB_COLS * 2)
    assert p.smem == tmm.ALIGN_PAD + tmm.BARRIER_BYTES + p.stages * stage
    assert p.smem <= tmm.SMEM_BUDGET
    assert p.stages >= tmm.MIN_STAGES


def test_source_instantiates_every_path_the_plan_picks():
    """The plan gives three paths (w resident in wide or narrow stages, or
    streamed in wide ones), and the source launches those three and no
    fourth: a streamed ring is always wide."""
    src = SOURCE.read_text()
    paths = {(p.resident, p.wide)
             for tile_rows in (1, 5, 24, 48, 96, 128)
             for K in (64, 1024, 1536, 1544, 4096, 16384)
             for p in [tmm.plan(4 * tile_rows, tile_rows, K, 2048)]}
    assert paths == {(True, True), (True, False), (False, True)}
    for resident, wide in paths:
        assert (f"launch<NT, {str(resident).lower()}, "
                f"{str(wide).lower()}>") in src
    assert "launch<NT, false, false>" not in src
    assert "resident == 0 && wide == 0" in src


def test_plan_resident_limit():
    """The last K that stays resident beside two groups' stages of 128
    rows (four stages of one 64-row panel) is 24 panels (1536); of 8 rows
    (stages of six 8-row panels, K padded to whole stages) 24 panels."""
    assert tmm.plan(128, 128, 1536, 64).resident
    assert not tmm.plan(128, 128, 1544, 64).resident
    assert tmm.plan(8, 8, 1536, 64).resident
    assert not tmm.plan(8, 8, 1544, 64).resident


@pytest.mark.parametrize("tile_rows,n,sr", [
    (1, 8, 8), (5, 8, 8), (8, 8, 8), (16, 16, 16), (17, 24, 24),
    (33, 48, 48), (49, 64, 32), (65, 96, 48), (97, 128, 64), (128, 128, 64)])
def test_plan_wgmma_n(tile_rows, n, sr):
    p = tmm.plan(3 * tile_rows, tile_rows, 200, 264)
    assert (p.n, p.stage_rows) == (n, sr)
    assert p.wide and p.panels == -(-tmm.WIDE_STAGE // (sr * 128))


def test_plan_row_groups():
    """As many row groups as fill one wave, never more than the tiles;
    a grid wider than the card gets one group."""
    assert tmm.plan(48, 24, 64, 128).groups == 2       # 2 tiles
    assert tmm.plan(1152, 24, 64, 128, sms=132).groups == 48
    assert tmm.plan(1152, 24, 64, 2048, sms=114).groups == 3
    assert tmm.plan(1152, 24, 64, 64 * 200).groups == 1

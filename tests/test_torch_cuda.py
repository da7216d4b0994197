"""The port's hand-written CUDA kernels against their plain PyTorch twins on
the card, at small and ragged shapes (the serving shapes are
chip_smoke.py's). Marked ``cuda``: each test skips where there is no card.
On a machine with one, run ``python -m pytest tests/test_torch_cuda.py``.

Tolerances: f32 within 1e-4 (another summation order, and tanhf/expf of
the device library against PyTorch's); a bf16 transform output within one
bf16 rounding of the twin's (rtol 1e-2) plus 1e-3 of its scale, since the
two round f32 sums taken in different orders. The fused top-k: values
within 1e-4, indices identical except at near-ties (where the plain
version's neighbouring values differ by at most 1e-4), since the logits
are sums in another order. The max pool: exact equality. The int8-storage
attention and the row-tiled product: within one bf16 ulp of the plain
version (taken at no less than 1e-3 of the output's scale), since both
sides sum in f32 in other orders and round once to bf16."""
import numpy as np
import pytest
import torch

from insenticap_model_tpu_torch import nn
from insenticap_model_tpu_torch.config import Settings
from insenticap_model_tpu_torch.models import captioner as cap
from insenticap_model_tpu_torch.models import sentiment_detector as sd
from insenticap_model_tpu_torch.ops import beam
from insenticap_model_tpu_torch.ops import fused_attention as fa
from insenticap_model_tpu_torch.ops import fused_attention_i8 as fa8
from insenticap_model_tpu_torch.ops import fused_topk as ft
from insenticap_model_tpu_torch.ops import pool
from insenticap_model_tpu_torch.ops import tiled_mm as tmm
from insenticap_model_tpu_torch.ops import winograd_kernels as wk
from insenticap_model_tpu_torch.utils.timing import (device_ms,
                                                     device_ms_by_name)
from insenticap_model_tpu_torch.utils.tolerance import bf16_ulp_error

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol, scale_frac):
    got, want = got.float(), want.float()
    tol = rtol * want.abs() + scale_frac * want.abs().max()
    assert ((got - want).abs() <= tol).all(), \
        float((got - want).abs().max())


def _att_params(g, H, Ah, dev, dtype):
    p = {"h2att": {"weight": torch.randn(Ah, H, generator=g) * 0.2,
                   "bias": torch.randn(Ah, generator=g)},
         "att_alpha": {"weight": torch.randn(1, Ah, generator=g),
                       "bias": torch.randn(1, generator=g)}}
    return {k: {kk: vv.to(dev, dtype) for kk, vv in v.items()}
            for k, v in p.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,B,N", [(1, 3, 196), (7, 3, 50), (5, 1, 9),
                                    (3, 8, 196), (4, 5, 196), (2, 5, 17)])
def test_attention_kernel_matches_twin(dev, dtype, bs, B, N):
    g = torch.Generator().manual_seed(bs * 31 + B)
    H, Ah, Fe = 48, 40, 72
    p = _att_params(g, H, Ah, dev, dtype)
    h = torch.randn(bs * B, H, generator=g).to(dev, dtype)
    att = torch.rand(bs, N, Fe, generator=g).to(dev, dtype)
    p_att = torch.rand(bs, N, Ah, generator=g).to(dev, dtype)
    before = fa.beam_content_attention.launches
    got = fa.beam_content_attention(h, p, att, p_att, B=B)
    torch.cuda.synchronize()
    assert fa.beam_content_attention.launches == before + 1
    want = fa.beam_content_attention_plain(h, p, att, p_att, B=B)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _close(got, want, 1e-2, 1e-3)


@pytest.mark.parametrize("B,N,exact_tanh", [(3, 196, False),
                                            (8, 33, False), (3, 196, True)])
def test_attention_kernel_at_serving_width(dev, B, N, exact_tanh):
    """bf16 at the model's 512 widths (two warps a position, four
    position slices), with the fast and the exact tanh."""
    g = torch.Generator().manual_seed(B + N)
    p = _att_params(g, 512, 512, dev, torch.bfloat16)
    h = torch.randn(2 * B, 512, generator=g).to(dev, torch.bfloat16)
    att = torch.rand(2, N, 512, generator=g).to(dev, torch.bfloat16)
    p_att = torch.rand(2, N, 512, generator=g).to(dev, torch.bfloat16)
    got = fa.beam_content_attention(h, p, att, p_att, B=B,
                                    exact_tanh=exact_tanh)
    torch.cuda.synchronize()
    _close(got, fa.beam_content_attention_plain(h, p, att, p_att, B=B),
           1e-2, 1e-3)


def test_attention_kernel_refuses_what_it_cannot_take(dev):
    p = {"h2att": {"weight": torch.zeros(4, 4, device=dev),
                   "bias": torch.zeros(4, device=dev)},
         "att_alpha": {"weight": torch.zeros(1, 4, device=dev)}}
    att = torch.zeros(2, 3, 4, device=dev)
    with pytest.raises(TypeError):
        fa.beam_content_attention(torch.zeros(6, 4, device=dev).half(), p,
                                  att, att, B=3)
    with pytest.raises(ValueError):
        fa.beam_content_attention(torch.zeros(5, 4, device=dev), p, att,
                                  att, B=3)
    with pytest.raises(ValueError):
        fa.beam_content_attention(torch.zeros(18, 4, device=dev), p, att,
                                  att, B=9)
    # widths kernel_takes refuses: Ah % 8 in bf16, H % 4 in f32
    g = torch.Generator().manual_seed(0)
    p36 = _att_params(g, 48, 36, dev, torch.bfloat16)
    att16 = torch.rand(2, 5, 72, generator=g).to(dev, torch.bfloat16)
    patt36 = torch.rand(2, 5, 36, generator=g).to(dev, torch.bfloat16)
    h16 = torch.rand(6, 48, generator=g).to(dev, torch.bfloat16)
    assert not fa.kernel_takes(3, 48, 36, 72, torch.bfloat16, "v1")
    with pytest.raises(ValueError):
        fa.beam_content_attention(h16, p36, att16, patt36, B=3,
                                  variant="v1")
    p6 = _att_params(g, 6, 8, dev, torch.float32)
    assert not fa.kernel_takes(3, 6, 8, 8, torch.float32, "v1")
    with pytest.raises(ValueError):
        fa.beam_content_attention(torch.rand(6, 6, device=dev), p6,
                                  torch.rand(2, 5, 8, device=dev),
                                  torch.rand(2, 5, 8, device=dev), B=3,
                                  variant="v1")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,bsz,c", [((14, 14), 3, 40), ((11, 13), 5, 7),
                                      ((5, 3), 1, 130)])
def test_winograd_kernels_match_twins(dev, dtype, hw, bsz, c):
    g = torch.Generator().manual_seed(c)
    h, w = hw
    x = torch.randn(h, w, bsz, c, generator=g).to(dev, dtype)
    v = wk.wino_input(x)
    _close(v, wk.wino_input_plain(x), 1e-2 if dtype == torch.bfloat16
           else 1e-5, 1e-3 if dtype == torch.bfloat16 else 1e-5)
    m = torch.randn(v.shape, generator=g).to(dev, dtype)
    bias = torch.randn(c, generator=g).to(dev)
    frac = 1e-3 if dtype == torch.bfloat16 else 1e-5
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    _close(wk.wino_middle(m, bias, h, w),
           wk.wino_middle_plain(m, bias, h, w), rtol, frac)
    _close(wk.wino_output(m, bias, h, w),
           wk.wino_output_plain(m, bias, h, w), rtol, frac)
    torch.cuda.synchronize()


def test_winograd_stack_f32_matches_direct_conv(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 14, 14, 24, generator=g)
    layers = [(torch.randn(3, 3, 24, 12, generator=g) * 0.1,
               torch.randn(12, generator=g)),
              (torch.randn(3, 3, 12, 6, generator=g) * 0.1,
               torch.randn(6, generator=g))]
    from insenticap_model_tpu_torch import nn
    want = x
    for wt, b in layers:
        want = nn.conv2d({"weight": wt, "bias": b}, want)
    got = wk.conv3x3_stack_sm(x.to(dev).permute(1, 2, 0, 3),
                              [(wt.to(dev), b.to(dev)) for wt, b in layers])
    got = got.permute(2, 0, 1, 3).cpu()
    scale = want.abs().max()
    assert ((got - want).abs().max() / scale) < 2e-5


def _wino_tol(dtype):
    """(rtol, scale_frac) of a transform against its twin."""
    return (1e-2, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)


def _wino_x(g, h, w, bsz, c, dtype, dev, layout):
    """x [h, w, bsz, c] laid out as ``layout``: contiguous, the permuted
    view of NHWC features, or contiguous one element past a 16-byte
    boundary."""
    if layout == "permuted":
        return torch.randn(bsz, h, w, c, generator=g).to(
            dev, dtype).permute(1, 2, 0, 3)
    if layout == "offset":
        buf = torch.randn(h * w * bsz * c + 1, generator=g).to(dev, dtype)
        return buf[1:].view(h, w, bsz, c)
    return torch.randn(h, w, bsz, c, generator=g).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "permuted", "offset"])
@pytest.mark.parametrize("hw,bsz,c", [((15, 15), 2, 64), ((6, 6), 3, 1026),
                                      ((1, 1), 4, 7), ((14, 14), 3, 130)])
def test_winograd_input_and_middle_layouts(dev, dtype, layout, hw, bsz, c):
    """The redesigned input and middle kernels against their twins at the
    extents the gate takes (15x15, 6x6, 1x1), channel counts that leave a
    ragged slab (1026, 7, 130), and inputs that are not contiguous or not
    16-byte aligned (the kernels' element-by-element path)."""
    g = torch.Generator().manual_seed(c + hw[0])
    h, w = hw
    rtol, frac = _wino_tol(dtype)
    x = _wino_x(g, h, w, bsz, c, dtype, dev, layout)
    _close(wk.wino_input(x), wk.wino_input_plain(x), rtol, frac)
    th, tw = -(-h // 5), -(-w // 5)
    m = _wino_x(g, 49, th * tw, bsz, c, dtype, dev,
                "offset" if layout == "offset" else "contiguous")
    bias = torch.randn(c, generator=g).to(dev)
    _close(wk.wino_middle(m, bias, h, w), wk.wino_middle_plain(m, bias, h, w),
           rtol, frac)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", ["contiguous", "permuted"])
def test_winograd_kernels_at_the_serving_shape(dev, layout):
    """bs=384, 14x14, 2048 -> 1024, bf16: the input kernel on x as laid
    out, the middle kernel on a product's output, each against its twin,
    and one launch a call."""
    g = torch.Generator().manual_seed(384)
    x = _wino_x(g, 14, 14, 384, 2048, torch.bfloat16, dev, layout)
    before = wk.wino_input.launches
    v = wk.wino_input(x)
    assert wk.wino_input.launches == before + 1
    _close(v, wk.wino_input_plain(x), 1e-2, 1e-3)
    del v
    m = torch.randn(49, 9, 384, 1024, generator=g).to(dev, torch.bfloat16)
    bias = torch.randn(1024, generator=g).to(dev)
    before = wk.wino_middle.launches
    v2 = wk.wino_middle(m, bias, 14, 14)
    assert wk.wino_middle.launches == before + 1
    _close(v2, wk.wino_middle_plain(m, bias, 14, 14), 1e-2, 1e-3)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "offset"])
@pytest.mark.parametrize("hw,bsz,c", [((15, 15), 2, 64), ((6, 6), 3, 1026),
                                      ((1, 1), 4, 7), ((14, 14), 3, 130)])
def test_winograd_output_layouts(dev, dtype, layout, hw, bsz, c):
    """The redesigned output kernel against its twin at the extents the
    gate takes, channel counts that leave a ragged slab (1026, 130) or are
    odd (7), and an M one element past a 16-byte boundary (the kernel's
    element-by-element path)."""
    g = torch.Generator().manual_seed(c + hw[0] + 1)
    h, w = hw
    rtol, frac = _wino_tol(dtype)
    th, tw = -(-h // 5), -(-w // 5)
    m = _wino_x(g, 49, th * tw, bsz, c, dtype, dev, layout)
    bias = torch.randn(c, generator=g).to(dev)
    before = wk.wino_output.launches
    got = wk.wino_output(m, bias, h, w)
    assert wk.wino_output.launches == before + 1
    want = wk.wino_output_plain(m, bias, h, w)
    assert got.shape == (h, w, bsz, c) and got.dtype == dtype
    _close(got, want, rtol, frac)
    torch.cuda.synchronize()


def test_winograd_output_at_the_serving_shape(dev):
    """bs=384, 14x14, K=512, bf16: the output kernel sums as its twin does
    (the same f32 terms in the same order, A^T's zeros skipped) and rounds
    once, so the two are equal."""
    g = torch.Generator().manual_seed(512)
    m = torch.randn(49, 9, 384, 512, generator=g).to(dev, torch.bfloat16)
    bias = torch.randn(512, generator=g).to(dev)
    got = wk.wino_output(m, bias, 14, 14)
    torch.cuda.synchronize()
    assert torch.equal(got, wk.wino_output_plain(m, bias, 14, 14))


def test_winograd_stack_reads_the_permuted_view_in_place(dev):
    """The bf16 stack on the detector's permuted features equals the stack
    on their contiguous copy, one launch of each kernel a call."""
    g = torch.Generator().manual_seed(5)
    feats = torch.randn(6, 14, 14, 40, generator=g).to(dev, torch.bfloat16)
    layers = [(torch.randn(3, 3, 40, 24, generator=g).to(dev, torch.bfloat16)
               * 0.1, torch.randn(24, generator=g).to(dev, torch.bfloat16)),
              (torch.randn(3, 3, 24, 8, generator=g).to(dev, torch.bfloat16)
               * 0.1, torch.randn(8, generator=g).to(dev, torch.bfloat16))]
    counts = [wk.wino_input.launches, wk.wino_middle.launches,
              wk.wino_output.launches]
    got = wk.conv3x3_stack_sm(feats.permute(1, 2, 0, 3), layers)
    assert [wk.wino_input.launches, wk.wino_middle.launches,
            wk.wino_output.launches] == [n + 1 for n in counts]
    want = wk.conv3x3_stack_sm(feats.permute(1, 2, 0, 3).contiguous(),
                               layers)
    assert torch.equal(got, want)


def test_decode_kernel_path_matches_plain_path(dev):
    """detect_and_decode on the card, kernels against plain, f32."""
    from insenticap_model_tpu_torch import inference
    s = Settings(word_emb_dim=32, fc_feat_dim=64, att_feat_dim=64,
                 feat_emb_dim=32, rnn_hid_dim=32, att_hid_dim=32)
    ids = cap.TokenIds(0, 1, 2, 3, 2)
    gen = torch.Generator().manual_seed(0)
    params = inference.ServingParams(
        cap.init_params(gen, 50, 3, s, device=dev),
        sd.init_params(gen, 3, s, device=dev))
    g = torch.Generator().manual_seed(1)
    fc = torch.rand(6, 64, generator=g).to(dev)
    att = torch.rand(6, 14, 14, 64, generator=g).to(dev)
    sentis = torch.randint(4, 50, (6, 5), generator=g).to(dev)
    before = fa.beam_content_attention.launches
    got = inference.detect_and_decode(params, fc, att, sentis, settings=s,
                                      ids=ids, max_seq_len=8)
    assert fa.beam_content_attention.launches > before
    want = inference.detect_and_decode(params, fc, att, sentis, settings=s,
                                       ids=ids, max_seq_len=8,
                                       use_kernels=False)
    torch.testing.assert_close(got[2], want[2])
    torch.testing.assert_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    assert beam.NEG_INF < got[1].min()


def _topk_agrees(got, want, tol=1e-4):
    """got = kernel (v, i) [rows, k]; want = plain (v, i) [rows, k + 1]."""
    gv, gi = (x.cpu() for x in got)
    wv, wi = (x.cpu() for x in want)
    k = gv.shape[1]
    torch.testing.assert_close(gv, wv[:, :k], rtol=0, atol=tol)
    for r, j in (gi != wi[:, :k]).nonzero().tolist():
        gaps = [abs(float(wv[r, j] - wv[r, q])) for q in (j - 1, j + 1)
                if 0 <= q <= k]
        assert min(gaps) <= tol, (r, j, gi[r].tolist(), wi[r].tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,V,H,k", [
    (1, 1, 40, 3), (7, 1, 40, 8), (7, 300, 40, 1), (7, 300, 40, 8),
    (1153, 300, 48, 5), (64, 129, 56, 2), (1, 10_000, 512, 3),
    (1153, 10_000, 512, 3)])
def test_topk_kernel_matches_plain(dev, dtype, rows, V, H, k):
    g = torch.Generator().manual_seed(rows + V + k)
    h = torch.randn(rows, H, generator=g).to(dev, dtype)
    w = (torch.randn(V, H, generator=g) * 0.1).to(dev, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(dev, dtype)
    last = torch.randint(-1, V, (rows,), generator=g).to(dev)
    banned = (0, 1, 2) if V > 3 else ()
    before = ft.classifier_topk.launches
    got = ft.classifier_topk(h, w, b, last, k=k, banned=banned)
    torch.cuda.synchronize()
    assert ft.classifier_topk.launches == before + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    want = ft.classifier_topk_plain(h, w, b, last, k=k + 1, banned=banned)
    _topk_agrees(got, want)
    gi = got[1].cpu()
    real = got[0].cpu() > ft.NEG_INF
    assert not (real & torch.isin(gi, torch.tensor(banned, dtype=torch.long))
                ).any()
    assert not (real & (gi == last.cpu()[:, None])).any()
    # no last-word bans at all
    got = ft.classifier_topk(h, w, b, None, k=k, banned=banned)
    want = ft.classifier_topk_plain(h, w, b, None, k=k + 1, banned=banned)
    _topk_agrees(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_breaks_ties_to_the_lower_index(dev, dtype):
    """Words 150..299 repeat words 0..149 exactly: in every row a twin
    comes after its original."""
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(150, 64, generator=g) * 0.1).repeat(2, 1)
    b = (torch.randn(150, generator=g) * 0.1).repeat(2)
    h = torch.randn(9, 64, generator=g)
    w, b, h = (x.to(dev, dtype) for x in (w, b, h))
    v, i = ft.classifier_topk(h, w, b, None, k=8)
    vp, ip = ft.classifier_topk_plain(h.cpu(), w.cpu(), b.cpu(), None, k=8)
    torch.testing.assert_close(v.cpu(), vp, rtol=0, atol=1e-4)
    for row in i.cpu().tolist():
        assert row[0::2] == [x - 150 for x in row[1::2]], row


def test_topk_kernel_refuses_what_it_cannot_take(dev):
    h = torch.zeros(4, 8, device=dev)
    w = torch.zeros(20, 8, device=dev)
    b = torch.zeros(20, device=dev)
    with pytest.raises(ValueError):
        ft.classifier_topk(h, w, b, None, k=9)
    with pytest.raises(ValueError):
        ft.classifier_topk(h, w, b, None, k=3, banned=tuple(range(9)))
    with pytest.raises(TypeError):
        ft.classifier_topk(h, w.bfloat16(), b, None, k=3)
    with pytest.raises(TypeError):
        ft.classifier_topk(h.half(), w.half(), b.half(), None, k=3)
    with pytest.raises(ValueError):
        ft.classifier_topk(h, w[:, :4], b, None, k=3)
    with pytest.raises(ValueError):
        ft.classifier_topk(h, w, b, torch.zeros(5, dtype=torch.long,
                                                 device=dev), k=3)


def _topk_inputs(g, rows, V, H, dev, dtype):
    h = torch.randn(rows, H, generator=g).to(dev, dtype)
    w = (torch.randn(V, H, generator=g) * 0.1).to(dev, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(dev, dtype)
    return h, w, b


def _groups(rows, V, dtype, dev):
    """The (first, end) vocab tiles of each partial's range: the bf16
    kernel's groups, or one 128-word tile each in f32."""
    tiles = -(-V // ft.VOCAB_TILE)
    n = (ft.vocab_groups(rows, V, torch.cuda.get_device_properties(
        dev).multi_processor_count) if dtype == torch.bfloat16 else tiles)
    return [(q * tiles // n, (q + 1) * tiles // n) for q in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, 9))
def test_topk_kernel_every_k(dev, dtype, k):
    """Every K instance of the bf16 pass (and the f32 tiles) at the serving
    width and vocabulary, with the beam's bans."""
    g = torch.Generator().manual_seed(k)
    h, w, b = _topk_inputs(g, 300, 10_000, 512, dev, dtype)
    last = torch.randint(-1, 10_000, (300,), generator=g).to(dev)
    got = ft.classifier_topk(h, w, b, last, k=k, banned=(0, 1, 2))
    torch.cuda.synchronize()
    _topk_agrees(got, ft.classifier_topk_plain(h, w, b, last, k=k + 1,
                                               banned=(0, 1, 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 127, 129, 1153])
@pytest.mark.parametrize("V", [1, 129, 10_000])
def test_topk_kernel_rows_and_vocab(dev, dtype, rows, V):
    """Ragged row blocks (128 rows) and vocab tiles (128 words), one word
    to the serving vocabulary; K = 3 with the beam's bans."""
    g = torch.Generator().manual_seed(rows + V)
    h, w, b = _topk_inputs(g, rows, V, 64, dev, dtype)
    last = torch.randint(-1, V, (rows,), generator=g).to(dev)
    banned = (0, 1, 2) if V > 3 else ()
    got = ft.classifier_topk(h, w, b, last, k=3, banned=banned)
    torch.cuda.synchronize()
    _topk_agrees(got, ft.classifier_topk_plain(h, w, b, last, k=4,
                                               banned=banned))
    if V == 1:   # one candidate or none: the empty slots hold (-1e30, 0)
        assert (got[0][:, 1:] == ft.NEG_INF).all()
        assert (got[1][:, 1:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_ties_across_vocab_groups(dev, dtype):
    """Two words with the same weights and bias in two different vocab
    groups (partials) lead every row: the lower index comes first; a banned
    word above both and each row's last word stay out."""
    rows, V, H = 1153, 10_000, 64
    g = torch.Generator().manual_seed(11)
    h, w, b = _topk_inputs(g, rows, V, H, dev, dtype)
    grp = _groups(rows, V, dtype, dev)
    assert len(grp) > 2
    a = grp[0][0] * ft.VOCAB_TILE + 5               # in the first group
    z = grp[len(grp) // 2][0] * ft.VOCAB_TILE + 7   # in a middle group
    w[z] = w[a]
    b[a] = b[z] = 16.0
    b[1] = 20.0                                      # banned, above both
    last = torch.randint(3, V, (rows,), generator=g).to(dev)
    last[(last == a) | (last == z)] = 3
    last[::2] = a                                    # half the rows ban a
    v, i = ft.classifier_topk(h, w, b, last, k=4, banned=(0, 1, 2))
    torch.cuda.synchronize()
    i = i.cpu()
    assert (i[1::2, 0] == a).all() and (i[1::2, 1] == z).all()
    assert (i[::2, 0] == z).all() and not (i[::2] == a).any()
    torch.testing.assert_close(v[1::2, 0], v[1::2, 1], rtol=0, atol=0)
    _topk_agrees((v, i), ft.classifier_topk_plain(h, w, b, last, k=5,
                                                  banned=(0, 1, 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_bans_last_at_group_boundaries(dev, dtype):
    """The first and last word of every vocab group lead; each row's last
    word is one of them, and it alone stays out."""
    rows, V, H = 1153, 10_000, 64
    g = torch.Generator().manual_seed(12)
    h, w, b = _topk_inputs(g, rows, V, H, dev, dtype)
    edges = sorted({x for t0, t1 in _groups(rows, V, dtype, dev)
                    for x in (t0 * ft.VOCAB_TILE,
                              min(t1 * ft.VOCAB_TILE, V) - 1)})
    b[edges] = 6.0 + torch.arange(len(edges), device=dev).to(dtype) * 0.25
    last = torch.tensor(edges, device=dev)[
        torch.arange(rows, device=dev) % len(edges)]
    got = ft.classifier_topk(h, w, b, last, k=8)
    torch.cuda.synchronize()
    gi = got[1].cpu()
    assert not (gi == last.cpu()[:, None]).any()
    assert torch.isin(gi, torch.tensor(edges)).all()
    _topk_agrees(got, ft.classifier_topk_plain(h, w, b, last, k=9))


@pytest.mark.parametrize("rows,H,V", [(128, 512, 128), (129, 56, 300),
                                      (1152, 512, 10_000), (7, 640, 200)])
def test_topk_wgmma_product_matches_matmul(dev, rows, H, V):
    """The bf16 pass's product alone (h resident in the 128-byte swizzle,
    W through the cp.async ring, wgmma m64n128k16) against the f32
    library product of the same bf16 values: products exact in f32, sums
    in another order."""
    g = torch.Generator().manual_seed(rows + H)
    h, w, _ = _topk_inputs(g, rows, V, H, dev, torch.bfloat16)
    got = ft.wgmma_product(h, w)
    torch.cuda.synchronize()
    with nn.exact_numerics():
        want = h.float() @ w.float().t()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_topk_kernel_refuses_an_h_it_cannot_take(dev, monkeypatch):
    """bf16 rows that are not 16-byte multiples, or wider than h's panels
    in shared memory, are refused (f32 takes any width, here 33); a bf16
    beam at such a width decodes on
    the plain tail under ISC_FUSED_TOPK=1, with no top-k launch, exactly
    as use_kernels=False does."""
    g = torch.Generator().manual_seed(0)
    for H in (36, ft.MAX_H_BF16 + 8):
        assert not ft.kernel_takes(3, H, torch.bfloat16)
        assert ft.kernel_takes(3, H, torch.float32)
        h, w, b = _topk_inputs(g, 6, 50, H, dev, torch.bfloat16)
        with pytest.raises(ValueError, match="kernel_takes"):
            ft.classifier_topk(h, w, b, None, k=3)
    # the f32 kernel takes any width
    h, w, b = _topk_inputs(g, 64, 129, 33, dev, torch.float32)
    _topk_agrees(ft.classifier_topk(h, w, b, None, k=2),
                 ft.classifier_topk_plain(h, w, b, None, k=3))
    monkeypatch.setenv("ISC_FUSED_TOPK", "1")
    s = Settings(word_emb_dim=32, fc_feat_dim=64, att_feat_dim=64,
                 feat_emb_dim=32, rnn_hid_dim=36, att_hid_dim=32)
    ids = cap.TokenIds(0, 1, 2, 3, 2)
    params = cap.init_params(torch.Generator().manual_seed(0), 50, 3, s,
                             device=dev, dtype=torch.bfloat16)
    fc = torch.rand(6, 64, generator=g).to(dev, torch.bfloat16)
    att = torch.rand(6, 14, 14, 64, generator=g).to(dev, torch.bfloat16)
    ctx = cap.build_visual_context(
        params, fc, att, senti_words=torch.randint(4, 50, (6, 5),
                                                   generator=g).to(dev),
        senti_labels=torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32,
                                  device=dev), pad_id=ids.pad)
    kw = dict(settings=s, ids=ids, beam_size=3, max_seq_len=8, mode="rl")
    before = ft.classifier_topk.launches
    got = beam.beam_search_batched(params, ctx, **kw)
    assert ft.classifier_topk.launches == before
    want = beam.beam_search_batched(params, ctx, use_kernels=False, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,B,N,Fe", [(1, 3, 196, 72), (7, 3, 50, 72),
                                       (5, 1, 9, 72), (3, 8, 196, 72),
                                       (2, 3, 30, 1032)])
def test_attention_v2_kernel_matches_plain(dev, dtype, bs, B, N, Fe):
    g = torch.Generator().manual_seed(bs * 31 + B + Fe)
    H, Ah = 48, 40
    p = _att_params(g, H, Ah, dev, dtype)
    h = torch.randn(bs * B, H, generator=g).to(dev, dtype)
    att = torch.rand(bs, N, Fe, generator=g).to(dev, dtype)
    p_att = torch.rand(bs, N, Ah, generator=g).to(dev, dtype)
    before = (fa.beam_content_attention.launches,
              fa.beam_content_attention.launches_v2)
    got = fa.beam_content_attention(h, p, att, p_att, B=B, variant="v2")
    torch.cuda.synchronize()
    assert (fa.beam_content_attention.launches,
            fa.beam_content_attention.launches_v2) == (before[0],
                                                       before[1] + 1)
    want = fa.beam_content_attention_plain(h, p, att, p_att, B=B,
                                           variant="v2")
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _close(got, want, 1e-2, 1e-3)


def test_attention_v2_kernel_refuses_what_it_cannot_take(dev):
    """v2 runs on v1's kernel, so it refuses what v1 refuses."""
    g = torch.Generator().manual_seed(0)
    att = torch.rand(2, 5, 16, generator=g).to(dev)
    h = torch.rand(6, 32, generator=g).to(dev)
    p = _att_params(g, 32, 16, dev, torch.float32)
    with pytest.raises(ValueError):      # H % 16 in bf16
        fa.beam_content_attention(
            h[:, :24].bfloat16(), _att_params(g, 24, 16, dev,
                                              torch.bfloat16),
            att.bfloat16(), att.bfloat16(), B=3, variant="v2")
    with pytest.raises(ValueError):      # Fe % 4 in f32
        fa.beam_content_attention(h, p, att[..., :10], att, B=3,
                                  variant="v2")
    with pytest.raises(ValueError):      # a beam wider than 8
        fa.beam_content_attention(torch.rand(18, 32, device=dev), p, att,
                                  att, B=9, variant="v2")
    with pytest.raises(ValueError):
        fa.beam_content_attention(h, p, att, att, B=3, variant="v3")
    with pytest.raises(TypeError):
        fa.beam_content_attention(h.bfloat16(), p, att, att, B=3,
                                  variant="v2")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", range(1, 9))
def test_attention_v2_runs_on_v1s_kernel_at_every_beam(dev, dtype, B):
    """v2 through v1's beam_att_kernel (kRoundW) at B = 1..8, at widths
    only v1's predicate took (H % 16 != 0 in f32), against its plain
    version; counted as v2, not v1."""
    g = torch.Generator().manual_seed(B)
    H = 24 if dtype == torch.float32 else 48
    Ah, Fe, bs, N = 40, 72, 3, 50
    assert fa.kernel_takes(B, H, Ah, Fe, dtype, "v2")
    p = _att_params(g, H, Ah, dev, dtype)
    h = torch.randn(bs * B, H, generator=g).to(dev, dtype)
    att = torch.rand(bs, N, Fe, generator=g).to(dev, dtype)
    p_att = torch.rand(bs, N, Ah, generator=g).to(dev, dtype)
    before = (fa.beam_content_attention.launches,
              fa.beam_content_attention.launches_v2)
    got = fa.beam_content_attention(h, p, att, p_att, B=B, variant="v2")
    torch.cuda.synchronize()
    assert (fa.beam_content_attention.launches,
            fa.beam_content_attention.launches_v2) == (before[0],
                                                       before[1] + 1)
    want = fa.beam_content_attention_plain(h, p, att, p_att, B=B,
                                           variant="v2")
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _close(got, want, 1e-2, 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (32, 224, 224, 64), (32, 192, 256, 64),     # the serving buckets' stems
    (3, 111, 97, 64), (2, 14, 14, 8), (1, 13, 13, 4), (2, 7, 7, 3),
    (9, 14, 14, 64), (2, 2, 5, 16), (1, 36, 26, 12)])
def test_pool_kernel_equals_plain(dev, dtype, shape):
    """Exact: max is exact. C = 3, 4 and 12 take the scalar path in bf16
    (and 3 in f32); the rest the 16-byte path."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(dev, dtype)
    before = pool.ceil_maxpool_3x3s2_nhwc.launches
    got = pool.ceil_maxpool_3x3s2_nhwc(x)
    torch.cuda.synchronize()
    assert pool.ceil_maxpool_3x3s2_nhwc.launches == before + 1
    want = pool.ceil_maxpool_3x3s2_plain(x)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    sm = pool.ceil_maxpool_3x3s2_sm(x.permute(1, 2, 0, 3).contiguous())
    assert torch.equal(sm.permute(2, 0, 1, 3), want)
    assert pool.ceil_maxpool_3x3s2_nhwc.launches == before + 2


def test_pool_kernel_strided_and_unaligned_views(dev):
    """A view with other strides, and one whose first channel is not
    16-byte aligned (the scalar path), still equal the plain version."""
    g = torch.Generator().manual_seed(0)
    big = torch.randn(4, 30, 40, 72, generator=g).to(dev, torch.bfloat16)
    for x in (big[::2, 1:, ::3], big[..., 8:], big[..., 1:65]):
        assert torch.equal(pool.ceil_maxpool_3x3s2_nhwc(x),
                           pool.ceil_maxpool_3x3s2_plain(x))
    nan = big[:1, :5, :5].clone()
    nan[0, 1, 1, 0] = float("nan")
    assert pool.ceil_maxpool_3x3s2_nhwc(nan)[0, 0, 0, 0].isnan()


def test_pool_kernel_refuses_what_it_cannot_take(dev):
    x = torch.zeros(2, 9, 9, 8, device=dev)
    with pytest.raises(ValueError):               # a CPU tensor
        pool._launch(x.cpu(), torch.empty(2, 4, 4, 8))
    with pytest.raises(ValueError):               # channels not contiguous
        pool.ceil_maxpool_3x3s2_nhwc(x.permute(0, 3, 1, 2))
    with pytest.raises(TypeError):
        pool.ceil_maxpool_3x3s2_nhwc(x.half())
    with pytest.raises(ValueError):               # no window fits
        pool.ceil_maxpool_3x3s2_nhwc(x[:, :1])


def test_encoder_kernel_path_matches_plain_path(dev):
    """forward_raw_batch at full depth on the card, f32: the pool kernel
    against the plain pool (1e-5 of scale: cuDNN may pick another
    algorithm between calls)."""
    from insenticap_model_tpu_torch.models import encoder
    p = encoder.init_params(torch.Generator().manual_seed(0), device=dev)
    imgs = torch.randint(0, 256, (2, 96, 80, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    before = pool.ceil_maxpool_3x3s2_nhwc.launches
    fc, att = encoder.forward_raw_batch(p, imgs)
    assert pool.ceil_maxpool_3x3s2_nhwc.launches == before + 1
    fcp, attp = encoder.forward_raw_batch(p, imgs, use_kernels=False)
    assert pool.ceil_maxpool_3x3s2_nhwc.launches == before + 1
    for a, b in ((fc, fcp), (att, attp)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_decode_with_both_switches_matches_plain_path(dev, monkeypatch):
    """ISC_FUSED_TOPK=1 and ISC_ATT_KERNEL=v2: detect_and_decode on the
    card, both new kernels against the plain path, f32."""
    from insenticap_model_tpu_torch import inference
    monkeypatch.setenv("ISC_FUSED_TOPK", "1")
    monkeypatch.setenv("ISC_ATT_KERNEL", "v2")
    s = Settings(word_emb_dim=32, fc_feat_dim=64, att_feat_dim=64,
                 feat_emb_dim=32, rnn_hid_dim=32, att_hid_dim=32)
    ids = cap.TokenIds(0, 1, 2, 3, 2)
    gen = torch.Generator().manual_seed(0)
    params = inference.ServingParams(
        cap.init_params(gen, 50, 3, s, device=dev),
        sd.init_params(gen, 3, s, device=dev))
    g = torch.Generator().manual_seed(1)
    fc = torch.rand(6, 64, generator=g).to(dev)
    att = torch.rand(6, 14, 14, 64, generator=g).to(dev)
    sentis = torch.randint(4, 50, (6, 5), generator=g).to(dev)
    before = (ft.classifier_topk.launches,
              fa.beam_content_attention.launches_v2)
    got = inference.detect_and_decode(params, fc, att, sentis, settings=s,
                                      ids=ids, max_seq_len=8)
    assert ft.classifier_topk.launches > before[0]
    assert fa.beam_content_attention.launches_v2 > before[1]
    want = inference.detect_and_decode(params, fc, att, sentis, settings=s,
                                       ids=ids, max_seq_len=8,
                                       use_kernels=False)
    torch.testing.assert_close(got[2], want[2])
    torch.testing.assert_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused_topk", [False, True])
def test_decode_beam_9_takes_the_plain_cell(dev, monkeypatch, fused_topk):
    """A beam wider than the kernels take decodes on the card through the
    plain cell and the plain tail, token for token the use_kernels=False
    path, and launches neither kernel."""
    from insenticap_model_tpu_torch import inference
    if fused_topk:
        monkeypatch.setenv("ISC_FUSED_TOPK", "1")
    else:
        monkeypatch.delenv("ISC_FUSED_TOPK", raising=False)
    monkeypatch.delenv("ISC_ATT_KERNEL", raising=False)
    s = Settings(word_emb_dim=32, fc_feat_dim=64, att_feat_dim=64,
                 feat_emb_dim=32, rnn_hid_dim=32, att_hid_dim=32)
    ids = cap.TokenIds(0, 1, 2, 3, 2)
    gen = torch.Generator().manual_seed(0)
    params = inference.ServingParams(
        cap.init_params(gen, 50, 3, s, device=dev),
        sd.init_params(gen, 3, s, device=dev))
    g = torch.Generator().manual_seed(1)
    fc = torch.rand(6, 64, generator=g).to(dev)
    att = torch.rand(6, 14, 14, 64, generator=g).to(dev)
    sentis = torch.randint(4, 50, (6, 5), generator=g).to(dev)
    before = (fa.beam_content_attention.launches, ft.classifier_topk.launches)
    got = inference.detect_and_decode(params, fc, att, sentis, settings=s,
                                      ids=ids, beam_size=9, max_seq_len=8)
    assert (fa.beam_content_attention.launches,
            ft.classifier_topk.launches) == before
    want = inference.detect_and_decode(params, fc, att, sentis, settings=s,
                                       ids=ids, beam_size=9, max_seq_len=8,
                                       use_kernels=False)
    assert got[0].shape[1] == 9
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_every_wrapper_raises_under_grad(dev):
    """No kernel has a backward: each CUDA wrapper refuses an operand that
    requires grad while grad mode is on, and runs under no_grad."""
    g = torch.Generator().manual_seed(0)
    p = _att_params(g, 48, 40, dev, torch.bfloat16)
    h = torch.randn(6, 48, generator=g).to(dev, torch.bfloat16)
    att = torch.rand(2, 9, 72, generator=g).to(dev, torch.bfloat16)
    p_att = torch.rand(2, 9, 40, generator=g).to(dev, torch.bfloat16)
    hq, p8, aq, as_, pq, ps = _i8_inputs(g, 2, 3, 9, 48, 32, 32, dev,
                                         torch.bfloat16)
    w_cls = torch.randn(50, 48, generator=g).to(dev, torch.bfloat16)
    b_cls = torch.zeros(50, device=dev, dtype=torch.bfloat16)
    x_sm = torch.randn(14, 14, 2, 8, generator=g).to(dev, torch.bfloat16)
    m = torch.randn(49, 9, 2, 8, generator=g).to(dev, torch.bfloat16)
    bias = torch.zeros(8, device=dev)
    x_pool = torch.randn(2, 9, 9, 8, generator=g).to(dev)
    x_mm = torch.randn(48, 64, generator=g).to(dev, torch.bfloat16)
    w_mm = torch.randn(64, 128, generator=g).to(dev, torch.bfloat16)
    calls = [
        lambda r: fa.beam_content_attention(r(h), p, att, p_att, B=3),
        lambda r: fa.beam_content_attention(h, p, r(att), p_att, B=3,
                                            variant="v2"),
        lambda r: fa8.beam_content_attention_i8(r(hq), p8, aq, as_, pq, ps,
                                                B=3),
        lambda r: ft.classifier_topk(h, r(w_cls), b_cls, None, k=3),
        lambda r: wk.wino_input(r(x_sm)),
        lambda r: wk.wino_middle(r(m), bias, 14, 14),
        lambda r: wk.wino_output(m, r(bias), 14, 14),
        lambda r: pool.ceil_maxpool_3x3s2_nhwc(r(x_pool)),
        lambda r: pool.ceil_maxpool_3x3s2_sm(r(x_pool)),
        lambda r: tmm.tiled_mm(r(x_mm), w_mm, tile_rows=24),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call(lambda x: x.detach().requires_grad_(True))
        with torch.no_grad():
            call(lambda x: x.detach().requires_grad_(True))
    torch.cuda.synchronize()


def _within_bf16_ulp(got, want):
    err, ulps = bf16_ulp_error(got, want)
    assert ulps <= 1, (ulps, err)


def _i8_inputs(g, bs, B, N, H, Ah, Fe, dev, dtype):
    p = _att_params(g, H, Ah, dev, dtype)
    h = torch.randn(bs * B, H, generator=g).to(dev, dtype)
    att_q, att_s = fa8.quantize_per_channel(
        torch.randn(bs, N, Fe, generator=g).to(dev))
    p_att_q, p_att_s = fa8.quantize_per_channel(
        torch.randn(bs, N, Ah, generator=g).to(dev))
    return h, p, att_q, att_s, p_att_q, p_att_s


@pytest.mark.parametrize("bs,B,N,Fe", [
    (1, 3, 196, 80), (7, 3, 50, 80), (5, 1, 9, 80), (3, 8, 196, 80),
    (9, 2, 17, 1040), (3, 4, 33, 512), (1, 5, 7, 16), (11, 6, 20, 96),
    (2, 7, 31, 48)])
def test_attention_i8_kernel_matches_plain(dev, bs, B, N, Fe):
    g = torch.Generator().manual_seed(bs * 31 + B + Fe)
    args = _i8_inputs(g, bs, B, N, 48, 32, Fe, dev, torch.bfloat16)
    before = fa8.beam_content_attention_i8.launches
    got = fa8.beam_content_attention_i8(*args, B=B)
    torch.cuda.synchronize()
    assert fa8.beam_content_attention_i8.launches == before + 1
    want = fa8.beam_content_attention_i8_plain(*args, B=B)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _within_bf16_ulp(got, want)


def test_attention_i8_kernel_refuses_what_it_cannot_take(dev):
    g = torch.Generator().manual_seed(0)
    h, p, aq, as_, pq, ps = _i8_inputs(g, 2, 3, 5, 48, 32, 32, dev,
                                       torch.bfloat16)
    f = fa8.beam_content_attention_i8
    with pytest.raises(TypeError):                    # h and W differ
        f(h.float(), p, aq, as_, pq, ps, B=3)
    with pytest.raises(TypeError):                    # f32: plain only
        f(h.float(), {k: {kk: vv.float() for kk, vv in v.items()}
                      for k, v in p.items()}, aq, as_, pq, ps, B=3)
    with pytest.raises(TypeError):                    # att not int8
        f(h, p, aq.float(), as_, pq, ps, B=3)
    with pytest.raises(TypeError):                    # scales not f32
        f(h, p, aq, as_.double(), pq, ps, B=3)
    with pytest.raises(ValueError):                   # h rows != bs * B
        f(h[:5], p, aq, as_, pq, ps, B=3)
    with pytest.raises(ValueError):                   # B > 8
        f(torch.cat([h, h, h]), p, aq, as_, pq, ps, B=9)
    with pytest.raises(ValueError):                   # Fe % 16
        f(h, p, aq[..., :24].contiguous(), as_[..., :24].contiguous(), pq,
          ps, B=3)


@pytest.mark.parametrize("exact_tanh", [False, True])
@pytest.mark.parametrize("B", range(1, 9))
def test_attention_i8_kernel_at_every_beam(dev, B, exact_tanh):
    """Every instance, both tanh entries; 33 positions (a ring stage and
    one more)."""
    g = torch.Generator().manual_seed(100 + B)
    args = _i8_inputs(g, 3, B, 33, 48, 32, 80, dev, torch.bfloat16)
    before = fa8.beam_content_attention_i8.launches
    got = fa8.beam_content_attention_i8(*args, B=B, exact_tanh=exact_tanh)
    torch.cuda.synchronize()
    assert fa8.beam_content_attention_i8.launches == before + 1
    _within_bf16_ulp(got, fa8.beam_content_attention_i8_plain(*args, B=B))


@pytest.mark.parametrize("exact_tanh", [False, True])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 196])
def test_attention_i8_kernel_at_ring_stage_edges(dev, N, exact_tanh):
    """A stage holds 32 positions: N below, at and past its edge, and the
    serving N, at the serving width."""
    g = torch.Generator().manual_seed(200 + N)
    args = _i8_inputs(g, 2, 3, N, 64, 512, 512, dev, torch.bfloat16)
    got = fa8.beam_content_attention_i8(*args, B=3, exact_tanh=exact_tanh)
    torch.cuda.synchronize()
    _within_bf16_ulp(got, fa8.beam_content_attention_i8_plain(*args, B=3))


@pytest.mark.parametrize("exact_tanh", [False, True])
@pytest.mark.parametrize("Ah,Fe", [(16, 16), (80, 80), (512, 512),
                                   (1040, 1040), (16, 1040), (1040, 16),
                                   (512, 80), (2048, 2048)])
def test_attention_i8_kernel_at_every_width(dev, Ah, Fe, exact_tanh):
    """Widths from one 16-byte copy to the 2048 a block's lanes own, a
    position spanning one to eight warps; H = 40 is a multiple of 8 and
    not of the query product's K step of 16 (the rest staged as zeros)."""
    g = torch.Generator().manual_seed(Ah + 3 * Fe)
    args = _i8_inputs(g, 3, 3, 37, 40, Ah, Fe, dev, torch.bfloat16)
    got = fa8.beam_content_attention_i8(*args, B=3, exact_tanh=exact_tanh)
    torch.cuda.synchronize()
    _within_bf16_ulp(got, fa8.beam_content_attention_i8_plain(*args, B=3))


@pytest.mark.parametrize("exact_tanh", [False, True])
def test_attention_i8_kernel_with_all_zero_channels(dev, exact_tanh):
    """A channel that is zero over an image's positions quantises with the
    scale 1e-12 and values 0; some are, in att and in p_att."""
    g = torch.Generator().manual_seed(7)
    p = _att_params(g, 48, 64, dev, torch.bfloat16)
    h = torch.randn(4 * 3, 48, generator=g).to(dev, torch.bfloat16)
    att = torch.randn(4, 50, 96, generator=g).to(dev)
    p_att = torch.randn(4, 50, 64, generator=g).to(dev)
    att[0, :, 5] = 0.0
    att[3, :, 90:] = 0.0
    p_att[1, :, 0] = 0.0
    p_att[2, :, 17:33] = 0.0
    att_q, att_s = fa8.quantize_per_channel(att)
    p_att_q, p_att_s = fa8.quantize_per_channel(p_att)
    assert float(att_s[0, 0, 5]) == pytest.approx(1e-12)
    args = (h, p, att_q, att_s, p_att_q, p_att_s)
    got = fa8.beam_content_attention_i8(*args, B=3, exact_tanh=exact_tanh)
    torch.cuda.synchronize()
    want = fa8.beam_content_attention_i8_plain(*args, B=3)
    _within_bf16_ulp(got, want)
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("exact_tanh", [False, True])
@pytest.mark.parametrize("p_scale,w_scale", [(40.0, 0.2), (1.0, 10.0),
                                             (20.0, 3.0)])
def test_attention_i8_kernel_at_large_magnitudes(dev, p_scale, w_scale,
                                                 exact_tanh):
    """|p_att| or |q| past 21.5, where e^2p e^2q could leave f32's range:
    the default entry's blocks take the unfactored form there."""
    g = torch.Generator().manual_seed(int(p_scale + w_scale))
    p = _att_params(g, 48, 512, dev, torch.bfloat16)
    p["h2att"]["weight"] = (p["h2att"]["weight"].float() * w_scale / 0.2
                            ).bfloat16()
    h = torch.randn(2 * 3, 48, generator=g).to(dev, torch.bfloat16)
    att_q, att_s = fa8.quantize_per_channel(
        torch.randn(2, 40, 512, generator=g).to(dev))
    p_att_q, p_att_s = fa8.quantize_per_channel(
        torch.randn(2, 40, 512, generator=g).to(dev) * p_scale)
    args = (h, p, att_q, att_s, p_att_q, p_att_s)
    got = fa8.beam_content_attention_i8(*args, B=3, exact_tanh=exact_tanh)
    torch.cuda.synchronize()
    _within_bf16_ulp(got, fa8.beam_content_attention_i8_plain(*args, B=3))


def test_attention_i8_kernel_launches_the_query_product_and_the_attention(
        dev):
    """One wrapper call is two launches, the query product into its f32
    scratch and the attention; it counts once on the int8 wrapper and not
    on v1's."""
    g = torch.Generator().manual_seed(11)
    args = _i8_inputs(g, 5, 3, 40, 48, 64, 64, dev, torch.bfloat16)
    before = (fa.beam_content_attention.launches,
              fa8.beam_content_attention_i8.launches)
    parts = device_ms_by_name(
        lambda: fa8.beam_content_attention_i8(*args, B=3),
        ("query_bf16_kernel", "beam_att_i8_kernel"),
        per_call={"query_bf16_kernel": 1, "beam_att_i8_kernel": 1},
        iters=2, warm=1)
    assert parts["query_bf16_kernel"] > 0 and parts["beam_att_i8_kernel"] > 0
    assert parts["query_bf16_kernel"] + parts["beam_att_i8_kernel"] \
        == pytest.approx(parts["total"])
    assert fa.beam_content_attention.launches == before[0]
    assert fa8.beam_content_attention_i8.launches >= before[1] + 3


def test_attention_i8_kernel_refuses_widths_past_its_lanes(dev):
    g = torch.Generator().manual_seed(0)
    for Ah, Fe in ((2064, 32), (32, 2064)):
        args = _i8_inputs(g, 1, 3, 5, 48, Ah, Fe, dev, torch.bfloat16)
        with pytest.raises(ValueError, match="at most 2048"):
            fa8.beam_content_attention_i8(*args, B=3)


@pytest.mark.parametrize("tile_rows", [24, 48, 96])
@pytest.mark.parametrize("rows_tiles,K,N", [(2, 64, 128), (3, 72, 136),
                                            (1, 1536, 2048), (4, 8, 8)])
def test_tiled_mm_kernel_matches_plain(dev, tile_rows, rows_tiles, K, N):
    g = torch.Generator().manual_seed(tile_rows + K + N)
    rows = rows_tiles * tile_rows
    x = torch.randn(rows, K, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(K, N, generator=g) * 0.05).to(dev, torch.bfloat16)
    before = tmm.tiled_mm.launches
    got = tmm.tiled_mm(x, w, tile_rows=tile_rows)
    torch.cuda.synchronize()
    assert tmm.tiled_mm.launches == before + 1
    want = tmm.tiled_mm_plain(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, N)
    _within_bf16_ulp(got, want)


@pytest.mark.parametrize("tile_rows", [1, 5, 16, 17, 128])
def test_tiled_mm_kernel_odd_tiles(dev, tile_rows):
    g = torch.Generator().manual_seed(tile_rows)
    x = torch.randn(3 * tile_rows, 200, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(200, 264, generator=g).to(dev, torch.bfloat16)
    _within_bf16_ulp(tmm.tiled_mm(x, w, tile_rows=tile_rows),
                     tmm.tiled_mm_plain(x, w))


@pytest.mark.parametrize("tile_rows", [24, 96])
def test_tiled_mm_kernel_streams_w_past_the_slab(dev, tile_rows):
    """K = 4096: a 64-column slab of w (512 KB) does not fit a block, so
    the kernel streams w with x (the plan's other path)."""
    g = torch.Generator().manual_seed(4096 + tile_rows)
    rows, K, N = 4 * tile_rows, 4096, 520
    assert not tmm.plan(rows, tile_rows, K, N).resident
    x = torch.randn(rows, K, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(K, N, generator=g) * 0.05).to(dev, torch.bfloat16)
    before = tmm.tiled_mm.launches
    got = tmm.tiled_mm(x, w, tile_rows=tile_rows)
    torch.cuda.synchronize()
    assert tmm.tiled_mm.launches == before + 1
    _within_bf16_ulp(got, tmm.tiled_mm_plain(x, w))


@pytest.mark.parametrize("K", [1536, 4096])
def test_tiled_mm_kernel_tile_of_5_takes_n8(dev, K):
    """A tile of 5 rows runs as wgmma n8, its 3 padded rows zero-filled
    and never stored, on both paths."""
    g = torch.Generator().manual_seed(5 + K)
    assert tmm.plan(40, 5, K, 136).n == 8
    x = torch.randn(40, K, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(K, 136, generator=g) * 0.05).to(dev, torch.bfloat16)
    _within_bf16_ulp(tmm.tiled_mm(x, w, tile_rows=5),
                     tmm.tiled_mm_plain(x, w))


def test_tiled_mm_kernel_refuses_what_it_cannot_take(dev):
    x = torch.zeros(48, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tmm.tiled_mm(x.float(), w.float(), tile_rows=24)
    with pytest.raises(ValueError):                   # ragged
        tmm.tiled_mm(x, w, tile_rows=36)
    with pytest.raises(ValueError):                   # tile too tall
        tmm.tiled_mm(torch.zeros(258, 64, device=dev, dtype=torch.bfloat16),
                     w, tile_rows=129)
    with pytest.raises(ValueError):                   # N % 8
        tmm.tiled_mm(x, w[:, :100], tile_rows=24)


def test_device_ms_reads_the_tiled_kernels_time(dev):
    """The profiler records the ctypes-launched kernel: a positive device
    time well under a millisecond at the att_lstm shape."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1152, 1536, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(1536, 2048, generator=g).to(dev, torch.bfloat16)
    t = device_ms(lambda: tmm.tiled_mm(x, w, tile_rows=48), iters=8)
    assert 0.001 < t < 1.0, t

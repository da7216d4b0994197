#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``insenticap_model_tpu_torch/
csrc`` (``nvcc`` for sm_90a, one process a source, all started together,
into the git-ignored build directory), then:

1. prints the card's name and power limit, the build time and ptxas's
   registers and spills of the int8 attention's instances (the B = 3
   ones must spill nothing);
2. holds every kernel against its plain PyTorch version on the card, at
   the serving shapes (bs=384; attention v1 at beams 1, 3 and 8 and v2 at
   beam 3, in bf16 and f32, v1's bf16 instance also with tanhf in place of
   tanh.approx.f32, both within the same tolerance; the
   Winograd transforms in bf16, the input transform also on the
   detector's permuted NHWC view, which must give the contiguous input's
   V exactly, and the stack on that view; the fused classifier top-k at 1152 rows x
   10,000 words in bf16 and f32, and the bf16 top-k's wgmma product alone
   against the f32 library product; the encoder stem's max pool in bf16 and
   f32 at [32,224,224,64] and [32,192,256,64], the 448x448 and 384x512
   buckets at bs=32, and an odd extent, exactly; the int8-storage
   attention at bs=384, N=196, 512 wide (both tanh entries) and the
   row-tiled product at the
   decode cell's two LSTM shapes and tile_rows 24, 48 and 96, at K = 4096
   (w streamed, not resident) and at a tile of 5 rows (wgmma n8), both in
   bf16 within one bf16 ulp; the Winograd output transform also equal to
   its plain version in bf16, on its element-wise path (M off its
   alignment) equal to its vector path, and in f32 within rounding), with
   the tolerances stated at each check;
3. drives the main path: a full-width bf16 ``DynamicBatcher`` (512-d
   model, 2048-d 14x14 features, vocab 10,000, beam 3, 16 tokens, random
   weights from a seed) answers 41 requests from threads, mixing auto and
   forced sentiment labels so that the 1-, 8- and 32-row buckets dispatch,
   with every kernel's launch count set to 0 just before and read just
   after;
3b. drives the trained path: the same batcher on the trained captioner
   ``assets/bench_trained.ckpt`` (read by the port's own checkpoint
   reader; the detector from a seed), standard-normal features, and
   ``ISC_FUSED_TOPK=1`` with ``ISC_ATT_KERNEL=v2`` set before ``warm()``,
   answers 40 requests; the launch counts are set to 0 just before and
   read just after, and every caption must end, with a mean length in
   [8, 13] and fewer than 16 decode steps a batch;
3c. drives the image path: a bf16 ``EncodeBatcher`` (ResNet-101 at full
   depth and the 2000-concept MLP, random weights from a seed, the ladder
   1/4/16/32 over the three resize buckets) chained to a phase-3 decode
   batcher through the concepts' ranked sentiment words (a synthetic
   concept list, sentiment table and vocabulary from the same seed)
   answers 40 uint8 image requests and 4 fc requests from threads, auto
   and forced labels; the launch counts are set to 0 just before and read
   just after, and the pool's must equal the image encode groups
   dispatched; every request gets a caption and 5 distinct concept ids in
   range; then 96 images of 448x448 at once give the encode throughput;
3d. drives the two studies' paths at their full shapes with few
   repetitions: ``tools/bench_torch_int8.attention`` (the bf16 v1 kernel
   against the int8-storage kernel at bs=384, and the int8 context's error)
   and ``tools/bench_torch_megacell.measure`` (both LSTM products through
   the row-tiled kernel at the three tile sizes, beside ``torch.matmul``);
   the launch counts are set to 0 just before and must equal the calls
   each function reports;
4. runs ``detect_and_decode`` at bs=384 in f32 on the kernel path and on
   the plain path, on random weights with the default kernels and on the
   trained weights with both switches, and requires identical labels,
   identical top-beam tokens on at least 99% of the images and, on those,
   top-beam scores within 1e-3; decodes a beam of 9 (wider than the
   kernels take) in bf16 at bs=8, with and without ``ISC_FUSED_TOPK=1``,
   and requires the plain path's tokens and scores exactly, with no v1 or
   top-k launch; compares the detector's labels, bf16 (Winograd kernels,
   and the direct conv) against f32 direct, at bs=384 (printed, no limit);
   runs the f32 encoder (bs=16, 448x448) with
   the pool kernel and with the plain pool (fc/att within 1e-5 of scale,
   identical concept ids), and the bf16 encoder against the f32 one (rms
   error at most 0.1 of the f32 features' rms);
5. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (median of 5
   runs after warm-up); v1, v2 and the int8 attention (query product +
   attention, printed apart; the int8 one beside v1 on the same values,
   both tanh entries), the fused top-k (pass 1 + merge, printed apart,
   beside the bf16 ``torch.matmul`` of its product as a yardstick), the
   row-tiled product
   and ``torch.matmul``, some 30-100 us a call, by
   the profiler's device time (the latter two from phase 3d), since events
   around back-to-back launches of that size also read the host's
   dispatch; the three Winograd transforms by the profiler's device time
   beside events (the input transform on the permuted view the detector
   passes, and on contiguous x), and the stack's device time split into
   the transforms, the two products, the per-call filter transform and
   the rest; the bf16 serving step at bs=384 under the four
   switch settings on random weights, and captions/s and mean caption
   length on the trained weights, default and both switches (host clock,
   the settings taken in turns, median of 6 each); ``forward_raw_batch``
   at bs=32, 448x448, bf16 and f32 (host clock, median of 5);
6. prints one ``kernels`` JSON line (every check above passed, or the run
   would have stopped; each kernel's ``design`` says whether it is a
   Hopper-specific redesign or the first port), the card's name and power
   limit, then
   ``{"ok": true, "device": ...}``.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero at once where CUDA is absent or the package is
not beside it. Details go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOP_S = 67e12           # f32 outside the tensor cores
BF16_FLOP_S = 989e12         # bf16 tensor cores, dense
# tanh.approx.f32 runs on the special-function units (MUFU), 16 a clock on
# each SM of sm_90 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), at the H100 SXM's maximum boost clock of 1980 MHz (NVIDIA
# data sheet; the card's own clocks.max.sm is printed beside it)
SFU_OPS_CLK = 16
SM_CLOCK_HZ = 1.98e9

BS = 384
VOCAB = 10_000
BEAM = 3
T = 16
M = 10                       # sentiment words per request
NUM_CATS = 3
BANNED = (0, 1, 2)           # pad, unk, sos: the beam's static bans
SOURCES = ["fused_attention", "winograd", "fused_topk", "maxpool",
           "tiled_mm"]
N_CONCEPTS = 2000            # the concept detector's outputs
K_CONCEPTS = 5               # concepts per image
ENC_BS = 32                  # the encode ladder's top bucket
# the stem's pool inputs at ENC_BS for the 448x448 and 384x512 buckets
POOL_SHAPES = {"448x448": (ENC_BS, 224, 224, 64),
               "384x512": (ENC_BS, 192, 256, 64)}
TRAINED_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "assets", "bench_trained.ckpt")
ATT_BEAMS = (1, BEAM, 8)     # v1's checks: narrowest, serving, widest
# each kernel's design on this card: "redesigned" for the Hopper-specific
# designs that replaced the first port, "first design" for the others
# (PERF.md's kernel table gives their history)
DESIGNS = {"beam_content_attention": "redesigned",
           "beam_content_attention_v2": "redesigned (runs on v1's kernel)",
           "wino_input": "redesigned", "wino_middle": "redesigned",
           "wino_output": "redesigned", "classifier_topk": "redesigned",
           "ceil_maxpool_3x3s2": "first design",
           "beam_content_attention_i8": "redesigned",
           "tiled_mm": "redesigned"}
SWITCH_SETS = {"default": {}, "fused_topk": {"ISC_FUSED_TOPK": "1"},
               "v2": {"ISC_ATT_KERNEL": "v2"},
               "both": {"ISC_FUSED_TOPK": "1", "ISC_ATT_KERNEL": "v2"}}


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _smi(fields="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _bound(nbytes, flops, rate, tanh=0, sms=0):
    """The least time in ms and what sets it: the bytes over the memory
    rate ("bytes"), the flops over ``rate`` ("operations"), or ``tanh``
    special-function operations over SFU_OPS_CLK a clock on each of
    ``sms`` SMs at SM_CLOCK_HZ ("tanh"), whichever is the largest."""
    terms = [(nbytes / HBM_BYTES_S * 1e3, "bytes"),
             (flops / rate * 1e3, "operations")]
    if tanh:
        terms.append((tanh / (SFU_OPS_CLK * sms * SM_CLOCK_HZ) * 1e3, "tanh"))
    return max(terms, key=lambda t: t[0])


def _bound_by(term):
    """The kernels line's word for a bound's term: a tanh is an operation,
    over its type's peak rate."""
    return "bytes" if term == "bytes" else "operations"


@contextlib.contextmanager
def _switches(name):
    """The kernel switches of SWITCH_SETS[name], the others unset; the
    environment is restored on exit."""
    keys = ("ISC_FUSED_TOPK", "ISC_ATT_KERNEL")
    prev = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(SWITCH_SETS[name])
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _first_eos(seqs, eos):
    """First-EOS position of every [.., T] row (T where absent)."""
    import numpy as np
    seqs = np.asarray(seqs).reshape(-1, seqs.shape[-1])
    hit = seqs == eos
    return np.where(hit.any(axis=1), hit.argmax(axis=1), seqs.shape[1])


def _run_groups(request, n, groups):
    """Call request(i) for every i from its own thread, the groups one
    after another; returns (results, errors, seconds)."""
    results = [None] * n
    errors = []

    def ask(i):
        try:
            results[i] = request(i)
        except Exception as e:  # noqa: BLE001 — raised by the caller
            errors.append(repr(e))

    t0 = time.time()
    for group in groups:
        threads = [threading.Thread(target=ask, args=(i,)) for i in group]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
            _check(not th.is_alive(), "a request never returned")
    return results, errors, time.time() - t0


def _serve(batcher, fcs, atts, sentis, forced, groups):
    """Submit every request from its own thread, group after group; returns
    (results, errors, seconds)."""
    return _run_groups(lambda i: batcher.submit(
        fcs[i], atts[i], sentis[i], forced_label=forced[i], timeout=600),
        len(fcs), groups)


def _check_results(results, errors):
    import numpy as np
    _check(not errors, f"requests failed: {errors}")
    for seqs, scores, label in results:
        _check(seqs.shape == (BEAM, T), f"seqs shape {seqs.shape}")
        _check(seqs.min() >= 0 and seqs.max() < VOCAB, "token id range")
        _check(np.isfinite(scores).all(), "non-finite score")
        _check((np.diff(scores) <= 0).all(), "scores not descending")
        _check(0 <= label < NUM_CATS, f"label {label}")


def _compare_e2e(torch, tag, kernel_out, plain_out):
    """f32 kernel path against the plain path: identical labels, >= 99%
    identical top beams, scores within 1e-3 on those. Returns a report."""
    ks, ksc, kl = kernel_out
    ps, psc, pl = plain_out
    # the score bound holds where the top beams are the same caption; an
    # image whose search took another path at a near-tie scores another
    # caption
    eq = (ks[:, 0] == ps[:, 0]).all(dim=1)
    same = eq.float().mean().item()
    dscore = (ksc[eq, 0] - psc[eq, 0]).abs().max().item() if eq.any() \
        else float("inf")
    print(f"f32 bs={BS} {tag}, kernel vs plain: labels equal "
          f"{bool(torch.equal(kl, pl))}, top-beam tokens identical on "
          f"{same:.2%} of images, max top-beam score diff on those "
          f"{dscore:.3g}")
    diverged = []
    for i in (~eq).nonzero()[:, 0].tolist():
        step = int((ks[i, 0] != ps[i, 0]).nonzero()[0, 0])
        diverged.append({"image": i, "first_step": step,
                         "kernel_score": float(ksc[i, 0]),
                         "plain_score": float(psc[i, 0])})
        print(f"  image {i}: top beams part at step {step}, scores kernel "
              f"{float(ksc[i, 0]):.6f} plain {float(psc[i, 0]):.6f}")
    _check(torch.equal(kl, pl), f"{tag}: labels differ between kernel and "
           "plain")
    _check(same >= 0.99, f"{tag}: top-beam tokens identical on only "
           f"{same:.2%}")
    _check(dscore <= 1e-3, f"{tag}: top-beam score diff {dscore}")
    return {"top_beam_identical": same, "max_score_diff": dscore,
            "diverged": diverged}


def _within_rounding(torch, got, want, rtol, scale_frac):
    """|got - want| <= rtol*|want| + scale_frac*max|want| everywhere;
    returns (ok, max_abs_err)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = rtol * want.abs() + scale_frac * want.abs().max()
    return bool((err <= tol).all()), float(err.max())


def main():
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this check needs a card")
    try:
        from insenticap_model_tpu_torch import inference, nn
        from insenticap_model_tpu_torch.cli.common import senti_word_ids
        from insenticap_model_tpu_torch.config import Settings
        from insenticap_model_tpu_torch.models import captioner as cap
        from insenticap_model_tpu_torch.models import concept_detector as cpt
        from insenticap_model_tpu_torch.models import encoder
        from insenticap_model_tpu_torch.models import sentiment_detector as sd
        from insenticap_model_tpu_torch.ops import _build
        from insenticap_model_tpu_torch.ops import fused_attention as fa
        from insenticap_model_tpu_torch.ops import fused_attention_i8 as fa8
        from insenticap_model_tpu_torch.ops import fused_topk as ft
        from insenticap_model_tpu_torch.ops import pool
        from insenticap_model_tpu_torch.ops import tiled_mm as tmm
        from insenticap_model_tpu_torch.ops import winograd_kernels as wk
        from insenticap_model_tpu_torch.ops.winograd import transform_filter
        from insenticap_model_tpu_torch.preprocessing import (
            DEFAULT_BUCKET_SHAPES)
        from insenticap_model_tpu_torch.serving.encode import make_cpt_apply
        from insenticap_model_tpu_torch.serving_daemon import (
            AUTO, DynamicBatcher, EncodeBatcher)
        from insenticap_model_tpu_torch.training import checkpoint as tck
        from insenticap_model_tpu_torch.utils.dtypes import (cast_bf16,
                                                             cast_f32)
        from insenticap_model_tpu_torch.utils.timing import (
            cuda_ms, device_ms, device_ms_by_kernel, device_ms_by_name)
        from insenticap_model_tpu_torch.utils.tolerance import bf16_ulp_error
        from insenticap_model_tpu_torch.vocab import Vocab
        from tools import bench_torch_int8 as bti
        from tools import bench_torch_megacell as btm
    except ImportError as e:
        _fail(f"the port's package is not importable here: {e}")
    import numpy as np

    dev = torch.device("cuda")
    report = {}

    # -- 1. device and build ------------------------------------------------
    smi = _smi()
    print(f"device: {smi}")
    print(f"SM clock, maximum (nvidia-smi clocks.max.sm): "
          f"{_smi('clocks.max.sm')}; the tanh bounds take "
          f"{SM_CLOCK_HZ / 1e6:.0f} MHz")
    t0 = time.time()
    _build.build(SOURCES)                  # one nvcc each, all together
    build_s = time.time() - t0
    print(f"kernel build: {build_s:.1f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report["build_s"] = build_s
    # the int8 attention's instances by beam and tanh; where this run built
    # the source, the B = 3 ones must spill nothing
    i8_ptxas = {}
    for entry, r in _build.ptxas_report(
            _build.build_logs.get("fused_attention", "")).items():
        m = re.search(r"beam_att_i8_kernelILi(\d+)ELb([01])E", entry)
        if m:
            i8_ptxas[f"B={m.group(1)} " + ("factored exp" if m.group(2)
                                           == "1" else "tanhf")] = r
    for name, r in sorted(i8_ptxas.items()):
        print(f"  ptxas beam_att_i8_kernel {name}: {r.get('registers')} "
              f"registers, spill stores {r.get('spill_stores')} bytes, "
              f"loads {r.get('spill_loads')} bytes")
    if "fused_attention" in _build.build_logs:
        b3 = [r for name, r in i8_ptxas.items() if name.startswith("B=3 ")]
        _check(len(b3) == 2 and all(
            r.get("spill_stores") == 0 and r.get("spill_loads") == 0
            for r in b3), f"int8 attention at B=3 spills: {i8_ptxas}")
    report["ptxas_attention_i8"] = i8_ptxas

    settings = Settings()
    ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
    gen = torch.Generator().manual_seed(0)
    cap32 = cap.init_params(gen, VOCAB, NUM_CATS, settings, device=dev)
    det32 = sd.init_params(gen, NUM_CATS, settings, device=dev)
    cap16, det16 = cast_bf16(cap32), cast_bf16(det32)
    g = torch.Generator(device=dev).manual_seed(1)
    H, Ah, Fe, N = (settings.rnn_hid_dim, settings.att_hid_dim,
                    settings.feat_emb_dim, 14 * 14)
    C0 = settings.att_feat_dim

    # -- 2. every kernel against its plain version at serving shapes -------
    checks = {}
    att_in = {}

    def att_tol(dt, got, want):
        if dt == torch.bfloat16:   # one bf16 rounding of the same f32 value
            return _within_rounding(torch, got, want, 1e-2, 1e-3)
        # f32: another order of the same sums
        return _within_rounding(torch, got, want, 1e-4, 1e-4)

    for dt in (torch.bfloat16, torch.float32):
        p_cont = (cap16 if dt == torch.bfloat16 else cap32)[
            "attention"]["cont"]
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        att = torch.rand(BS, N, Fe, generator=g, device=dev).to(dt)
        p_att = torch.rand(BS, N, Ah, generator=g, device=dev).to(dt)
        # v1 at the narrowest, the serving and the widest beam
        for b_ in ATT_BEAMS:
            hb = (torch.rand(BS * b_, H, generator=g, device=dev) * 2
                  - 1).to(dt)
            got = fa.beam_content_attention(hb, p_cont, att, p_att, B=b_)
            torch.cuda.synchronize()
            want_b = fa.beam_content_attention_plain(hb, p_cont, att, p_att,
                                                     B=b_)
            ok, err = att_tol(dt, got, want_b)
            checks[f"attention_{tag}_B{b_}"] = err
            print(f"check attention {tag} bs={BS} B={b_}: max_abs_err="
                  f"{err:.3g} {'ok' if ok else 'FAIL'}")
            _check(ok, f"attention kernel {tag} B={b_} disagrees with its "
                   "plain version")
            if b_ == BEAM:
                h, want = hb, want_b
        checks[f"attention_{tag}"] = checks[f"attention_{tag}_B{BEAM}"]
        if dt == torch.bfloat16:
            # the bf16 instance's tanh.approx.f32 against tanhf: both held
            # to the same tolerance, both errors kept
            got = fa.beam_content_attention(h, p_cont, att, p_att, B=BEAM,
                                            exact_tanh=True)
            torch.cuda.synchronize()
            ok, err = att_tol(dt, got, want)
            checks["attention_bf16_tanhf"] = err
            print(f"check attention bf16 bs={BS} B={BEAM} with tanhf: "
                  f"max_abs_err={err:.3g} (tanh.approx.f32: "
                  f"{checks['attention_bf16']:.3g}) {'ok' if ok else 'FAIL'}")
            _check(ok, "attention kernel bf16 with tanhf disagrees with its "
                   "plain version")
        del hb, want_b
        att_in[dt] = (h, p_cont, att, p_att)
        # v2: the same inputs, v1's tolerances
        got = fa.beam_content_attention(h, p_cont, att, p_att, B=BEAM,
                                        variant="v2")
        torch.cuda.synchronize()
        want = fa.beam_content_attention_plain(h, p_cont, att, p_att, B=BEAM,
                                               variant="v2")
        ok, err = att_tol(dt, got, want)
        checks[f"attention_v2_{tag}"] = err
        print(f"check attention v2 {tag} bs={BS}: max_abs_err={err:.3g} "
              f"{'ok' if ok else 'FAIL'}")
        _check(ok, f"attention v2 kernel {tag} disagrees with its plain "
               "version")

    # the fused classifier top-k at the decode's rows: values within 1e-4,
    # indices identical except at near-ties (the plain version's
    # neighbouring values within 1e-4: the logits are sums in another
    # order), bans held
    rows = BS * BEAM
    last = torch.randint(0, VOCAB, (rows,), generator=g, device=dev)
    topk_in = {}
    for dt in (torch.bfloat16, torch.float32):
        cp = (cap16 if dt == torch.bfloat16 else cap32)["classifier"]
        hq = (torch.rand(rows, H, generator=g, device=dev) * 2 - 1).to(dt)
        args = (hq, cp["weight"], cp["bias"], last)
        gv, gi = ft.classifier_topk(*args, k=BEAM, banned=BANNED)
        torch.cuda.synchronize()
        pv, pi = ft.classifier_topk_plain(*args, k=BEAM + 1, banned=BANNED)
        gv, gi, pv, pi = gv.cpu(), gi.cpu(), pv.cpu(), pi.cpu()
        err = float((gv - pv[:, :BEAM]).abs().max())
        swapped = (gi != pi[:, :BEAM]).nonzero().tolist()
        near = [min(abs(float(pv[r, j] - pv[r, q])) for q in (j - 1, j + 1)
                    if 0 <= q <= BEAM) for r, j in swapped]
        bans_ok = not (torch.isin(gi, torch.tensor(BANNED)).any()
                       or (gi == last.cpu()[:, None]).any())
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        ok = err <= 1e-4 and all(x <= 1e-4 for x in near) and bans_ok
        checks[f"classifier_topk_{tag}"] = err
        checks[f"classifier_topk_{tag}_near_tie_swaps"] = len(swapped)
        print(f"check classifier_topk {tag} rows={rows} V={VOCAB}: "
              f"max_abs_err={err:.3g}, {len(swapped)} index swaps at "
              f"near-ties (gaps {[f'{x:.2g}' for x in near]}), bans held "
              f"{bans_ok} {'ok' if ok else 'FAIL'}")
        _check(ok, f"classifier_topk kernel {tag} disagrees with its plain "
               "version")
        topk_in[dt] = args
    # the bf16 pass's wgmma product alone against the f32 library product
    # of the same bf16 values: products exact in f32, sums in another
    # order, held to 1e-4 of the logits' scale (a layout fault is O(1))
    hq, wq = topk_in[torch.bfloat16][:2]
    got = ft.wgmma_product(hq, wq)
    torch.cuda.synchronize()
    with nn.exact_numerics():
        want = hq.float() @ wq.float().t()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    checks["topk_wgmma_product"] = err
    ok = err <= 1e-4 * max(1.0, scale)
    print(f"check topk wgmma product bf16 [{rows},{H}]x[{H},{VOCAB}]: "
          f"max_abs_err={err:.3g} (logits scale {scale:.3g}) "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "the top-k's wgmma product disagrees with torch.matmul")
    del got, want

    x16 = torch.rand(14, 14, BS, C0, generator=g, device=dev).to(
        torch.bfloat16)
    convs = det16["convs"]
    v = wk.wino_input(x16)
    torch.cuda.synchronize()
    ok, err = _within_rounding(torch, v, wk.wino_input_plain(x16), 1e-2,
                               1e-3)
    checks["wino_input"] = err
    print(f"check wino_input bf16: max_abs_err={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "wino_input kernel disagrees with its plain version")
    # the detector's own input: the permuted view of NHWC features, read
    # in place through its strides (no copy); the same values as x16
    feats16 = x16.permute(2, 0, 1, 3).contiguous()
    x16_view = feats16.permute(1, 2, 0, 3)
    v_view = wk.wino_input(x16_view)
    torch.cuda.synchronize()
    same = torch.equal(v_view, v)
    checks["wino_input_view_equal"] = same
    print(f"check wino_input bf16 on the permuted NHWC view: identical to "
          f"the contiguous input's {'ok' if same else 'FAIL'}")
    _check(same, "wino_input on the permuted view differs from the "
           "contiguous input's")
    del v_view

    def gemm(v, w):
        cin, cout = w.shape[2], w.shape[3]
        with nn.exact_numerics():
            u = transform_filter(w).to(v.dtype).reshape(49, cin, cout)
            return torch.bmm(v.reshape(49, -1, cin), u).reshape(
                49, 9, BS, cout)
    m1 = gemm(v, convs[0]["weight"])
    b1 = convs[0]["bias"]
    v2 = wk.wino_middle(m1, b1, 14, 14)
    torch.cuda.synchronize()
    ok, err = _within_rounding(torch, v2, wk.wino_middle_plain(m1, b1, 14, 14),
                               1e-2, 1e-3)
    checks["wino_middle"] = err
    print(f"check wino_middle bf16: max_abs_err={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "wino_middle kernel disagrees with its plain version")
    m2 = gemm(v2, convs[1]["weight"])
    b2 = convs[1]["bias"]
    y = wk.wino_output(m2, b2, 14, 14)
    torch.cuda.synchronize()
    ok, err = _within_rounding(torch, y, wk.wino_output_plain(m2, b2, 14, 14),
                               1e-2, 1e-3)
    checks["wino_output"] = err
    print(f"check wino_output bf16: max_abs_err={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "wino_output kernel disagrees with its plain version")
    # the same f32 sums in the same order as the twin, one rounding: equal;
    # M one element past an aligned base takes the kernel's element-wise
    # path, which must give the same numbers; f32 within rounding
    same = torch.equal(y, wk.wino_output_plain(m2, b2, 14, 14))
    buf = torch.empty(m2.numel() + 1, dtype=m2.dtype, device=dev)
    m2_off = buf[1:].view(m2.shape)
    m2_off.copy_(m2)
    same_off = torch.equal(wk.wino_output(m2_off, b2, 14, 14), y)
    del buf, m2_off
    m2_32 = m2.float()
    ok32, err32 = _within_rounding(
        torch, wk.wino_output(m2_32, b2, 14, 14),
        wk.wino_output_plain(m2_32, b2, 14, 14), 1e-5, 1e-5)
    del m2_32
    torch.cuda.synchronize()
    checks.update(wino_output_equal=same,
                  wino_output_elementwise_equal=same_off,
                  wino_output_f32=err32)
    ok = same and same_off and ok32
    print(f"check wino_output bf16 equal to its plain version {same}, "
          f"element-wise path (M off its alignment) equal {same_off}; f32: "
          f"max_abs_err={err32:.3g} {'ok' if ok else 'FAIL'}")
    _check(same and same_off, "wino_output kernel is not equal to its plain "
           "version in bf16, or its element-wise path differs")
    _check(ok32, "wino_output f32 kernel disagrees with its plain version")

    # the whole stack: kernels against the plain stack at the same cast
    # points, and both against the f32 direct conv chain
    layers16 = [(c["weight"], c["bias"]) for c in convs]
    stack_k = wk.conv3x3_stack_sm(x16_view, layers16).float()
    del x16_view, feats16
    ref = x16.float().permute(2, 0, 1, 3)
    for c in det32["convs"]:
        ref = nn.conv2d(c, ref)                    # f32, TF32 off
    ref = ref.permute(1, 2, 0, 3)
    direct16 = x16.permute(2, 0, 1, 3)
    for c in convs:
        direct16 = nn.conv2d(c, direct16)
    direct16 = direct16.permute(1, 2, 0, 3).float()
    # the plain stack on the card: the twins' arithmetic on CUDA tensors
    vp = wk.wino_input_plain(x16)
    mp = gemm(vp, convs[0]["weight"])
    vp = wk.wino_middle_plain(mp, b1, 14, 14)
    mp = gemm(vp, convs[1]["weight"])
    stack_p = wk.wino_output_plain(mp, b2, 14, 14).float()
    del vp, mp
    scale = float(ref.abs().max())
    rms = lambda a: float(a.float().pow(2).mean().sqrt())  # noqa: E731
    diff_rms = rms(stack_k - stack_p) / rms(stack_p)
    diff_max = float((stack_k - stack_p).abs().max()) / scale
    err_k = float((stack_k - ref).abs().max()) / scale
    err_p = float((stack_p - ref).abs().max()) / scale
    err_direct = float((direct16 - ref).abs().max()) / scale
    conv_rule = max(4 * err_direct, 0.05)
    checks.update(stack_rms_vs_plain=diff_rms, stack_max_vs_plain=diff_max,
                  stack_err_kernel=err_k,
                  stack_err_plain=err_p, stack_err_bf16_direct=err_direct)
    print(f"check winograd stack bf16: rms(kernel-plain)/rms(plain)="
          f"{diff_rms:.3g} (<= 2e-2), max|kernel-plain| {diff_max:.3g} of "
          f"scale; max err vs f32 conv, of scale: "
          f"kernel {err_k:.4g}, plain {err_p:.4g} (kernel <= 1.25 x plain "
          f"+ 1e-3); bf16 direct conv {err_direct:.4g}; the "
          f"max(4 x direct, 0.05) = {conv_rule:.4g} rule "
          f"{'met' if err_k <= conv_rule else 'not met: F(5x5,3x3) loses more in bf16 than that rule allows, in the plain version as well'}")
    _check(diff_rms <= 2e-2, "Winograd stack kernels disagree with the "
           "plain stack")
    _check(err_k <= 1.25 * err_p + 1e-3, "Winograd stack kernels lose more "
           "against the f32 conv than the plain stack does")
    del stack_k, stack_p, ref, direct16, m1, m2, v, v2, y
    torch.cuda.empty_cache()

    # the stem's ceil-mode max pool at the serving buckets' shapes, an odd
    # extent (the ceil-pad row and column masked) and the spatial-major
    # form: max is exact, so torch.equal
    pool_in = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for name, shape in list(POOL_SHAPES.items()) + [
                ("odd", (5, 111, 97, 64))]:
            xp = torch.randn(shape, generator=g, device=dev).to(dt)
            same = torch.equal(pool.ceil_maxpool_3x3s2_nhwc(xp),
                               pool.ceil_maxpool_3x3s2_plain(xp))
            if name == "odd":
                same = same and torch.equal(
                    pool.ceil_maxpool_3x3s2_sm(
                        xp.permute(1, 2, 0, 3).contiguous())
                    .permute(2, 0, 1, 3), pool.ceil_maxpool_3x3s2_plain(xp))
            else:
                pool_in[(name, dt)] = xp
            torch.cuda.synchronize()
            print(f"check ceil_maxpool_3x3s2 {tag} {list(shape)}: equal "
                  f"{same} {'ok' if same else 'FAIL'}")
            _check(same, f"max pool kernel {tag} {shape} differs from its "
                   "plain version")
    checks["ceil_maxpool_3x3s2"] = 0.0

    # the int8-storage attention at the study's shapes: bf16 h and weights,
    # int8 att/p_att with per-(image, channel) scales; the kernel and its
    # plain version both sum in f32 and round once to bf16
    p_cont16 = cap16["attention"]["cont"]
    h16 = (torch.rand(BS * BEAM, H, generator=g, device=dev) * 2 - 1).to(
        torch.bfloat16)
    att_f = torch.randn(BS, N, Fe, generator=g, device=dev)
    p_att_f = torch.randn(BS, N, Ah, generator=g, device=dev)
    i8_in = (h16, p_cont16) + fa8.quantize_per_channel(att_f) \
        + fa8.quantize_per_channel(p_att_f)
    got = fa8.beam_content_attention_i8(*i8_in, B=BEAM)
    torch.cuda.synchronize()
    err, ulps = bf16_ulp_error(
        got, fa8.beam_content_attention_i8_plain(*i8_in, B=BEAM))
    ok = ulps <= 1
    checks["attention_i8"] = err
    print(f"check attention_i8 bs={BS} N={N} {Fe} wide: max_abs_err={err:.3g}"
          f" ({ulps:.2f} bf16 ulp) {'ok' if ok else 'FAIL'}")
    _check(ok, "int8 attention kernel disagrees with its plain version")
    # the tanhf entry, held to the same check
    got = fa8.beam_content_attention_i8(*i8_in, B=BEAM, exact_tanh=True)
    torch.cuda.synchronize()
    err, ulps = bf16_ulp_error(
        got, fa8.beam_content_attention_i8_plain(*i8_in, B=BEAM))
    ok = ulps <= 1
    checks["attention_i8_tanhf"] = err
    print(f"check attention_i8 with tanhf bs={BS} N={N} {Fe} wide: "
          f"max_abs_err={err:.3g} ({ulps:.2f} bf16 ulp) "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "int8 attention kernel with tanhf disagrees with its plain "
           "version")

    # the row-tiled product at the decode cell's LSTM shapes, every tile
    mm_in = {}
    for name, K, Nw in btm.LSTM_SHAPES:
        x, w = btm.make_inputs(K, Nw, dev, seed=K)
        want = tmm.tiled_mm_plain(x, w)
        for tile_b in btm.TILE_BS:
            tr = tile_b * BEAM
            got = tmm.tiled_mm(x, w, tile_rows=tr)
            torch.cuda.synchronize()
            err, ulps = bf16_ulp_error(got, want)
            ok = ulps <= 1
            checks[f"tiled_mm_{name}_{tr}"] = err
            print(f"check tiled_mm {name} [{x.shape[0]}x{K}]@[{K}x{Nw}] "
                  f"tile_rows={tr}: max_abs_err={err:.3g} ({ulps:.2f} bf16 "
                  f"ulp) {'ok' if ok else 'FAIL'}")
            _check(ok, f"tiled_mm kernel {name} tile_rows={tr} disagrees "
                   "with its plain version")
        mm_in[name] = (x, w)
    # the kernel's other cases: K = 4096, whose 64-column slab (512 KB)
    # does not fit a block, so w streams with x; and a tile of 5 rows,
    # which runs as wgmma n8 with 3 zero rows
    for tr, K, Nw, rows_ in ((24, 4096, 2048, 1152), (96, 4096, 2048, 1152),
                             (5, 1536, 2048, 1150)):
        x = (torch.randn(rows_, K, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        w = (torch.randn(K, Nw, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        pl = tmm.plan(rows_, tr, K, Nw, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        got = tmm.tiled_mm(x, w, tile_rows=tr)
        torch.cuda.synchronize()
        err, ulps = bf16_ulp_error(got, tmm.tiled_mm_plain(x, w))
        ok = ulps <= 1
        checks[f"tiled_mm_K{K}_{tr}"] = err
        print(f"check tiled_mm [{rows_}x{K}]@[{K}x{Nw}] tile_rows={tr} "
              f"(n{pl.n}, w {'resident' if pl.resident else 'streamed'}, "
              f"{pl.stages} stages): max_abs_err={err:.3g} ({ulps:.2f} bf16 "
              f"ulp) {'ok' if ok else 'FAIL'}")
        _check(ok, f"tiled_mm kernel K={K} tile_rows={tr} disagrees with "
               "its plain version")
    del got, want, x, w

    # -- 3. the main path: full-width bf16 serving through DynamicBatcher --
    rng = np.random.default_rng(2)
    n_req = 41
    fcs = rng.random((n_req, settings.fc_feat_dim), np.float32)
    atts = rng.random((n_req, 14, 14, C0), np.float32)
    sentis = rng.integers(4, VOCAB, size=(n_req, M))
    forced = [AUTO] + [AUTO, 1, AUTO, 0, 2, AUTO] + \
        [AUTO if i % 3 else i % NUM_CATS for i in range(30)] + [0, 1, 2, 1]
    groups = ([0], range(1, 7), range(7, 37), range(37, 41))

    def zero_counters():
        fa.beam_content_attention.launches = 0
        fa.beam_content_attention.launches_v2 = 0
        ft.classifier_topk.launches = 0
        for c in (wk.wino_input, wk.wino_middle, wk.wino_output,
                  pool.ceil_maxpool_3x3s2_nhwc):
            c.launches = 0

    def read_counters():
        return {"beam_content_attention": fa.beam_content_attention.launches,
                "beam_content_attention_v2":
                fa.beam_content_attention.launches_v2,
                "classifier_topk": ft.classifier_topk.launches,
                "wino_input": wk.wino_input.launches,
                "wino_middle": wk.wino_middle.launches,
                "wino_output": wk.wino_output.launches,
                "ceil_maxpool_3x3s2": pool.ceil_maxpool_3x3s2_nhwc.launches}

    with _switches("default"):
        batcher = DynamicBatcher(cap32, det32, settings=settings, ids=ids,
                                 beam_size=BEAM, max_seq_len=T,
                                 max_wait_s=0.25, num_sentiments=M,
                                 num_cats=NUM_CATS, compute_dtype="bfloat16",
                                 device=dev)
        try:
            batcher.warm([1, 8, 32])
            torch.cuda.synchronize()
            zero_counters()
            results, errors, serve_s = _serve(batcher, fcs, atts, sentis,
                                              forced, groups)
            launches = read_counters()
            stats = batcher.stats()
        finally:
            batcher.close()
    _check_results(results, errors)
    by = stats["by_bucket"]
    _check(by[1] >= 1 and by[8] >= 1 and by[32] >= 1,
           f"buckets dispatched: {by}")
    print(f"serve: {n_req} requests in {serve_s:.2f} s, batches by bucket "
          f"{by}, launches {launches}")
    for k in ("beam_content_attention", "wino_input", "wino_middle",
              "wino_output"):
        _check(launches[k] > 0, f"kernel {k} never launched on the main path")
    report.update(serve_s=serve_s, by_bucket=by, launches=launches,
                  labels=sorted({r[2] for r in results}))

    # -- 3b. the trained path: checkpoint weights, both kernel switches ----
    t0 = time.time()
    trained, meta = tck.load(TRAINED_CKPT, device=dev)
    load_s = time.time() - t0
    _check(meta.get("vocab_size") == VOCAB and set(trained) == {"captioner"},
           f"unexpected checkpoint: {sorted(trained)}, "
           f"{meta.get('vocab_size')}")
    cap_t = trained["captioner"]
    # the checkpoint holds the captioner only; the detector from a seed
    det_t = sd.init_params(torch.Generator().manual_seed(3), NUM_CATS,
                           settings, device=dev)
    rng = np.random.default_rng(4)
    n_t = 40
    fcs_t = rng.standard_normal((n_t, settings.fc_feat_dim), np.float32)
    atts_t = rng.standard_normal((n_t, 14, 14, C0), np.float32)
    sentis_t = rng.integers(4, VOCAB, size=(n_t, M))
    forced_t = [AUTO if i % 3 else i % NUM_CATS for i in range(n_t)]
    with _switches("both"):
        batcher = DynamicBatcher(cap_t, det_t, settings=settings, ids=ids,
                                 beam_size=BEAM, max_seq_len=T,
                                 max_wait_s=0.25, num_sentiments=M,
                                 num_cats=NUM_CATS, compute_dtype="bfloat16",
                                 device=dev)
        try:
            batcher.warm([1, 8, 32])
            torch.cuda.synchronize()
            zero_counters()
            results_t, errors_t, serve_t_s = _serve(
                batcher, fcs_t, atts_t, sentis_t, forced_t,
                ([0], range(1, 7), range(7, 37), range(37, 40)))
            launches_t = read_counters()
            stats_t = batcher.stats()
        finally:
            batcher.close()
    _check_results(results_t, errors_t)
    lens = _first_eos(np.stack([r[0] for r in results_t]), ids.eos)
    steps_per_batch = launches_t["classifier_topk"] / stats_t["batches"]
    print(f"trained serve: checkpoint read in {load_s:.2f} s; {n_t} "
          f"requests in {serve_t_s:.2f} s, batches by bucket "
          f"{stats_t['by_bucket']}, launches {launches_t}; caption length "
          f"mean {lens.mean():.2f} max {lens.max()} (all beams), "
          f"{steps_per_batch:.2f} decode steps a batch")
    for k in ("classifier_topk", "beam_content_attention_v2"):
        _check(launches_t[k] > 0, f"kernel {k} never launched on the "
               "trained path")
    _check(launches_t["beam_content_attention"] == 0,
           "ISC_ATT_KERNEL=v2 still launched the v1 attention")
    _check(lens.max() < T, f"a caption did not end: max length {lens.max()}")
    _check(8.0 <= lens.mean() <= 13.0, f"mean caption length {lens.mean()}")
    _check(launches_t["classifier_topk"] < T * stats_t["batches"],
           "the trained decode never exited early")
    report["trained_serve"] = {
        "checkpoint_load_s": load_s, "serve_s": serve_t_s,
        "by_bucket": stats_t["by_bucket"], "launches": launches_t,
        "mean_len": float(lens.mean()), "max_len": int(lens.max()),
        "steps_per_batch": steps_per_batch}

    # -- 3c. the image path: uint8 images -> ResNet-101 + concepts -> ------
    # sentiment words -> captions, two batchers chained
    gen_e = torch.Generator().manual_seed(5)
    enc32 = encoder.init_params(gen_e, device=dev)
    cpt32 = cpt.init_params(gen_e, N_CONCEPTS, settings, device=dev)
    enc16 = cast_bf16(enc32)
    rng = np.random.default_rng(6)
    idx2concept = [f"concept{i}" for i in range(N_CONCEPTS)]
    words = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [
        f"word{i}" for i in range(VOCAB - 4)]
    vocab = Vocab(words)
    _check((vocab.pad_id, vocab.unk_id, vocab.sos_id, vocab.eos_id)
           == (ids.pad, ids.unk, ids.sos, ids.eos), "vocab special ids")
    senti_table = {c: [[words[int(w)], float(s)] for w, s in zip(
        rng.integers(4, VOCAB, 6), rng.random(6))] for c in idx2concept}
    n_img, n_fc = 40, 4
    shapes = [DEFAULT_BUCKET_SHAPES[i % 3] for i in range(n_img)]
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in shapes]
    fcs_c = rng.random((n_fc, settings.fc_feat_dim), np.float32)
    atts_c = rng.random((n_fc, 14, 14, C0), np.float32)
    forced_c = [AUTO if i % 3 else i % NUM_CATS for i in range(n_img + n_fc)]

    def image_request(eb, db):
        def request(i):
            if i < n_img:
                fc, att, top = eb.submit_image(imgs[i], timeout=600)
            else:
                fc, att = fcs_c[i - n_img], atts_c[i - n_img]
                top = eb.submit_fc(fc, timeout=600)
            sentis = senti_word_ids([idx2concept[k] for k in top],
                                    senti_table, vocab, M)
            return top, sentis, db.submit(fc, att, sentis,
                                          forced_label=forced_c[i],
                                          timeout=600)
        return request

    eb = EncodeBatcher(lambda x: encoder.forward_raw_batch(enc16, x),
                       make_cpt_apply(cpt32, K_CONCEPTS),
                       fc_dim=settings.fc_feat_dim,
                       shape_buckets=DEFAULT_BUCKET_SHAPES, max_wait_s=0.05,
                       device=dev)
    db = DynamicBatcher(cap32, det32, settings=settings, ids=ids,
                        beam_size=BEAM, max_seq_len=T, max_wait_s=0.05,
                        num_sentiments=M, num_cats=NUM_CATS,
                        compute_dtype="bfloat16", device=dev)
    try:
        with _switches("default"):
            t0 = time.time()
            eb.warm()
            db.warm([1, 8, 32])
            torch.cuda.synchronize()
            warm_c_s = time.time() - t0
            zero_counters()
            results_c, errors_c, serve_c_s = _run_groups(
                image_request(eb, db), n_img + n_fc,
                ([0], range(1, 7), range(7, 37), range(37, n_img + n_fc)))
            launches_c = read_counters()
            enc_stats, dec_stats = eb.stats(), db.stats()
            # encode throughput: 96 images of 448x448 in flight at once
            tput = [rng.integers(0, 256, size=(448, 448, 3), dtype=np.uint8)
                    for _ in range(3 * ENC_BS)]
            torch.cuda.synchronize()
            _, errors_t, tput_s = _run_groups(
                lambda i: eb.submit_image(tput[i], timeout=600),
                len(tput), [range(len(tput))])
            _check(not errors_t, f"throughput requests failed: {errors_t}")
    finally:
        eb.close()
        db.close()
    _check(not errors_c, f"image-path requests failed: {errors_c}")
    _check_results([r[2] for r in results_c], [])
    for top, sentis, _ in results_c:
        top = np.asarray(top)
        _check(top.shape == (K_CONCEPTS,) and top.min() >= 0
               and top.max() < N_CONCEPTS, f"concept ids {top}")
        _check(len(set(top.tolist())) == K_CONCEPTS, "repeated concept id")
    img_groups = sum(enc_stats["by_bucket"][f"{h}x{w}"]
                     for h, w in DEFAULT_BUCKET_SHAPES)
    print(f"image path: {n_img} images + {n_fc} fc requests in "
          f"{serve_c_s:.2f} s (warm-up {warm_c_s:.1f} s); encode groups by "
          f"bucket {enc_stats['by_bucket']}, decode batches by bucket "
          f"{dec_stats['by_bucket']}, launches {launches_c}; encode "
          f"throughput {len(tput) / tput_s:.1f} images/s ({len(tput)} "
          f"images of 448x448 in {tput_s:.2f} s)")
    _check(enc_stats["requests"] == n_img + n_fc
           and enc_stats["failed_requests"] == 0, f"encode stats {enc_stats}")
    _check(launches_c["ceil_maxpool_3x3s2"] > 0
           and launches_c["ceil_maxpool_3x3s2"] == img_groups,
           f"max pool launches {launches_c['ceil_maxpool_3x3s2']} != "
           f"{img_groups} image encode groups")
    for k in ("beam_content_attention", "wino_input", "wino_middle",
              "wino_output"):
        _check(launches_c[k] > 0, f"kernel {k} never launched on the image "
               "path")
    report["image_path"] = {
        "serve_s": serve_c_s, "warm_s": warm_c_s,
        "encode_by_bucket": enc_stats["by_bucket"],
        "encode_latency": enc_stats["latency_by_bucket"],
        "decode_by_bucket": dec_stats["by_bucket"],
        "decode_latency": dec_stats["latency_by_bucket"],
        "padded_rows": enc_stats["padded_rows"], "launches": launches_c,
        "encode_images_per_s_448": len(tput) / tput_s,
        "labels": sorted({int(r[2][2]) for r in results_c}),
        "distinct_concept_sets": len({tuple(np.asarray(r[0]).tolist())
                                      for r in results_c})}
    del tput, imgs
    torch.cuda.empty_cache()

    # -- 3d. the two studies' paths at full shapes, few repetitions -------
    fa.beam_content_attention.launches = 0
    fa8.beam_content_attention_i8.launches = 0
    study_t, study_err, study_calls = bti.attention(dev, iters=4, reps=3)
    launches_d = {"beam_content_attention_i8":
                  fa8.beam_content_attention_i8.launches,
                  "beam_content_attention": fa.beam_content_attention.launches}
    tmm.tiled_mm.launches = 0
    mega = btm.measure(dev, iters=16, reps=3)
    launches_d["tiled_mm"] = tmm.tiled_mm.launches
    i8_t, v1_t = (study_t["int8_device_ms"]["total"],
                  study_t["bf16_device_ms"]["total"])
    print(f"studies: int8 attention device {i8_t:.4f} ms (events "
          f"{study_t['int8_ms']:.4f}) against the bf16 v1 kernel's "
          f"{v1_t:.4f} ms (events {study_t['bf16_ms']:.4f}), context error "
          + ", ".join(f"{k} mean {v['mean']:.5f} max {v['max']:.4f}"
                      for k, v in study_err.items())
          + "; decode cell: " + "; ".join(
              f"{name} device ms: matmul "
              f"{mega[name]['matmul_device_ms']:.4f}, tiled "
              + ", ".join(f"{tr}: {t:.4f}" for tr, t in
                          mega[name]["tiled_device_ms"].items())
              for name, _, _ in btm.LSTM_SHAPES)
          + f"; launches {launches_d}")
    _check(launches_d["beam_content_attention_i8"] == study_calls["i8"]
           and launches_d["beam_content_attention"] == study_calls["v1"],
           f"attention launches {launches_d} != calls {study_calls}")
    _check(launches_d["tiled_mm"] == mega["calls"],
           f"tiled_mm launches {launches_d['tiled_mm']} != {mega['calls']}")
    _check(all(np.isfinite(v["max"]) for v in study_err.values()),
           f"int8 context error {study_err}")
    report["studies"] = {"attention_ms": study_t, "attention_error": study_err,
                         "megacell": mega, "launches": launches_d}

    # -- 4. f32 end to end: kernel path against the plain path -------------
    params32 = inference.ServingParams(cap32, det32)
    fc = torch.rand(BS, settings.fc_feat_dim, generator=g, device=dev)
    att = torch.rand(BS, 14, 14, C0, generator=g, device=dev)
    sw = torch.randint(4, VOCAB, (BS, M), generator=g, device=dev)
    kw = dict(settings=settings, ids=ids, beam_size=BEAM, max_seq_len=T)
    # random weights give a flat 10,000-word distribution, so near-ties
    # are common there
    with _switches("default"):
        report["e2e_f32"] = _compare_e2e(
            torch, "random weights, default kernels",
            inference.detect_and_decode(params32, fc, att, sw, **kw),
            inference.detect_and_decode(params32, fc, att, sw,
                                        use_kernels=False, **kw))
    # the trained captioner in f32, standard-normal features, both switches
    params_t32 = inference.ServingParams(cast_f32(cap_t), det_t)
    fc_n = torch.randn(BS, settings.fc_feat_dim, generator=g, device=dev)
    att_n = torch.randn(BS, 14, 14, C0, generator=g, device=dev)
    with _switches("both"):
        ft.classifier_topk.launches = 0
        kernel_out = inference.detect_and_decode(params_t32, fc_n, att_n, sw,
                                                 **kw)
        steps_f32 = ft.classifier_topk.launches
        report["e2e_f32_trained_both"] = _compare_e2e(
            torch, "trained weights, both switches", kernel_out,
            inference.detect_and_decode(params_t32, fc_n, att_n, sw,
                                        use_kernels=False, **kw))
    _check(0 < steps_f32 < T, f"f32 trained decode ran {steps_f32} steps")
    report["e2e_f32_trained_both"]["steps"] = steps_f32

    # a beam wider than the kernels take (kernel_takes): bf16 at full width,
    # bs=8, through the plain cell and tail on the card, token for token the
    # use_kernels=False path, with no v1 or top-k launch
    params16 = inference.ServingParams(cap16, det16)
    fc9 = torch.rand(8, settings.fc_feat_dim, generator=g,
                     device=dev).bfloat16()
    att9 = torch.rand(8, 14, 14, C0, generator=g, device=dev).bfloat16()
    kw9 = dict(kw, beam_size=9)
    beam9 = {}
    for name in ("default", "fused_topk"):
        with _switches(name):
            zero_counters()
            got9 = inference.detect_and_decode(params16, fc9, att9, sw[:8],
                                               **kw9)
            l9 = read_counters()
            want9 = inference.detect_and_decode(params16, fc9, att9, sw[:8],
                                                use_kernels=False, **kw9)
        same = all(torch.equal(a, b) for a, b in zip(got9, want9))
        beam9[name] = {"identical_to_plain": same, "launches": l9}
        _check(tuple(got9[0].shape) == (8, 9, T) and same,
               f"beam 9 ({name}) differs from the plain path")
        _check(l9["beam_content_attention"] == 0
               and l9["classifier_topk"] == 0,
               f"beam 9 ({name}) launched a kernel that does not take it: "
               f"{l9}")
    print(f"beam 9 decode bf16 bs=8: identical to the plain path, launches "
          f"{ {k: v['launches'] for k, v in beam9.items()} }")
    report["beam9_decode"] = beam9

    # the detector's labels at bs=384: its bf16 path through the Winograd
    # kernels (deterministic, as served) and its bf16 direct conv, each
    # against the f32 direct conv, on uniform and on standard-normal
    # features: labels after the 0.7 threshold, argmax before it, and the
    # logits' max error. A record of what the bf16 F(5x5,3x3) loss does to
    # labels (the same in both packages): no limit is set, since the repo
    # has no trained detector to judge labels by
    label_check = {}
    for name, feats in (("uniform", att), ("normal", att_n)):
        l32 = sd.forward(det32, feats, use_kernels=False)[0]
        lab32 = sd.threshold_labels(l32, 0.7, ids.neutral)[0]
        wk.wino_input.launches = 0
        l16k = sd.forward(det16, feats.bfloat16())[0].float()
        _check(wk.wino_input.launches == 1, "the bf16 detector did not take "
               "the Winograd kernels")
        l16d = sd.forward(det16, feats.bfloat16(),
                          use_kernels=False)[0].float()
        for path, l16 in (("winograd", l16k), ("direct", l16d)):
            lab16 = sd.threshold_labels(l16, 0.7, ids.neutral)[0]
            label_check[f"{name}_bf16_{path}"] = {
                "labels_agree": float((lab16 == lab32).float().mean()),
                "argmax_agree": float((l16.argmax(-1) == l32.argmax(-1))
                                      .float().mean()),
                "logits_max_err": float((l16 - l32).abs().max()),
                "logits_scale": float(l32.abs().max()),
                "neutral_share_f32": float((lab32 == ids.neutral)
                                           .float().mean())}
    print(f"detector labels bf16 vs f32 direct bs={BS}: " + "; ".join(
        f"{k}: labels {v['labels_agree']:.4f}, argmax "
        f"{v['argmax_agree']:.4f}, logits max err {v['logits_max_err']:.4g}"
        f" (scale {v['logits_scale']:.4g}, f32 neutral share "
        f"{v['neutral_share_f32']:.3f})" for k, v in label_check.items()))
    report["detector_labels_bf16_vs_f32"] = label_check
    del params32, params_t32, kernel_out
    torch.cuda.empty_cache()

    # the f32 encoder at 448x448, pool kernel against the plain pool: the
    # pool is exact, so only cuDNN's choice of algorithm between calls may
    # move fc/att (held to 1e-5 of scale); concept ids identical. Then the
    # bf16 encoder against the f32 one: 101 layers of bf16 roundings, held
    # to an rms error of 0.1 of the f32 features' rms
    imgs4 = torch.randint(0, 256, (16, 448, 448, 3), dtype=torch.uint8,
                          generator=g, device=dev)
    fk, ak = encoder.forward_raw_batch(enc32, imgs4)
    fp, ap = encoder.forward_raw_batch(enc32, imgs4, use_kernels=False)
    e_fc = float((fk - fp).abs().max()) / float(fp.abs().max())
    e_att = float((ak - ap).abs().max()) / float(ap.abs().max())
    tk = cpt.sample(cpt32, fk, K_CONCEPTS)[1]
    tp_ = cpt.sample(cpt32, fp, K_CONCEPTS)[1]
    f16, a16 = encoder.forward_raw_batch(enc16, imgs4)
    rel = lambda a, b: float((a.float() - b).pow(2).mean().sqrt()  # noqa
                             / b.pow(2).mean().sqrt())
    r_fc, r_att = rel(f16, fp), rel(a16, ap)
    m_fc = float((f16.float() - fp).abs().max()) / float(fp.abs().max())
    t16 = cpt.sample(cpt32, f16.float(), K_CONCEPTS)[1]
    shared = float(np.mean([len(set(a) & set(b)) / K_CONCEPTS for a, b in
                            zip(t16.tolist(), tp_.tolist())]))
    sat = float((cpt.forward(cpt32, fp) == 1.0).float().mean())
    print(f"encoder f32 bs=16 448x448, kernel vs plain pool: max err of "
          f"scale fc {e_fc:.3g} att {e_att:.3g} (<= 1e-5), concept ids "
          f"equal {bool(torch.equal(tk, tp_))}; bf16 vs f32: rms err fc "
          f"{r_fc:.4g} att {r_att:.4g} (<= 0.1), max err of scale fc "
          f"{m_fc:.4g}, top-{K_CONCEPTS} concepts shared {shared:.2%}; "
          f"features scale fc {float(fp.abs().max()):.4g}, concept scores "
          f"at exactly 1.0: {sat:.2%}")
    _check(e_fc <= 1e-5 and e_att <= 1e-5, "encoder kernel path differs from "
           "the plain path")
    _check(torch.equal(tk, tp_), "concept ids differ between the kernel "
           "and plain encoder paths")
    _check(r_fc <= 0.1 and r_att <= 0.1, "bf16 encoder too far from f32")
    report["encoder_f32_kernel_vs_plain"] = {"fc": e_fc, "att": e_att}
    report["encoder_bf16_vs_f32"] = {
        "rms_fc": r_fc, "rms_att": r_att, "max_fc_of_scale": m_fc,
        "concepts_shared": shared, "saturated_scores_f32": sat}
    del fk, ak, fp, ap, f16, a16
    torch.cuda.empty_cache()

    # -- 5. times ------------------------------------------------------------
    kernels = []
    h, p_cont, att16, p_att16 = att_in[torch.bfloat16]
    # v1 is two launches of some 0.1 ms together, near the host's dispatch
    # of a call: the line carries the profiler's device time, split into
    # the query product and the attention, with CUDA events beside it
    v1_parts = ("query_", "beam_att_kernel")
    a_dev = device_ms_by_name(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM), v1_parts)
    a_ms = cuda_ms(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM))
    a_tanhf = device_ms_by_name(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM, exact_tanh=True), v1_parts)
    a_plain = cuda_ms(lambda: fa.beam_content_attention_plain(
        h, p_cont, att16, p_att16, B=BEAM), iters=5)
    rows = BS * BEAM
    a_bytes = 2 * (rows * H + Ah * H + Ah + Ah + BS * N * (Ah + Fe)
                   + rows * Fe)
    a_flops = 2 * rows * H * Ah + 3 * rows * N * Ah + 5 * rows * N \
        + 2 * rows * N * Fe
    a_tanh = rows * N * Ah           # one tanh a (beam, position, channel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a_bound, a_by = _bound(a_bytes, a_flops, F32_FLOP_S, a_tanh, sms)
    h32, p32, att32, patt32 = att_in[torch.float32]
    a32_dev = device_ms_by_name(lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM), v1_parts)
    a32_ms = cuda_ms(lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM))
    a32_bound, _ = _bound(2 * a_bytes, a_flops, F32_FLOP_S, a_tanh, sms)
    report["attention_f32"] = {"device_ms": a32_dev, "ms_events": a32_ms,
                               "bound_ms": a32_bound}
    # the narrowest and the widest beam on the same att/p_att
    a_by_beam = {BEAM: a_dev}
    for b_ in ATT_BEAMS:
        if b_ != BEAM:
            hb = (torch.rand(BS * b_, H, generator=g, device=dev) * 2
                  - 1).bfloat16()
            a_by_beam[b_] = device_ms_by_name(
                lambda: fa.beam_content_attention(hb, p_cont, att16, p_att16,
                                                  B=b_), v1_parts)
    del hb
    report["attention_bf16"] = {"device_ms": a_dev, "ms_events": a_ms,
                                "device_ms_tanhf": a_tanhf,
                                "device_ms_by_beam": a_by_beam}
    per_batch = launches["beam_content_attention"] / stats["batches"]
    kernels.append({
        "name": "beam_content_attention",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "insenticap_model_tpu/ops/fused_attention.py:27",
        "launches": launches["beam_content_attention"],
        "max_abs_err": checks["attention_bf16"],
        "ms": a_dev["total"], "ms_events": a_ms,
        "query_ms": a_dev["query_"], "attention_ms": a_dev["beam_att_kernel"],
        "plain_ms": a_plain, "bound_ms": a_bound,
        "bound_by": _bound_by(a_by), "bound_term": a_by, "library_ms": None,
        "passed": True})
    # v2: the same function up to the weights' rounding, on v1's kernels
    # (kRoundW), the same bound
    v2_ms = cuda_ms(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM, variant="v2"))
    v2_dev = device_ms_by_name(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM, variant="v2"), v1_parts)
    v2_plain = cuda_ms(lambda: fa.beam_content_attention_plain(
        h, p_cont, att16, p_att16, B=BEAM, variant="v2"), iters=5)
    v2_32 = cuda_ms(lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM, variant="v2"))
    report["attention_v2_f32"] = {"ms": v2_32, "bound_ms": a32_bound}
    report["attention_v2_bf16"] = {"ms_events": v2_ms, "device_ms": v2_dev}
    kernels.append({
        "name": "beam_content_attention_v2",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "insenticap_model_tpu/ops/fused_attention.py:51",
        "launches": launches_t["beam_content_attention_v2"],
        "max_abs_err": checks["attention_v2_bf16"],
        "ms": v2_dev["total"], "ms_events": v2_ms,
        "query_ms": v2_dev["query_"],
        "attention_ms": v2_dev["beam_att_kernel"],
        "plain_ms": v2_plain, "bound_ms": a_bound,
        "bound_by": _bound_by(a_by), "bound_term": a_by, "library_ms": None,
        "passed": True})
    # the fused top-k: 2 rows H V flops on the tensor cores (bf16), the
    # operands read once, [rows, k] values and ids written once. Two
    # launches of some 0.03-0.1 ms together: the line carries the
    # profiler's device time, pass 1 and the merge apart, CUDA events
    # beside it; the bf16 torch.matmul of the same product is a yardstick
    # for the product alone (no one call computes the top-k)
    tk16, tk32 = topk_in[torch.bfloat16], topk_in[torch.float32]
    tk_parts = ("topk_wgmma", "topk_merge")
    tk_dev = device_ms_by_name(lambda: ft.classifier_topk(
        *tk16, k=BEAM, banned=BANNED), tk_parts)
    tk_ms = cuda_ms(lambda: ft.classifier_topk(*tk16, k=BEAM,
                                               banned=BANNED))
    tk_plain = cuda_ms(lambda: ft.classifier_topk_plain(
        *tk16, k=BEAM, banned=BANNED), iters=5)
    wt16 = tk16[1].t()
    mm16_dev = device_ms(lambda: torch.matmul(tk16[0], wt16))
    mm16_ms = cuda_ms(lambda: torch.matmul(tk16[0], wt16))
    tk32_dev = device_ms_by_name(lambda: ft.classifier_topk(
        *tk32, k=BEAM, banned=BANNED), ("topk_tiles_f32", "topk_merge"))
    tk32_ms = cuda_ms(lambda: ft.classifier_topk(*tk32, k=BEAM,
                                                 banned=BANNED))
    tk32_plain = cuda_ms(lambda: ft.classifier_topk_plain(
        *tk32, k=BEAM, banned=BANNED), iters=5)
    tk_flops = 2 * rows * H * VOCAB
    tk_io = 8 * rows + rows * BEAM * (4 + 8)
    tk_bound, tk_by = _bound(2 * (rows * H + VOCAB * H + VOCAB) + tk_io,
                             tk_flops, BF16_FLOP_S)
    tk32_bound, _ = _bound(4 * (rows * H + VOCAB * H + VOCAB) + tk_io,
                           tk_flops, F32_FLOP_S)
    report["classifier_topk_f32"] = {
        "device_ms": tk32_dev, "ms_events": tk32_ms, "plain_ms": tk32_plain,
        "bound_ms": tk32_bound}
    report["classifier_topk_bf16"] = {
        "device_ms": tk_dev, "ms_events": tk_ms,
        "matmul_bf16_device_ms": mm16_dev, "matmul_bf16_ms_events": mm16_ms}
    kernels.append({
        "name": "classifier_topk",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_topk.cu",
        "replaces": "insenticap_model_tpu/ops/fused_topk.py:59",
        "launches": launches_t["classifier_topk"],
        "max_abs_err": checks["classifier_topk_bf16"],
        "ms": tk_dev["total"], "ms_events": tk_ms,
        "pass1_ms": tk_dev["topk_wgmma"], "pass2_ms": tk_dev["topk_merge"],
        "matmul_yardstick_ms": mm16_dev, "plain_ms": tk_plain,
        "bound_ms": tk_bound, "bound_by": tk_by, "library_ms": None,
        "passed": True})

    # the detector's input as it serves it: NHWC features, permuted
    feats16 = torch.rand(BS, 14, 14, C0, generator=g, device=dev).to(
        torch.bfloat16)
    x16 = feats16.permute(1, 2, 0, 3)
    x16c = x16.contiguous()
    v = wk.wino_input(x16)
    m1 = gemm(v, convs[0]["weight"])
    v2 = wk.wino_middle(m1, b1, 14, 14)
    m2 = gemm(v2, convs[1]["weight"])
    c1, c2 = convs[0]["weight"].shape[3], convs[1]["weight"].shape[3]
    tr = 2 * 7 * 7 * 7 * 2        # dense 7x7 transform: two 7x7x7 products
    inv = 2 * (5 * 7 * 7 + 5 * 5 * 7)
    specs = [
        ("wino_input", "insenticap_model_tpu/ops/winograd_pallas.py:67",
         lambda: wk.wino_input(x16), lambda: wk.wino_input_plain(x16),
         2 * (14 * 14 * BS * C0 + 49 * 9 * BS * C0), 9 * BS * C0 * tr),
        ("wino_middle", "insenticap_model_tpu/ops/winograd_pallas.py:99",
         lambda: wk.wino_middle(m1, b1, 14, 14),
         lambda: wk.wino_middle_plain(m1, b1, 14, 14),
         2 * 2 * 49 * 9 * BS * c1 + 4 * c1, 9 * BS * c1 * (tr + inv)),
        ("wino_output", "insenticap_model_tpu/ops/winograd_pallas.py:83",
         lambda: wk.wino_output(m2, b2, 14, 14),
         lambda: wk.wino_output_plain(m2, b2, 14, 14),
         2 * (49 * 9 * BS * c2 + 14 * 14 * BS * c2) + 4 * c2,
         9 * BS * c2 * inv),
    ]
    # each transform by the profiler's device time (the kernel alone;
    # "total" also holds any copy the wrapper makes) beside CUDA events;
    # wino_input on the permuted view, as the detector calls it
    wino_names = ("wino_input_kernel", "wino_middle_kernel",
                  "wino_output_kernel")
    wino_times = {}
    for name, replaces, kfn, pfn, nbytes, flops in specs:
        k_dev = device_ms_by_name(kfn, wino_names)
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn, iters=3)
        bnd, by_ = _bound(nbytes, flops, F32_FLOP_S)
        wino_times[name] = {"device_ms": k_dev[name + "_kernel"],
                            "device_total_ms": k_dev["total"],
                            "ms_events": k_ms, "plain_ms": p_ms,
                            "bound_ms": bnd, "bound_by": by_}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "insenticap_model_tpu_torch/csrc/winograd.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": checks[name], "ms": k_dev[name + "_kernel"],
            "ms_events": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd, "bound_by": by_, "library_ms": None,
            "passed": True})
    wino_times["wino_input_contiguous"] = {
        "device_ms": device_ms_by_name(lambda: wk.wino_input(x16c),
                                       wino_names)["wino_input_kernel"],
        "ms_events": cuda_ms(lambda: wk.wino_input(x16c))}
    report["winograd_transforms"] = wino_times

    # the whole stack (kernels + the two products) on the permuted view,
    # beside the library's two bf16 convolutions on the same input, NCHW
    # as cuDNN prefers; then its device time split by activity, by the
    # names of the device activities: the three transforms, the two
    # products (the names the two torch.bmm show alone), the per-call
    # filter transform (the other names its f32 einsums and casts show
    # alone) and the rest; the copy kernels among them apart
    def stack_fn():
        return wk.conv3x3_stack_sm(x16, layers16)
    stack_ms = cuda_ms(stack_fn, iters=5)
    stack_by = device_ms_by_kernel(stack_fn, iters=5)

    def filters():
        with nn.exact_numerics():
            return [transform_filter(c["weight"]).to(torch.bfloat16)
                    .reshape(49, *c["weight"].shape[2:]) for c in convs]
    us = filters()
    vs = [v.reshape(49, -1, C0), v2.reshape(49, -1, c1)]
    bmm_by = device_ms_by_kernel(
        lambda: [torch.bmm(vs[i], us[i]) for i in range(2)], iters=5)
    filt_by = device_ms_by_kernel(filters, iters=5)
    del us, vs

    def part(names):
        return sum(ms for n_, ms in stack_by.items() if n_ in names)
    wino_in_stack = {n_: sum(ms for k_, ms in stack_by.items() if n_ in k_)
                     for n_ in wino_names}
    trans_names = {n_ for n_ in stack_by if "wino_" in n_}
    prod_names = set(bmm_by) - trans_names
    filt_names = set(filt_by) - prod_names - trans_names
    stack_split = {
        "total": sum(stack_by.values()), **wino_in_stack,
        "transforms": part(trans_names), "products": part(prod_names),
        "filter_transform": part(filt_names),
        "rest": part(set(stack_by) - trans_names - prod_names - filt_names),
        "copy_kernels": sum(ms for n_, ms in stack_by.items()
                            if "copy" in n_.lower()),
        "products_alone": sum(bmm_by.values()),
        "filter_transform_alone": sum(filt_by.values()),
        "by_kernel": dict(sorted(stack_by.items(), key=lambda kv: -kv[1]))}
    xn = x16.permute(2, 3, 0, 1).contiguous()
    wn = [c["weight"].permute(3, 2, 0, 1).contiguous() for c in convs]

    def lib():
        with nn.exact_numerics():
            y = torch.nn.functional.conv2d(xn, wn[0], b1, padding=1)
            return torch.nn.functional.conv2d(y, wn[1], b2, padding=1)
    lib_ms = cuda_ms(lib, iters=5)
    gemm_flops = 2 * 49 * 9 * BS * (C0 * c1 + c1 * c2)
    stack_bytes = 2 * (14 * 14 * BS * C0 + 14 * 14 * BS * c2
                       + 9 * (C0 * c1 + c1 * c2))
    stack_bound = max(stack_bytes / HBM_BYTES_S, gemm_flops / BF16_FLOP_S) \
        * 1e3
    report["winograd_stack"] = {"ms": stack_ms, "library_ms": lib_ms,
                                "bound_ms": stack_bound,
                                "device_ms": stack_split}
    del v, v2, m1, m2, xn, x16c, feats16

    # the stem's max pool at both buckets' shapes, bf16 and f32: each
    # input read once and each output written once; the library's
    # F.max_pool2d on the channels-last view as the yardstick
    pool_times = {}
    for (name, dt), xp in pool_in.items():
        B_, H_, W_, C_ = xp.shape
        oh_, ow_ = pool.out_extent(H_), pool.out_extent(W_)
        x_cl = xp.permute(0, 3, 1, 2)
        nbytes = xp.element_size() * (B_ * H_ * W_ + B_ * oh_ * ow_) * C_
        bnd, by_ = _bound(nbytes, 8 * B_ * oh_ * ow_ * C_, F32_FLOP_S)
        pool_times[f"{name}_{'bf16' if dt == torch.bfloat16 else 'f32'}"] = {
            "ms": cuda_ms(lambda: pool.ceil_maxpool_3x3s2_nhwc(xp)),
            "plain_ms": cuda_ms(lambda: pool.ceil_maxpool_3x3s2_plain(xp),
                                iters=5),
            "library_ms": cuda_ms(lambda: torch.nn.functional.max_pool2d(
                x_cl, 3, 2, 0, ceil_mode=True)),
            "bound_ms": bnd, "bound_by": by_}
    report["ceil_maxpool_3x3s2"] = pool_times
    p16 = pool_times["448x448_bf16"]
    kernels.append({
        "name": "ceil_maxpool_3x3s2", "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/maxpool.cu",
        "replaces": "insenticap_model_tpu/ops/pool_pallas.py:38",
        "launches": launches_c["ceil_maxpool_3x3s2"],
        "max_abs_err": checks["ceil_maxpool_3x3s2"], "ms": p16["ms"],
        "plain_ms": p16["plain_ms"], "bound_ms": p16["bound_ms"],
        "bound_by": p16["bound_by"], "library_ms": p16["library_ms"],
        "passed": True})
    del pool_in, x_cl

    # the int8-storage attention: int8 att/p_att and their f32 scales read
    # once, h and W read and the bf16 output written once; v1's operations
    # plus one multiply a dequantised value, and v1's tanh. Two launches of
    # some 0.05 ms together: the line carries the profiler's device time,
    # the query product and the attention apart, CUDA events beside it. No
    # one PyTorch call computes it: the bf16 v1 kernel on the same values,
    # timed the same way, is its reference
    i8_parts = bti.I8_PARTS
    i8_dev = device_ms_by_name(lambda: fa8.beam_content_attention_i8(
        *i8_in, B=BEAM), i8_parts)
    i8_ms = cuda_ms(lambda: fa8.beam_content_attention_i8(*i8_in, B=BEAM))
    i8_tanhf = device_ms_by_name(lambda: fa8.beam_content_attention_i8(
        *i8_in, B=BEAM, exact_tanh=True), i8_parts)
    i8_plain = cuda_ms(lambda: fa8.beam_content_attention_i8_plain(
        *i8_in, B=BEAM), iters=5)
    att16_i8, p_att16_i8 = att_f.bfloat16(), p_att_f.bfloat16()
    i8_ref = device_ms_by_name(lambda: fa.beam_content_attention(
        h16, p_cont16, att16_i8, p_att16_i8, B=BEAM), v1_parts)
    i8_ref_ms = cuda_ms(lambda: fa.beam_content_attention(
        h16, p_cont16, att16_i8, p_att16_i8, B=BEAM))
    i8_bytes = BS * N * (Ah + Fe) + 4 * BS * (Ah + Fe) \
        + 2 * (rows * H + Ah * H + 2 * Ah + rows * Fe)
    i8_bound, i8_by = _bound(i8_bytes, a_flops + BS * N * (Ah + Fe),
                             F32_FLOP_S, a_tanh, sms)
    i8_bytes_ms = i8_bytes / HBM_BYTES_S * 1e3
    report["attention_i8"] = {
        "device_ms": i8_dev, "ms_events": i8_ms, "device_ms_tanhf": i8_tanhf,
        "reference_device_ms": i8_ref, "reference_ms_events": i8_ref_ms,
        "bound_ms": i8_bound, "bound_term": i8_by,
        "bytes_bound_ms": i8_bytes_ms}
    kernels.append({
        "name": "beam_content_attention_i8", "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "tools/bench_int8.py:283",
        "launches": launches_d["beam_content_attention_i8"],
        "max_abs_err": checks["attention_i8"], "ms": i8_dev["total"],
        "ms_events": i8_ms, "query_ms": i8_dev["query_"],
        "attention_ms": i8_dev["beam_att_i8_kernel"],
        "plain_ms": i8_plain, "bound_ms": i8_bound,
        "bound_by": _bound_by(i8_by), "bound_term": i8_by,
        "library_ms": None, "reference_ms": i8_ref["total"],
        "reference_ms_events": i8_ref_ms, "passed": True})
    del att16_i8, p_att16_i8

    # the row-tiled product at both LSTM shapes and every tile, timed in
    # phase 3d's run of the study: at some 50 us a call, CUDA events around
    # back-to-back launches also read the host's dispatch, so the line
    # carries the profiler's device time (events beside it). att_lstm at
    # tile_rows=24 (tile_b 8); torch.matmul at the full 1152 rows, with f32
    # accumulation as the kernel, is the yardstick
    mm_times = {}
    for name, (x, w) in mm_in.items():
        mm_times[name] = dict(mega[name], plain_ms=cuda_ms(
            lambda: tmm.tiled_mm_plain(x, w), iters=5))
    report["tiled_mm"] = mm_times
    m24 = mm_times["att_lstm"]
    kernels.append({
        "name": "tiled_mm", "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/tiled_mm.cu",
        "replaces": "tools/bench_megacell.py:71",
        "launches": launches_d["tiled_mm"],
        "max_abs_err": checks["tiled_mm_att_lstm_24"],
        "ms": m24["tiled_device_ms"][24], "ms_events": m24["tiled_ms"][24],
        "plain_ms": m24["plain_ms"], "bound_ms": m24["bound_ms"],
        "bound_by": m24["bound_by"], "library_ms": m24["matmul_device_ms"],
        "library_ms_events": m24["matmul_ms"],
        "by_shape": {name: {"device_ms": r["tiled_device_ms"],
                            "bound_ms": r["bound_ms"],
                            "library_ms": r["matmul_device_ms"]}
                     for name, r in mm_times.items()},
        "passed": True})
    del mm_in, i8_in

    # the encoder at the top of the encode ladder, 448x448, host clock
    imgs32 = torch.randint(0, 256, (ENC_BS, 448, 448, 3), dtype=torch.uint8,
                           generator=g, device=dev)
    enc_times = {}
    for tag, ep in (("bf16", enc16), ("f32", enc32)):
        walls = []
        for r in range(6):
            t0 = time.perf_counter()
            encoder.forward_raw_batch(ep, imgs32)
            torch.cuda.synchronize()
            if r:                                  # the first is warm-up
                walls.append(time.perf_counter() - t0)
        s_ = statistics.median(walls)
        enc_times[tag] = {"ms": s_ * 1e3, "images_per_s": ENC_BS / s_}
    report["encoder_bs32_448"] = enc_times
    del imgs32, enc32, enc16

    # the serving step: detect + decode, bf16, bs=384, host clock; its
    # detector alone; and the same step on the plain path
    fc16, att16b = fc.bfloat16(), att.bfloat16()

    def wall_s(fn, runs=5):
        fn()
        torch.cuda.synchronize()
        wall = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        return statistics.median(wall)

    def interleaved_s(fn, names, rounds=6):
        """Median host time of fn under each switch set of ``names``, the
        sets taken in turns (a b .. b a) so that drift in the shared
        host's speed falls on all of them alike."""
        for name in names:
            with _switches(name):
                fn()
        torch.cuda.synchronize()
        walls = {name: [] for name in names}
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                with _switches(name):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t0)
        return {name: statistics.median(w) for name, w in walls.items()}

    def step_fn(params, fc_, att_):
        return lambda: inference.detect_and_decode(params, fc_, att_, sw,
                                                   **kw)
    steps_by_switch = interleaved_s(step_fn(params16, fc16, att16b),
                                    list(SWITCH_SETS))
    step_s = steps_by_switch["default"]
    with _switches("default"):
        detect_s = wall_s(lambda: sd.sample(det16, att16b, 0.7,
                                            ids.neutral))
        plain_step_s = wall_s(lambda: inference.detect_and_decode(
            params16, fc16, att16b, sw, use_kernels=False, **kw), runs=3)
    # the trained weights: standard-normal features, default and both
    params_t16 = inference.ServingParams(cast_bf16(cap_t), cast_bf16(det_t))
    fc_t16, att_t16 = fc_n.bfloat16(), att_n.bfloat16()
    trained_walls = interleaved_s(step_fn(params_t16, fc_t16, att_t16),
                                  ["default", "both"])
    trained_step = {}
    for name, wall in trained_walls.items():
        with _switches(name):
            ft.classifier_topk.launches = 0
            seqs_t = inference.detect_and_decode(params_t16, fc_t16, att_t16,
                                                 sw, **kw)[0]
            n_steps = ft.classifier_topk.launches
        lens_t = _first_eos(seqs_t.cpu().numpy(), ids.eos)
        trained_step[name] = {"step_s": wall, "captions_per_s": BS / wall,
                              "mean_len": float(lens_t.mean()),
                              "max_len": int(lens_t.max())}
        if name == "both":
            trained_step[name]["decode_steps"] = n_steps
            _check(0 < n_steps < T, f"trained bf16 decode ran {n_steps} "
                   "steps")
    report.update(serve_step_bs384_bf16_s=step_s,
                  captions_per_s=BS / step_s, detect_bs384_bf16_s=detect_s,
                  plain_serve_step_bs384_bf16_s=plain_step_s,
                  plain_captions_per_s=BS / plain_step_s,
                  serve_step_bs384_bf16_s_by_switch=steps_by_switch,
                  trained_step_bs384_bf16=trained_step, device=smi,
                  checks=checks, kernels=kernels,
                  attention_launches_per_batch=per_batch,
                  total_s=time.time() - t_start)
    print(f"winograd stack bf16 bs={BS}: {stack_ms:.3f} ms (bound "
          f"{stack_bound:.3f} ms), F.conv2d two convs {lib_ms:.3f} ms")
    sp = stack_split
    print(f"winograd stack bf16 bs={BS}, device ms: total {sp['total']:.4f}"
          f" = transforms {sp['transforms']:.4f} (input "
          f"{sp['wino_input_kernel']:.4f}, middle "
          f"{sp['wino_middle_kernel']:.4f}, output "
          f"{sp['wino_output_kernel']:.4f}) + products {sp['products']:.4f}"
          f" + filter transform {sp['filter_transform']:.4f} + rest "
          f"{sp['rest']:.4f}; copy kernels among them "
          f"{sp['copy_kernels']:.4f}; alone: products "
          f"{sp['products_alone']:.4f}, filter transform "
          f"{sp['filter_transform_alone']:.4f}")
    for name, r in wino_times.items():
        print(f"{name} bf16 bs={BS}: device {r['device_ms']:.4f} ms "
              + (f"(with the wrapper's work {r['device_total_ms']:.4f}) "
                 if "device_total_ms" in r else "")
              + f"events {r['ms_events']:.4f} ms"
              + (f", plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                 if "bound_ms" in r else ""))
    for name, r in pool_times.items():
        print(f"ceil_maxpool_3x3s2 {name} bs={ENC_BS}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, F.max_pool2d "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    for name, r in mm_times.items():
        print(f"tiled_mm {name} bf16, device ms (events): " + ", ".join(
            f"tile_rows={tr} {t:.4f} ({r['tiled_ms'][tr]:.4f})"
            for tr, t in r["tiled_device_ms"].items())
            + f"; torch.matmul {r['matmul_device_ms']:.4f} "
            f"({r['matmul_ms']:.4f}); plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"attention_i8 bf16 bs={BS} B={BEAM}, device ms: query "
          f"{i8_dev['query_']:.4f} + attention "
          f"{i8_dev['beam_att_i8_kernel']:.4f} = {i8_dev['total']:.4f} "
          f"(events {i8_ms:.4f}; with tanhf "
          f"{i8_tanhf['beam_att_i8_kernel']:.4f}, total "
          f"{i8_tanhf['total']:.4f}); v1 bf16 kernel on the same values "
          f"{i8_ref['query_']:.4f} + {i8_ref['beam_att_kernel']:.4f} = "
          f"{i8_ref['total']:.4f} (events {i8_ref_ms:.4f}); plain "
          f"{i8_plain:.4f} ms; bound {i8_bound:.4f} ms ({i8_by}; bytes "
          f"{i8_bytes_ms:.4f}, tanh at {SFU_OPS_CLK} a clock on {sms} SMs "
          f"at {SM_CLOCK_HZ / 1e6:.0f} MHz)")
    for tag, r in enc_times.items():
        print(f"encoder forward_raw_batch {tag} bs={ENC_BS} 448x448: "
              f"{r['ms']:.2f} ms median of 5 -> {r['images_per_s']:.1f} "
              "images/s")
    print(f"attention v1 bf16 bs={BS} B={BEAM}, device ms: query "
          f"{a_dev['query_']:.4f} + attention {a_dev['beam_att_kernel']:.4f}"
          f" = {a_dev['total']:.4f} (events {a_ms:.4f}; with tanhf "
          f"{a_tanhf['beam_att_kernel']:.4f}, total {a_tanhf['total']:.4f});"
          f" v2 {v2_dev['query_']:.4f} + {v2_dev['beam_att_kernel']:.4f} = "
          f"{v2_dev['total']:.4f} (events {v2_ms:.4f}); bound "
          f"{a_bound:.4f} ms")
    print(f"attention v1 bf16 bs={BS} by beam, device ms (query + "
          "attention): " + ", ".join(
              f"B={b_} {d['query_']:.4f} + {d['beam_att_kernel']:.4f}"
              for b_, d in sorted(a_by_beam.items())))
    print(f"attention v1 f32 bs={BS}, device ms: query "
          f"{a32_dev['query_']:.4f} + attention "
          f"{a32_dev['beam_att_kernel']:.4f} = {a32_dev['total']:.4f} "
          f"(events {a32_ms:.4f}; bound {a32_bound:.4f} ms)")
    print(f"classifier_topk bf16 rows={rows} H={H} V={VOCAB} k={BEAM}, "
          f"device ms: pass 1 {tk_dev['topk_wgmma']:.4f} + merge "
          f"{tk_dev['topk_merge']:.4f} = {tk_dev['total']:.4f} (events "
          f"{tk_ms:.4f}); bound {tk_bound:.4f} ms ({tk_by}); bf16 "
          f"torch.matmul of the product alone {mm16_dev:.4f} (events "
          f"{mm16_ms:.4f})")
    print(f"attention v2 f32 bs={BS}: {v2_32:.4f} ms; classifier_topk "
          f"f32, device ms: tiles {tk32_dev['topk_tiles_f32']:.4f} + merge "
          f"{tk32_dev['topk_merge']:.4f} = {tk32_dev['total']:.4f} (events "
          f"{tk32_ms:.4f}; plain {tk32_plain:.4f} ms, bound "
          f"{tk32_bound:.4f} ms)")
    print(f"serving step bf16 bs={BS}: {step_s * 1e3:.2f} ms median of 5 "
          f"-> {BS / step_s:.1f} captions/s (detector alone "
          f"{detect_s * 1e3:.2f} ms); plain path {plain_step_s * 1e3:.2f} ms "
          f"-> {BS / plain_step_s:.1f} captions/s")
    print("serving step bf16 by switch (random weights, median of 6 taken "
          "in turns): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in steps_by_switch.items()))
    for name, r in trained_step.items():
        print(f"trained weights, {name}: {r['step_s'] * 1e3:.2f} ms -> "
              f"{r['captions_per_s']:.1f} captions/s, caption length mean "
              f"{r['mean_len']:.2f} max {r['max_len']}"
              + (f", {r['decode_steps']} decode steps"
                 if "decode_steps" in r else ""))
    for k in kernels:
        k["design"] = DESIGNS[k["name"]]
        print(f"  {k['name']} ({k['design']}): {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} "
              f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"{k['launches']} launches on the main path")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=2)

    # -- 6. result lines ------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``insenticap_model_tpu_torch/
csrc`` (``nvcc`` for sm_90a, into the git-ignored build directory), then:

1. prints the card's name and power limit and the build time;
2. holds every kernel against its plain PyTorch version on the card, at
   the serving shapes (bs=384; attention in bf16 and f32, the Winograd
   transforms in bf16), with the tolerances stated at each check;
3. drives the main path: a full-width bf16 ``DynamicBatcher`` (512-d
   model, 2048-d 14x14 features, vocab 10,000, beam 3, 16 tokens, random
   weights from a seed) answers 41 requests from threads, mixing auto and
   forced sentiment labels so that the 1-, 8- and 32-row buckets dispatch,
   with every kernel's launch count set to 0 just before and read just
   after;
4. runs ``detect_and_decode`` at bs=384 in f32 on the kernel path and on
   the plain path, and requires identical labels, identical top-beam
   tokens on at least 99% of the images and, on those, top-beam scores
   within 1e-3;
5. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (median of 5
   runs after warm-up), and the bf16 serving step at bs=384 in captions/s;
6. prints one ``kernels`` JSON line (every check above passed, or the run
   would have stopped), the card's name and power limit, then
   ``{"ok": true, "device": ...}``.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero at once where CUDA is absent or the package is
not beside it. Details go to ``chiprun_out/chip_smoke.json``.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOP_S = 67e12           # f32 outside the tensor cores
BF16_FLOP_S = 989e12         # bf16 tensor cores, dense

BS = 384
VOCAB = 10_000
BEAM = 3
T = 16
M = 10                       # sentiment words per request
NUM_CATS = 3


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _ms(torch, fn, reps=20, warm=3, runs=5):
    """Median over ``runs`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def _bound(nbytes, flops, rate):
    mem, ops = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


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
        from insenticap_model_tpu_torch.config import Settings
        from insenticap_model_tpu_torch.models import captioner as cap
        from insenticap_model_tpu_torch.models import sentiment_detector as sd
        from insenticap_model_tpu_torch.ops import _build
        from insenticap_model_tpu_torch.ops import fused_attention as fa
        from insenticap_model_tpu_torch.ops import winograd_kernels as wk
        from insenticap_model_tpu_torch.ops.winograd import transform_filter
        from insenticap_model_tpu_torch.serving_daemon import (
            AUTO, DynamicBatcher)
        from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    except ImportError as e:
        _fail(f"the port's package is not importable here: {e}")
    import numpy as np

    dev = torch.device("cuda")
    report = {}

    # -- 1. device and build ------------------------------------------------
    smi = _smi()
    print(f"device: {smi}")
    t0 = time.time()
    _build.build(["fused_attention", "winograd"])   # one nvcc each, together
    build_s = time.time() - t0
    print(f"kernel build: {build_s:.1f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report["build_s"] = build_s

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
    for dt in (torch.bfloat16, torch.float32):
        p_cont = (cap16 if dt == torch.bfloat16 else cap32)[
            "attention"]["cont"]
        h = (torch.rand(BS * BEAM, H, generator=g, device=dev) * 2 - 1).to(dt)
        att = torch.rand(BS, N, Fe, generator=g, device=dev).to(dt)
        p_att = torch.rand(BS, N, Ah, generator=g, device=dev).to(dt)
        got = fa.beam_content_attention(h, p_cont, att, p_att, B=BEAM)
        torch.cuda.synchronize()
        want = fa.beam_content_attention_plain(h, p_cont, att, p_att, B=BEAM)
        if dt == torch.bfloat16:   # one bf16 rounding of the same f32 value
            ok, err = _within_rounding(torch, got, want, 1e-2, 1e-3)
        else:                      # f32: another order of the same sums
            ok, err = _within_rounding(torch, got, want, 1e-4, 1e-4)
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        checks[f"attention_{tag}"] = err
        print(f"check attention {tag} bs={BS}: max_abs_err={err:.3g} "
              f"{'ok' if ok else 'FAIL'}")
        _check(ok, f"attention kernel {tag} disagrees with its plain version")
        att_in[dt] = (h, p_cont, att, p_att)

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

    # the whole stack: kernels against the plain stack at the same cast
    # points, and both against the f32 direct conv chain
    layers16 = [(c["weight"], c["bias"]) for c in convs]
    stack_k = wk.conv3x3_stack_sm(x16, layers16).float()
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

    # -- 3. the main path: full-width bf16 serving through DynamicBatcher --
    rng = np.random.default_rng(2)
    n_req = 41
    fcs = rng.random((n_req, settings.fc_feat_dim), np.float32)
    atts = rng.random((n_req, 14, 14, C0), np.float32)
    sentis = rng.integers(4, VOCAB, size=(n_req, M))
    forced = [AUTO] + [AUTO, 1, AUTO, 0, 2, AUTO] + \
        [AUTO if i % 3 else i % NUM_CATS for i in range(30)] + [0, 1, 2, 1]
    results = [None] * n_req
    batcher = DynamicBatcher(cap32, det32, settings=settings, ids=ids,
                             beam_size=BEAM, max_seq_len=T,
                             max_wait_s=0.25, num_sentiments=M,
                             num_cats=NUM_CATS, compute_dtype="bfloat16",
                             device=dev)
    try:
        batcher.warm([1, 8, 32])
        torch.cuda.synchronize()
        counters = (fa.beam_content_attention, wk.wino_input,
                    wk.wino_middle, wk.wino_output)
        for c in counters:
            c.launches = 0
        errors = []

        def ask(i):
            try:
                results[i] = batcher.submit(fcs[i], atts[i], sentis[i],
                                            forced_label=forced[i],
                                            timeout=600)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(repr(e))

        t0 = time.time()
        for group in ([0], range(1, 7), range(7, 37), range(37, 41)):
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in group]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
                _check(not th.is_alive(), "a request never returned")
        serve_s = time.time() - t0
        launches = {"beam_content_attention":
                    fa.beam_content_attention.launches,
                    "wino_input": wk.wino_input.launches,
                    "wino_middle": wk.wino_middle.launches,
                    "wino_output": wk.wino_output.launches}
        stats = batcher.stats()
    finally:
        batcher.close()
    _check(not errors, f"requests failed: {errors}")
    for seqs, scores, label in results:
        _check(seqs.shape == (BEAM, T), f"seqs shape {seqs.shape}")
        _check(seqs.min() >= 0 and seqs.max() < VOCAB, "token id range")
        _check(np.isfinite(scores).all(), "non-finite score")
        _check((np.diff(scores) <= 0).all(), "scores not descending")
        _check(0 <= label < NUM_CATS, f"label {label}")
    by = stats["by_bucket"]
    _check(by[1] >= 1 and by[8] >= 1 and by[32] >= 1,
           f"buckets dispatched: {by}")
    print(f"serve: {n_req} requests in {serve_s:.2f} s, batches by bucket "
          f"{by}, launches {launches}")
    for k, n_launch in launches.items():
        _check(n_launch > 0, f"kernel {k} never launched on the main path")
    report.update(serve_s=serve_s, by_bucket=by, launches=launches,
                  labels=sorted({r[2] for r in results}))

    # -- 4. f32 end to end: kernel path against the plain path -------------
    params32 = inference.ServingParams(cap32, det32)
    fc = torch.rand(BS, settings.fc_feat_dim, generator=g, device=dev)
    att = torch.rand(BS, 14, 14, C0, generator=g, device=dev)
    sw = torch.randint(4, VOCAB, (BS, M), generator=g, device=dev)
    kw = dict(settings=settings, ids=ids, beam_size=BEAM, max_seq_len=T)
    ks, ksc, kl = inference.detect_and_decode(params32, fc, att, sw, **kw)
    ps, psc, pl = inference.detect_and_decode(params32, fc, att, sw,
                                              use_kernels=False, **kw)
    # the score bound holds where the top beams are the same caption; an
    # image whose search took another path at a near-tie (random weights
    # give a flat 10,000-word distribution) scores another caption
    eq = (ks[:, 0] == ps[:, 0]).all(dim=1)
    same = eq.float().mean().item()
    dscore = (ksc[eq, 0] - psc[eq, 0]).abs().max().item() if eq.any() \
        else float("inf")
    print(f"f32 bs={BS} kernel vs plain: labels equal "
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
    _check(torch.equal(kl, pl), "labels differ between kernel and plain")
    _check(same >= 0.99, f"top-beam tokens identical on only {same:.2%}")
    _check(dscore <= 1e-3, f"top-beam score diff {dscore}")
    report.update(e2e_f32_top_beam_identical=same,
                  e2e_f32_max_score_diff=dscore, e2e_f32_diverged=diverged)
    del ks, ps, params32
    torch.cuda.empty_cache()

    # -- 5. times ------------------------------------------------------------
    kernels = []
    h, p_cont, att16, p_att16 = att_in[torch.bfloat16]
    a_ms = _ms(torch, lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM))
    a_plain = _ms(torch, lambda: fa.beam_content_attention_plain(
        h, p_cont, att16, p_att16, B=BEAM), reps=5)
    rows = BS * BEAM
    a_bytes = 2 * (rows * H + Ah * H + Ah + Ah + BS * N * (Ah + Fe)
                   + rows * Fe)
    a_flops = 2 * rows * H * Ah + 3 * rows * N * Ah + 5 * rows * N \
        + 2 * rows * N * Fe
    a_bound, a_by = _bound(a_bytes, a_flops, F32_FLOP_S)
    h32, p32, att32, patt32 = att_in[torch.float32]
    a32_ms = _ms(torch, lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM))
    a32_bound, _ = _bound(2 * a_bytes, a_flops, F32_FLOP_S)
    report["attention_f32"] = {"ms": a32_ms, "bound_ms": a32_bound}
    per_batch = launches["beam_content_attention"] / stats["batches"]
    kernels.append({
        "name": "beam_content_attention",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "insenticap_model_tpu/ops/fused_attention.py:27",
        "launches": launches["beam_content_attention"],
        "max_abs_err": checks["attention_bf16"],
        "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
        "bound_by": a_by, "library_ms": None, "passed": True})

    x16 = torch.rand(14, 14, BS, C0, generator=g, device=dev).to(
        torch.bfloat16)
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
    for name, replaces, kfn, pfn, nbytes, flops in specs:
        k_ms = _ms(torch, kfn)
        p_ms = _ms(torch, pfn, reps=3)
        bnd, by_ = _bound(nbytes, flops, F32_FLOP_S)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "insenticap_model_tpu_torch/csrc/winograd.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": checks[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd, "bound_by": by_, "library_ms": None,
            "passed": True})

    # the whole stack (kernels + the two products) beside the library's
    # two bf16 convolutions on the same input, NCHW as cuDNN prefers
    stack_ms = _ms(torch, lambda: wk.conv3x3_stack_sm(x16, layers16),
                   reps=5)
    xn = x16.permute(2, 3, 0, 1).contiguous()
    wn = [c["weight"].permute(3, 2, 0, 1).contiguous() for c in convs]

    def lib():
        with nn.exact_numerics():
            y = torch.nn.functional.conv2d(xn, wn[0], b1, padding=1)
            return torch.nn.functional.conv2d(y, wn[1], b2, padding=1)
    lib_ms = _ms(torch, lib, reps=5)
    gemm_flops = 2 * 49 * 9 * BS * (C0 * c1 + c1 * c2)
    stack_bytes = 2 * (14 * 14 * BS * C0 + 14 * 14 * BS * c2
                       + 9 * (C0 * c1 + c1 * c2))
    stack_bound = max(stack_bytes / HBM_BYTES_S, gemm_flops / BF16_FLOP_S) \
        * 1e3
    report["winograd_stack"] = {"ms": stack_ms, "library_ms": lib_ms,
                                "bound_ms": stack_bound}
    del v, v2, m1, m2, xn

    # the serving step: detect + decode, bf16, bs=384, host clock; its
    # detector alone; and the same step on the plain path
    params16 = inference.ServingParams(cap16, det16)
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
    step_s = wall_s(lambda: inference.detect_and_decode(
        params16, fc16, att16b, sw, **kw))
    detect_s = wall_s(lambda: sd.sample(det16, att16b, 0.7, ids.neutral))
    plain_step_s = wall_s(lambda: inference.detect_and_decode(
        params16, fc16, att16b, sw, use_kernels=False, **kw), runs=3)
    report.update(serve_step_bs384_bf16_s=step_s,
                  captions_per_s=BS / step_s, detect_bs384_bf16_s=detect_s,
                  plain_serve_step_bs384_bf16_s=plain_step_s,
                  plain_captions_per_s=BS / plain_step_s, device=smi,
                  checks=checks, kernels=kernels,
                  attention_launches_per_batch=per_batch,
                  total_s=time.time() - t_start)
    print(f"winograd stack bf16 bs={BS}: {stack_ms:.3f} ms (bound "
          f"{stack_bound:.3f} ms), F.conv2d two convs {lib_ms:.3f} ms")
    print(f"attention f32 bs={BS}: {a32_ms:.4f} ms (bound "
          f"{a32_bound:.4f} ms)")
    print(f"serving step bf16 bs={BS}: {step_s * 1e3:.2f} ms median of 5 "
          f"-> {BS / step_s:.1f} captions/s (detector alone "
          f"{detect_s * 1e3:.2f} ms); plain path {plain_step_s * 1e3:.2f} ms "
          f"-> {BS / plain_step_s:.1f} captions/s")
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
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

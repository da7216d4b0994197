#!/usr/bin/env python3
"""Int8 feasibility measurements on one NVIDIA card (H100 class): the
PyTorch port's twin of ``tools/bench_int8.py``, with its three modes.

- ``detector``: the detector's conv1, [384,14,14,2048] -> 1024, 3x3 SAME.
  The bf16 direct convolution (``F.conv2d``) against the same convolution
  in int8 with int32 sums, written as nine shifted [rows, Cin] x [Cin,
  Cout] int8 products (``F.conv2d`` refuses int8 on CUDA), against the
  nine products without the shifts (the int8 tensor cores' ceiling) and
  the same nine products in bf16 (the control), and one tap's product
  alone in int8 and bf16. The int8 products run with the weights in both
  layouts: row-major [Cin, Cout], and column-major (``col_major``), the
  layout cuBLASLt's int8 kernels take as it is. The H100 runs int8 at
  twice its bf16 rate (1,979 against 989 T/s, dense).
- ``stack``: the detector's two-conv stack [384,14,14,2048] -> 1024 ->
  512 as the port runs it (bf16 Winograd F(5x5,3x3), the port's kernels
  ``ops/winograd_kernels.conv3x3_stack_sm``) against a whole int8 stack: a
  dynamic per-batch activation scale, per-output-channel weight scales,
  int32 sums, a requantisation between the convs and the final dequant
  plus bias, with the weights in both layouts; then the int8 stack's error
  against the f32 direct stack.
- ``attention``: the beam-shared attention at bs=384, N=196, 512 wide,
  beam 3: the bf16 v1 kernel (``ops/fused_attention``) against the
  int8-storage kernel (``ops/fused_attention_i8``, per (image, channel)
  scales), both on the card, by the device time that ``torch.profiler``
  records (``utils/timing.device_ms_by_name``, the query product and the
  attention apart) beside CUDA events, and the int8 context's error
  against the bf16 kernel's (as the JAX tool reports it) and against the
  f32 ideal (the plain version in f32 on the unquantised values).

    python3 tools/bench_torch_int8.py [detector|stack|attention|both]
                                      [--root DIR]

("both" runs all three, as in the JAX tool.) The int8 products go through
``torch._int_mm`` on the card, which needs M > 16 and K, N multiples of 8
(checked on an H100: M = 16 and K or N = 12 are refused); on the CPU the
same functions take an int32 ``torch.matmul``, so that the tests can run
them. With the activations row-major, as here, row-major weights are
cuBLASLt's "NN" case and column-major weights its "TN" case. Times are
CUDA events around back-to-back calls after a warm-up, the median of
``reps`` runs (below some 45 us a call they also read the host's dispatch,
hence the attention's device times); the JAX tool's fold-back through a
``lax.scan`` only keeps XLA from eliding steps, which eager PyTorch does
not do. ``--root`` imports the package from another checkout that lies
inside this one (an earlier commit unpacked by ``git archive`` into a
git-ignored directory; run the two in turns, in one call, to compare
them); the kernels are then built into that copy. A failure raises. It
needs a CUDA card and exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

BS = 384
MODES = ("detector", "stack", "attention", "both")
# device activities of one call: v1's query product and attention, the
# int8 kernel's (its first design had no query launch)
V1_PARTS = ("query_", "beam_att_kernel")
I8_PARTS = ("query_", "beam_att_i8_kernel")


# ------------------------------------------------------------ int8 products

def int_mm(a, b):
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N], exact. On the card
    ``torch._int_mm`` (M > 16, K and N multiples of 8), b row-major or
    column-major as given; on the CPU an int32 ``torch.matmul``."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8: {a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return torch.matmul(a.int(), b.int())
    (M, K), N = a.shape, b.shape[1]
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"torch._int_mm needs M > 16 and K, N % 8 == 0: "
                         f"M={M}, K={K}, N={N}")
    return torch._int_mm(a.contiguous(), b)


def col_major(w):
    """w [..., K, N] with the same values, each [K, N] matrix stored
    column-major (N-major, as ``w.transpose(-1, -2).contiguous()``)."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def conv3x3_int8(x, w):
    """3x3 SAME convolution of int8 x [bs, H, W, Cin] with int8 w [3, 3,
    Cin, Cout] (HWIO), int32 sums [bs, H, W, Cout]: nine shifted products,
    the cross-correlation ``lax.conv_general_dilated`` computes."""
    bs, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + wd].reshape(-1, cin)
            t = int_mm(tap, w[dy, dx])
            acc = t if acc is None else acc + t
    return acc.view(bs, h, wd, -1)


def quantize_weight(w):
    """Per-output-channel int8 weights: s = max|w| over (kh, kw, Cin) / 127
    (+ 1e-12), q = clip(round(w / s), ±127); f32 arithmetic."""
    w = w.float()
    s = w.abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
    return torch.round(w / s).clamp(-127, 127).to(torch.int8), s


def _quantize_tensor(x):
    s = x.abs().max().float() / 127.0 + 1e-12
    return torch.round(x.float() / s).clamp(-127, 127).to(torch.int8), s


def int8_stack(x, qlayers):
    """The whole int8 stack of the JAX tool (bench_int8.py:180-197,
    217-232): x [bs, H, W, C0] (any float dtype), qlayers = [(w1q, w1s,
    b1), (w2q, w2s, b2)] from ``quantize_weight`` with f32 biases.
    Returns {"a1", "a2": the int32 sums, "y": the f32 output}."""
    (w1q, w1s, b1), (w2q, w2s, b2) = qlayers
    xq, s_x = _quantize_tensor(x)
    a1 = conv3x3_int8(xq, w1q)
    y1 = a1.float() * (s_x * w1s) + b1
    y1q, s_1 = _quantize_tensor(y1)
    a2 = conv3x3_int8(y1q, w2q)
    return {"a1": a1, "a2": a2, "y": a2.float() * (s_1 * w2s) + b2}


# ------------------------------------------------------------------ modes

def _normal(g, shape, device, scale=1.0):
    return torch.randn(shape, generator=g, device=device) * scale


def detector(device, iters=8, reps=4, hw=14, cin=2048, cout=1024, bs=BS):
    """conv1 four ways (the int8 ones with the weights in both layouts)
    and one tap's product alone; returns {name: ms}."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.utils.timing import cuda_ms
    g = torch.Generator(device=device).manual_seed(0)
    x_f = _normal(g, (bs, hw, hw, cin), device)
    w_f = _normal(g, (3, 3, cin, cout), device, 0.02)
    x8 = torch.round(x_f * 40).clamp(-127, 127).to(torch.int8)
    w8 = torch.round(w_f * 1000).clamp(-127, 127).to(torch.int8)
    xb, wb = x_f.bfloat16(), w_f.bfloat16()
    del x_f, w_f
    rows = bs * hw * hw
    x8r, xbr = x8.reshape(rows, cin), xb.reshape(rows, cin)
    w8c = w8.reshape(9, cin, cout)
    wbc = wb.reshape(9, cin, cout)
    layouts = {"row-major": (w8, w8c), "column-major": (col_major(w8),
                                                        col_major(w8c))}

    def taps_int8(wc):
        acc = int_mm(x8r, wc[0])
        for k in range(1, 9):
            acc += int_mm(x8r, wc[k])
        return acc

    def taps_bf16():
        acc = (xbr @ wbc[0]).float()
        for k in range(1, 9):
            acc += xbr @ wbc[k]
        return acc

    kw = dict(iters=iters, reps=reps, warm=1)
    with nn.exact_numerics():
        res = {"conv1 direct bf16 (F.conv2d)": cuda_ms(
            lambda: nn.conv2d({"weight": wb}, xb), **kw)}
        for lay, (w, wc) in layouts.items():
            res[f"conv1 int8 nine shifted products, {lay} weights"] = \
                cuda_ms(lambda: conv3x3_int8(x8, w), **kw)
            res[f"conv1 9-tap int8 products, no shifts, {lay} weights"] = \
                cuda_ms(lambda: taps_int8(wc), **kw)
        res["conv1 9-tap bf16 products (control)"] = cuda_ms(taps_bf16, **kw)
        for lay, (_, wc) in layouts.items():
            res[f"one tap int8 [{rows}x{cin}]@[{cin}x{cout}], {lay} "
                "weights"] = cuda_ms(lambda: int_mm(x8r, wc[0]), **kw)
        res[f"one tap bf16 [{rows}x{cin}]@[{cin}x{cout}]"] = cuda_ms(
            lambda: xbr @ wbc[0], **kw)
    return res


def stack(device, iters=8, reps=4, hw=14, chans=(2048, 1024, 512), bs=BS):
    """The bf16 Winograd stack against the int8 stack; returns {name: ms}
    and the int8 stack's error against the f32 direct stack."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.utils.timing import cuda_ms
    g = torch.Generator(device=device).manual_seed(0)
    c0, c1, c2 = chans
    x_f = _normal(g, (bs, hw, hw, c0), device, 0.5).abs()
    w1, w2 = _normal(g, (3, 3, c0, c1), device, 0.02), \
        _normal(g, (3, 3, c1, c2), device, 0.02)
    b1, b2 = _normal(g, (c1,), device, 0.01), _normal(g, (c2,), device, 0.01)
    xb = x_f.bfloat16()
    layers16 = [(w1.bfloat16(), b1.bfloat16()), (w2.bfloat16(),
                                                   b2.bfloat16())]
    qlayers = [quantize_weight(w1) + (b1,), quantize_weight(w2) + (b2,)]
    qlayers_cm = [(col_major(q), s, b) for q, s, b in qlayers]
    kw = dict(iters=iters, reps=reps, warm=1)
    res = {"stack f5 Winograd bf16 (the port's kernels)": cuda_ms(
        lambda: wk.conv3x3_stack_sm(xb.permute(1, 2, 0, 3), layers16)
        .permute(2, 0, 1, 3), **kw)}
    for lay, ql in (("row-major", qlayers), ("column-major", qlayers_cm)):
        res[f"stack int8 (dynamic activation scale), {lay} weights"] = \
            cuda_ms(lambda: int8_stack(xb, ql)["y"].to(xb.dtype), **kw)
    ref = nn.conv2d({"weight": w2, "bias": b2},
                    nn.conv2d({"weight": w1, "bias": b1}, x_f))
    got = int8_stack(x_f, qlayers)["y"]
    err = (got - ref).abs()
    ref_mean = float(ref.abs().mean())
    return res, {"err_mean": float(err.mean()), "err_max": float(err.max()),
                 "ref_mean_abs": ref_mean,
                 "rel": float(err.mean()) / (ref_mean + 1e-9)}


def attention_inputs(device, bs=BS, beam=3, n=196, width=512, seed=0):
    """The JAX tool's attention inputs, made on the card from a seed:
    standard-normal att/p_att (f32, and their int8 + scales), h and the
    content-attention weights in bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    att_f = _normal(g, (bs, n, width), device)
    patt_f = _normal(g, (bs, n, width), device)
    h0 = _normal(g, (bs * beam, width), device, 0.1).bfloat16()
    p_cont = {"h2att": {"weight": _normal(g, (width, width), device,
                                          0.05).bfloat16(),
                        "bias": torch.zeros(width, device=device,
                                            dtype=torch.bfloat16)},
              "att_alpha": {"weight": _normal(g, (1, width), device,
                                              0.05).bfloat16()}}
    return h0, p_cont, att_f, patt_f


def attention(device, iters=16, reps=8, warm=3, **shape):
    """The bf16 v1 kernel against the int8-storage kernel. Returns (times
    {"bf16_ms", "int8_ms": CUDA events; "bf16_device_ms",
    "int8_device_ms": {part: device ms a call} over ``V1_PARTS`` and
    ``I8_PARTS`` and "total"}, errors, calls {"v1", "i8"}: the number of
    kernel calls made)."""
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.ops import fused_attention_i8 as fa8
    from insenticap_model_tpu_torch.utils.timing import (
        cuda_ms, device_ms_by_name, launches_per_call)
    beam = shape.get("beam", 3)
    h0, p_cont, att_f, patt_f = attention_inputs(device, **shape)
    att, patt = att_f.bfloat16(), patt_f.bfloat16()
    att_q, att_s = fa8.quantize_per_channel(att_f)
    patt_q, patt_s = fa8.quantize_per_channel(patt_f)
    calls = {"v1": 0, "i8": 0}

    def bf16():
        calls["v1"] += 1
        return fa.beam_content_attention(h0, p_cont, att, patt, B=beam,
                                         variant="v1")

    def i8():
        calls["i8"] += 1
        return fa8.beam_content_attention_i8(h0, p_cont, att_q, att_s,
                                             patt_q, patt_s, B=beam)

    kw = dict(iters=iters, reps=reps, warm=warm)
    once = {"v1": launches_per_call(bf16, {
                p: (fa.beam_content_attention, "launches") for p in V1_PARTS}),
            "i8": launches_per_call(i8, {
                p: (fa8.beam_content_attention_i8, "launches")
                for p in I8_PARTS})}
    times = {"bf16_ms": cuda_ms(bf16, **kw), "int8_ms": cuda_ms(i8, **kw),
             "bf16_device_ms": device_ms_by_name(
                 bf16, V1_PARTS, per_call=once["v1"], iters=iters, warm=warm),
             "int8_device_ms": device_ms_by_name(
                 i8, I8_PARTS, per_call=once["i8"], iters=iters, warm=warm)}
    got, ref = i8().float(), bf16().float()
    ideal = fa.beam_content_attention_plain(
        h0.float(), {k: {kk: vv.float() for kk, vv in v.items()}
                     for k, v in p_cont.items()}, att_f, patt_f, B=beam)
    errors = {}
    for name, want in (("vs_bf16_kernel", ref), ("vs_f32_ideal", ideal)):
        err = (got - want).abs()
        den = float(want.abs().mean()) + 1e-9
        errors[name] = {"mean": float(err.mean()), "max": float(err.max()),
                        "rel_to_mean": float(err.mean()) / den}
    return times, errors, calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="both", choices=MODES)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    which = args.mode
    root = os.path.realpath(args.root)
    if os.path.commonpath([root, os.path.realpath(HERE)]) != \
            os.path.realpath(HERE):
        ap.error(f"--root {args.root} lies outside this checkout")
    if not torch.cuda.is_available():
        sys.exit("bench_torch_int8: needs a CUDA card")
    sys.path.insert(0, root)
    import insenticap_model_tpu_torch
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    print(f"package: {os.path.dirname(insenticap_model_tpu_torch.__file__)}")
    report = {"device": smi, "root": root}
    if which in ("detector", "both"):
        res = detector(dev)
        base = res["conv1 direct bf16 (F.conv2d)"]
        tap_ops = 2 * BS * 14 * 14 * 2048 * 1024
        for name, t in res.items():
            rate = (f", {tap_ops / t / 1e9:.0f} T/s"
                    if name.startswith("one tap") else "")
            print(f"{name}: {t:.3f} ms ({base / t:.2f}x vs bf16 direct"
                  f"{rate})", flush=True)
        report["detector"] = res
        torch.cuda.empty_cache()
    if which in ("stack", "both"):
        res, err = stack(dev)
        base = res["stack f5 Winograd bf16 (the port's kernels)"]
        for name, t in res.items():
            print(f"{name}: {t:.3f} ms ({base / t:.2f}x vs f5)", flush=True)
        print(f"int8 stack |err| mean {err['err_mean']:.5f} max "
              f"{err['err_max']:.4f} (mean |ref| {err['ref_mean_abs']:.4f}, "
              f"rel {err['rel']:.4%})", flush=True)
        report["stack"] = {"ms": res, "error": err}
        torch.cuda.empty_cache()
    if which in ("attention", "both"):
        times, errors, _ = attention(dev)
        for name, tag in (("bf16 storage (v1 kernel)", "bf16"),
                          ("int8 storage", "int8")):
            d = times[f"{tag}_device_ms"]
            print(f"beam attention {name}: device {d['total']:.4f} ms/step "
                  f"(query {d['query_']:.4f} + attention "
                  f"{d['total'] - d['query_']:.4f}), events "
                  f"{times[f'{tag}_ms']:.4f} ms/step", flush=True)
        ratio = (times["bf16_device_ms"]["total"]
                 / times["int8_device_ms"]["total"])
        print(f"int8 against v1 by device time: {ratio:.2f}x", flush=True)
        for name, e in errors.items():
            print(f"context |err| {name}: mean {e['mean']:.5f} max "
                  f"{e['max']:.4f} (rel-to-mean-|ref| {e['rel_to_mean']:.4%})",
                  flush=True)
        report["attention"] = {"ms": times, "errors": errors}
    print(json.dumps(report))


if __name__ == "__main__":
    main()

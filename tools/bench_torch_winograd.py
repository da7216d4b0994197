#!/usr/bin/env python3
"""The detector's Winograd F(5x5,3x3) transforms on one NVIDIA card (H100
class), at the serving shape: bs=384, 14x14, 2048 -> 1024 -> 512, bf16.

    python3 tools/bench_torch_winograd.py [--rounds N] [--root DIR]
                                          [--out FILE]

Times, by the device time that ``torch.profiler`` records (the kernels
alone, ``utils/timing.device_ms_by_name``) and by CUDA events:
``wino_input`` on contiguous x and on the detector's permuted NHWC view
(its total device time holds any copy the wrapper makes), ``wino_middle``,
``wino_output``, and the whole ``conv3x3_stack_sm`` on the permuted view,
split by device activity (the three transforms, the products, the rest).
Each kernel is checked against its plain twin first (one bf16 rounding of
the same f32 value: rtol 1e-2 plus 1e-3 of the scale). Beside them, a
device copy of M and of V (``Tensor.copy_``) gives the rate the card
streams such tensors at.

It prints the kernels' registers and spills and measures ``--rounds``
times. ``--root`` imports the package from another checkout that lies
inside this one (an earlier commit unpacked by ``git archive`` into a
git-ignored directory, to compare two versions in one call); the kernels
are then built into that copy. One JSON object a line goes to stdout and,
with ``--out``, to that file. It needs a CUDA card and exits non-zero
without one.
"""
import argparse
import json
import os
import sys

BS, HW, C0, C1, C2 = 384, 14, 2048, 1024, 512
HBM_BYTES_S = 3.35e12
NAMES = ("wino_input_kernel", "wino_middle_kernel", "wino_output_kernel")


def main():
    here = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--out", default="")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    root = os.path.realpath(args.root)
    if os.path.commonpath([root, here]) != here:
        ap.error(f"--root {args.root} lies outside this checkout")
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_winograd: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.ops import _build
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.ops.winograd import transform_filter
    from insenticap_model_tpu_torch.utils.timing import (cuda_ms,
                                                         device_ms_by_name)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.rand(BS, HW, HW, C0, generator=g, device=dev).bfloat16()
    xv = feats.permute(1, 2, 0, 3)                 # the detector's view
    x = xv.contiguous()
    ws = [(torch.randn(3, 3, ci, co, generator=g, device=dev) * 0.02)
          .bfloat16() for ci, co in ((C0, C1), (C1, C2))]
    bs_ = [torch.randn(co, generator=g, device=dev).bfloat16()
           for co in (C1, C2)]
    us = []
    with nn.exact_numerics():
        for w in ws:
            us.append(transform_filter(w).bfloat16().reshape(
                49, w.shape[2], w.shape[3]))
    with torch.no_grad():
        v1 = wk.wino_input_plain(x)
        m1 = torch.bmm(v1.reshape(49, -1, C0), us[0]).reshape(49, 9, BS, C1)
        v2 = wk.wino_middle_plain(m1, bs_[0], HW, HW)
        m2 = torch.bmm(v2.reshape(49, -1, C1), us[1]).reshape(49, 9, BS, C2)
        want = {"wino_input": v1, "wino_middle": v2,
                "wino_output": wk.wino_output_plain(m2, bs_[1], HW, HW)}
    layers = list(zip(ws, bs_))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    nbytes = {"wino_input": 2 * (HW * HW * BS * C0 + 49 * 9 * BS * C0),
              "wino_middle": 2 * 2 * 49 * 9 * BS * C1 + 4 * C1,
              "wino_output": 2 * (49 * 9 * BS * C2 + HW * HW * BS * C2)
              + 4 * C2}

    def emit(rec):
        rec["device"] = smi
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def measure(rnd):
        calls = {"wino_input": lambda: wk.wino_input(x),
                 "wino_input_view": lambda: wk.wino_input(xv),
                 "wino_middle": lambda: wk.wino_middle(m1, bs_[0], HW, HW),
                 "wino_output": lambda: wk.wino_output(m2, bs_[1], HW, HW)}
        rec = {"round": rnd, "root": root}
        with torch.no_grad():
            for name, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                ref = want[name.replace("_view", "")]
                err = (got.float() - ref.float()).abs()
                tol = 1e-2 * ref.float().abs() + 1e-3 * ref.float().abs().max()
                ok = bool((err <= tol).all())
                dev_ms = device_ms_by_name(fn, NAMES)
                kname = name.replace("_view", "") + "_kernel"
                bound = nbytes[name.replace("_view", "")] / HBM_BYTES_S * 1e3
                rec[name] = {"ok": ok, "max_abs_err": float(err.max()),
                             "kernel_device_ms": dev_ms[kname],
                             "total_device_ms": dev_ms["total"],
                             "events_ms": cuda_ms(fn), "bound_ms": bound}
                del got
            stack = lambda: wk.conv3x3_stack_sm(xv, layers)  # noqa: E731
            parts = device_ms_by_name(stack, NAMES + ("gemm", "xmma",
                                                      "nvjet", "copy",
                                                      "elementwise"))
            rec["stack"] = {"device": parts, "events_ms": cuda_ms(
                stack, iters=5)}

            def filters():
                with nn.exact_numerics():
                    return [transform_filter(w).bfloat16() for w in ws]
            rec["filter_transform_device"] = device_ms_by_name(
                filters, ("gemm", "xmma", "nvjet", "copy", "elementwise"))
            vv = [v1.reshape(49, -1, C0), v2.reshape(49, -1, C1)]
            rec["bmm_device"] = [device_ms_by_name(
                lambda i=i: torch.bmm(vv[i], us[i]), ())["total"]
                for i in range(2)]
            # a yardstick of the card's streaming rate: a plain device
            # copy of M (the middle transform's bytes, each way) and of V
            rec["copy_yardstick"] = {}
            for name, src in (("M", m1), ("V", v1)):
                dst = torch.empty_like(src)
                ms = device_ms_by_name(lambda: dst.copy_(src), ())["total"]
                rec["copy_yardstick"][name] = {
                    "device_ms": ms,
                    "tb_s": 2 * src.numel() * src.element_size() / ms / 1e9}
                del dst
        emit(rec)

    def ptxas(log):
        """each kernel instance's registers and spills, one line each"""
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                for k in NAMES:
                    if k in entry:
                        entry = k + entry[entry.index(k) + len(k):][:24]
            elif "spill" in line and entry:
                spill = line.strip()
            elif "registers" in line and entry:
                print(f"  ptxas: {entry}: {line.split(':')[-1].strip()}"
                      f"; {spill}", flush=True)
                entry = ""

    wk._lib()
    ptxas(_build.build_logs.get("winograd", ""))
    for rnd in range(args.rounds):
        measure(rnd)


if __name__ == "__main__":
    main()

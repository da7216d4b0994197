#!/usr/bin/env python3
"""Where the time of the PyTorch port's encode stage goes, on one card.

    python3 tools/profile_torch_encoder.py [--bs 32] [--dtype bfloat16]
        [--bucket 448x448] [--plain]

Builds the patched ResNet-101 at full depth (random weights from a seed:
kaiming-normal convs, BatchNorm at identity) and the 2000-concept MLP,
then times the encode stage four ways:

1. host clock around synchronised ``encoder.forward_raw_batch`` calls
   (median of 5): the forward's time and images/s;
2. the host work around it in ``EncodeBatcher``, each part alone, host
   clock, median of 5: stacking the uint8 images and staging them on the
   card, the concept top-k (f32), and copying fc/att back as f32 numpy;
3. one forward under ``torch.profiler`` (CPU and CUDA activities): the
   union of the device's kernel intervals over the forward's wall time gives
   the device's busy and idle share; device time by kind of kernel
   (convolutions, element-wise passes, the pool kernel, reductions and
   pooling, copies) and by kernel name.

``--plain`` runs the plain max pool instead of the kernel. Prints a summary
and writes the trace and a JSON report under ``chiprun_out/``. It needs a
CUDA card and exits non-zero without one, or when the profiler records no
device activity.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_CONCEPTS = 2000
K_CONCEPTS = 5
# kernel-name fragments -> kind, first match wins
KINDS = (("pool kernel", ("maxpool_kernel",)),
         ("convolution", ("conv", "cudnn", "xmma", "gemm", "implicit",
                          "sm90_", "cutlass", "nchwToNhwc", "nhwcToNchw")),
         ("reduction / pooling", ("reduce", "adaptive", "avg_pool",
                                  "max_pool")),
         ("element-wise", ("elementwise", "vectorized", "unrolled",
                           "Elementwise")),
         ("copy", ("copy", "Memcpy", "Memset", "fill")))


def _wall(torch, fn, runs=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _kind(name):
    for kind, frags in KINDS:
        if any(f in name for f in frags):
            return kind
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--bucket", default="448x448",
                    choices=("448x448", "384x512", "512x384"))
    ap.add_argument("--plain", action="store_true",
                    help="the plain max pool instead of the kernel")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_encoder: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.models import concept_detector as cpt
    from insenticap_model_tpu_torch.models import encoder
    from insenticap_model_tpu_torch.serving.encode import make_cpt_apply
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    params = encoder.init_params(gen, device=dev)
    cpt_params = cpt.init_params(gen, N_CONCEPTS, Settings(), device=dev)
    if args.dtype == "bfloat16":
        params = cast_bf16(params)
    h, w = (int(v) for v in args.bucket.split("x"))
    bs = args.bs
    rng = np.random.default_rng(6)
    host = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for _ in range(bs)]
    imgs = torch.from_numpy(np.stack(host)).to(dev)
    use_kernels = not args.plain
    cpt_apply = make_cpt_apply(cpt_params, K_CONCEPTS)

    def forward():
        return encoder.forward_raw_batch(params, imgs,
                                         use_kernels=use_kernels)

    fwd_s = _wall(torch, forward)
    fc, att = forward()
    stage_s = _wall(torch, lambda: torch.from_numpy(np.stack(host)).to(dev))
    topk_s = _wall(torch, lambda: cpt_apply(fc))
    back_s = _wall(torch, lambda: (fc.float().cpu().numpy(),
                                   att.float().cpu().numpy()))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda_type]
    if not kernels:
        sys.exit("profile_torch_encoder: the profiler recorded no device "
                 "activity: device busy share not measured")
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name, by_kind = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += us
        k = by_kind.setdefault(_kind(e.name), [0, 0.0])
        k[0] += 1
        k[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    report = {
        "device": smi, "bs": bs, "dtype": args.dtype, "bucket": args.bucket,
        "pool": "plain" if args.plain else "kernel",
        "forward_ms": fwd_s * 1e3, "images_per_s": bs / fwd_s,
        "host_stage_ms": stage_s * 1e3, "concept_topk_ms": topk_s * 1e3,
        "copy_back_ms": back_s * 1e3,
        "batch_serial_ms": (stage_s + fwd_s + topk_s + back_s) * 1e3,
        "profiled_wall_ms": prof_wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e3 / (prof_wall_s * 1e3),
        "kernel_launches": len(kernels),
        "by_kind": {k: {"launches": c, "ms": us / 1e3}
                    for k, (c, us) in sorted(by_kind.items(),
                                             key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": k, "launches": c, "ms": us / 1e3}
                        for k, (c, us) in top],
    }
    print(f"device: {smi}")
    print(f"encoder bs={bs} {args.dtype} {args.bucket} pool={report['pool']}"
          f": forward {report['forward_ms']:.2f} ms "
          f"({report['images_per_s']:.1f} images/s); around it, host "
          f"clock: stack + stage {report['host_stage_ms']:.2f} ms, concept "
          f"top-k {report['concept_topk_ms']:.2f} ms, fc/att back as f32 "
          f"numpy {report['copy_back_ms']:.2f} ms")
    print(f"profiled forward: wall {report['profiled_wall_ms']:.2f} ms, "
          f"device busy {report['device_busy_ms']:.2f} ms, idle share "
          f"{report['device_idle_share']:.3f}, {len(kernels)} kernel "
          "launches")
    for k, d in report["by_kind"].items():
        print(f"  {d['ms']:8.3f} ms {d['launches']:5d}x  {k}")
    for k in report["top_kernels"]:
        print(f"  {k['ms']:8.3f} ms {k['launches']:5d}x  {k['name'][:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    tag = f"{report['pool']}_{args.dtype}_{args.bucket}_bs{bs}"
    prof.export_chrome_trace(os.path.join("chiprun_out",
                                          f"encode_trace_{tag}.json"))
    with open(os.path.join("chiprun_out", f"encode_profile_{tag}.json"),
              "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving step goes, on one card.

    python3 tools/profile_torch_serving.py [--bs 384] [--dtype bfloat16]
        [--plain] [--switches default|fused_topk|v2|both] [--trained]

Builds the full-width model (``Settings()`` defaults, vocab 10,000, beam
3, 16 tokens, random weights from a seed and uniform features; with
``--trained`` the captioner of ``assets/bench_trained.ckpt`` and
standard-normal features), sets the kernel switches (``--switches``:
``ISC_FUSED_TOPK=1``, ``ISC_ATT_KERNEL=v2`` or both), warms
``detect_and_decode`` up, then times it three ways:

1. host clock around synchronised steps (median of 5): the step time;
2. the detector alone and the beam decode alone, the same way;
3. one step under ``torch.profiler`` (CPU and CUDA activities): the union
   of the device's kernel intervals over the step's wall time gives the
   device's busy and idle share; device time by kernel name, and the
   number of kernel launches and of host-device synchronisations.

Prints a summary and writes the trace and a JSON report under
``chiprun_out/``. It needs a CUDA card and exits non-zero without one, or
when the profiler records no device activity.
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

VOCAB = 10_000
SWITCHES = {"default": {}, "fused_topk": {"ISC_FUSED_TOPK": "1"},
            "v2": {"ISC_ATT_KERNEL": "v2"},
            "both": {"ISC_FUSED_TOPK": "1", "ISC_ATT_KERNEL": "v2"}}
TRAINED_CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "bench_trained.ckpt")
BEAM = 3
T = 16
M = 10
NUM_CATS = 3


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=384)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--plain", action="store_true",
                    help="profile the plain PyTorch path instead")
    ap.add_argument("--switches", default="default", choices=SWITCHES,
                    help="kernel switches to set for the run")
    ap.add_argument("--trained", action="store_true",
                    help="the trained captioner and standard-normal "
                    "features")
    args = ap.parse_args()
    for k in ("ISC_FUSED_TOPK", "ISC_ATT_KERNEL"):
        os.environ.pop(k, None)
    os.environ.update(SWITCHES[args.switches])

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from insenticap_model_tpu_torch import inference
    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    from insenticap_model_tpu_torch.ops import beam
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16, cast_f32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    s = Settings()
    ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
    gen = torch.Generator().manual_seed(0)
    if args.trained:
        captioner = tck.load(TRAINED_CKPT, device=dev)[0]["captioner"]
    else:
        captioner = cap.init_params(gen, VOCAB, NUM_CATS, s, device=dev)
    params = inference.ServingParams(
        captioner, sd.init_params(gen, NUM_CATS, s, device=dev))
    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = inference.ServingParams(*map(
        cast_bf16 if dt == torch.bfloat16 else cast_f32, params))
    g = torch.Generator(device=dev).manual_seed(1)
    bs = args.bs
    feats = torch.randn if args.trained else torch.rand
    fc = feats(bs, s.fc_feat_dim, generator=g, device=dev).to(dt)
    att = feats(bs, 14, 14, s.att_feat_dim, generator=g, device=dev).to(dt)
    sw = torch.randint(4, VOCAB, (bs, M), generator=g, device=dev)
    use_kernels = not args.plain
    kw = dict(settings=s, ids=ids, beam_size=BEAM, max_seq_len=T)

    def step():
        return inference.detect_and_decode(params, fc, att, sw,
                                           use_kernels=use_kernels, **kw)
    labels = sd.sample(params.senti_detector, att, 0.7, ids.neutral,
                       use_kernels=use_kernels)[0]

    def decode():
        ctx = cap.build_visual_context(params.captioner, fc, att,
                                       senti_words=sw, senti_labels=labels)
        return beam.beam_search_batched(
            params.captioner, ctx, settings=s, ids=ids, beam_size=BEAM,
            max_seq_len=T, mode="rl", use_kernels=use_kernels)

    step_s = _wall(torch, step)
    detect_s = _wall(torch, lambda: sd.sample(
        params.senti_detector, att, 0.7, ids.neutral,
        use_kernels=use_kernels))
    decode_s = _wall(torch, decode)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda_type]
    if not kernels:
        sys.exit("profile_torch_serving: the profiler recorded no device "
                 "activity: device busy share not measured")
    first = min(e.time_range.start for e in kernels)
    last = max(e.time_range.end for e in kernels)
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    syncs = sum(1 for e in prof.events()
                if e.device_type != cuda_type and e.name in (
                    "cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaMemcpyAsync"))
    report = {
        "device": smi, "bs": bs, "dtype": args.dtype,
        "path": "plain" if args.plain else "kernels",
        "switches": args.switches,
        "weights": "trained" if args.trained else "random",
        "step_ms": step_s * 1e3, "captions_per_s": bs / step_s,
        "detect_ms": detect_s * 1e3, "decode_ms": decode_s * 1e3,
        "profiled_step_wall_ms": prof_wall_s * 1e3,
        "device_span_ms": (last - first) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e3 / (prof_wall_s * 1e3),
        "kernel_launches": len(kernels),
        "host_syncs_and_copies": syncs,
        "top_kernels": [{"name": k, "launches": c, "ms": us / 1e3}
                        for k, (c, us) in top],
    }
    print(f"device: {smi}")
    print(f"bs={bs} {args.dtype} {report['path']} switches="
          f"{args.switches} weights={report['weights']}: step "
          f"{report['step_ms']:.2f} ms ({report['captions_per_s']:.1f} "
          f"captions/s), detector {report['detect_ms']:.2f} ms, decode "
          f"{report['decode_ms']:.2f} ms")
    print(f"profiled step: wall {report['profiled_step_wall_ms']:.2f} ms, "
          f"device busy {report['device_busy_ms']:.2f} ms, idle share "
          f"{report['device_idle_share']:.3f}, {len(kernels)} kernel "
          f"launches, {syncs} syncs/copies")
    for k in report["top_kernels"]:
        print(f"  {k['ms']:8.3f} ms {k['launches']:5d}x  {k['name'][:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    tag = (f"{report['path']}_{args.switches}_{report['weights']}_"
           f"{args.dtype}_bs{bs}")
    prof.export_chrome_trace(os.path.join("chiprun_out",
                                          f"serve_trace_{tag}.json"))
    with open(os.path.join("chiprun_out", f"serve_profile_{tag}.json"),
              "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()

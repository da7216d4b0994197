#!/usr/bin/env python3
"""Decode-cell mega-kernel feasibility on one NVIDIA card (H100 class): the
PyTorch port's twin of ``tools/bench_megacell.py``.

A kernel that fused the beam-shared attention with both LSTM cells would
run per image tile (each tile's att/p_att in fast memory), so the LSTM
products would run at M = tile_b x beam rows a tile (24, 48, 96) instead of
one [1152, K] product. This script measures what that costs on the card at
the serving configuration (bs=384, beam 3, H=512): the att_lstm product
[1152, 1536] x [1536, 2048] and the lang_lstm product [1152, 1024] x
[1024, 2048], bf16, through the port's row-tiled kernel
(``ops/tiled_mm.tiled_mm``, ``csrc/tiled_mm.cu``) at each tile size, beside
``torch.matmul`` at the full M = 1152 (the yardstick; the port never calls
it in the kernel's place). Then the H100's budget for such a tile: att and
p_att of tile_b = 4, 8, 16 images against a block's 227 KB of shared
memory, and the LSTM weights against the 50 MB L2.

    python3 tools/bench_torch_megacell.py [--root DIR]

Each product is timed three ways: CUDA events around 64 back-to-back
launches after a warm-up, the median of 10 such runs, which below some
50 us a call also reads the host's dispatch of each launch; the device
time of 64 calls that ``torch.profiler`` records, the kernels alone; and
the host's time to dispatch one call (the host clock around the same 64
launches, taken before the card is waited for). The JAX tool chains its steps
through a ``lax.scan`` that folds each output back into the input; that
only keeps XLA from eliding steps, which eager PyTorch does not do, so the
launches here are independent.

It prints the kernel's registers and spills (ptxas) and, where the
package has one, the wrapper's plan of each product (w resident or
streamed, ring stages, row groups) and the parts of the host's time a
call (``host_parts``). ``--root`` imports the package from
another checkout that lies inside this one (an earlier commit unpacked by
``git archive`` into a git-ignored directory; run the two in turns, in
one call, to compare them); the kernel is then built into that copy. The
results go to stdout as one JSON line (the line that starts with ``{``).
It needs a CUDA card and exits non-zero without one.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

BS, B, H = 384, 3, 512
ROWS = BS * B                               # 1152
TILE_BS = (8, 16, 32)                       # tile_rows 24, 48, 96
LSTM_SHAPES = (("att_lstm", H + 2 * H, 4 * H),    # 1536 -> 2048
               ("lang_lstm", 2 * H, 4 * H))       # 1024 -> 2048
N_REGIONS, ATT_HID, FEAT = 196, 512, 512
SMEM_BYTES = 232_448                        # a block's shared memory, H100
L2_BYTES = 50 * 10**6                       # the H100's L2
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12


def bound_ms(K, N, rows=ROWS):
    """The least time of one bf16 [rows, K] x [K, N] product on the H100:
    (ms, "bytes" or "operations")."""
    mem = 2 * (rows * K + K * N + rows * N) / HBM_BYTES_S * 1e3
    ops = 2 * rows * K * N / BF16_FLOP_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def budget():
    """The H100's arithmetic for one mega-cell tile (bf16 bytes): att and
    p_att of tile_b images against a block's shared memory, the two LSTM
    weights against the L2."""
    w_att = (H + 2 * H) * 4 * H * 2
    w_lang = (2 * H) * 4 * H * 2
    out = []
    for tile_b in (4, 8, 16):
        tile = tile_b * N_REGIONS * (FEAT + ATT_HID) * 2
        out.append({"tile_b": tile_b, "tile_rows": tile_b * B,
                    "att_p_att_bytes": tile,
                    "fits_shared_memory": tile <= SMEM_BYTES,
                    "lstm_weight_bytes": w_att + w_lang,
                    "weights_fit_l2": w_att + w_lang <= L2_BYTES})
    return out


def make_inputs(K, N, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(ROWS, K, generator=g, device=device) * 0.02).bfloat16()
    w = (torch.randn(K, N, generator=g, device=device) * 0.02).bfloat16()
    return x, w


def host_us(fn, iters=64, reps=10, warm=3):
    """The host's time to dispatch one call of ``fn``, in us: the median
    over ``reps`` runs of the host clock around ``iters`` calls, read
    before the card is waited for (64 launches stay within the launch
    queue, so the host never waits for the card inside a run)."""
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def measure(device, iters=64, reps=10, warm=3):
    """Both LSTM products: torch.matmul at M = 1152 and ``tiled_mm`` at
    each tile size, in CUDA-event ms (``cuda_ms``), device ms
    (``device_ms``) and the host's us a call (``host_us``). Returns
    {name: {"shape", "matmul_ms", "matmul_device_ms", "matmul_host_us",
    "tiled_ms": {tile_rows: ms}, "tiled_device_ms": {tile_rows: ms},
    "tiled_host_us": {tile_rows: us}, "bound_ms", "bound_by"}} and, under
    "calls", the
    number of ``tiled_mm`` calls made, counted as they are made (the
    profiler takes a session again when one records nothing). The package
    is the one on ``sys.path`` first (``--root``)."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.ops.tiled_mm import tiled_mm
    from insenticap_model_tpu_torch.utils.timing import cuda_ms, device_ms
    res = {}
    calls = 0

    def tiled(x, w, tr):
        nonlocal calls
        calls += 1
        return tiled_mm(x, w, tile_rows=tr)
    for seed, (name, K, N) in enumerate(LSTM_SHAPES):
        x, w = make_inputs(K, N, device, seed)
        bnd, by = bound_ms(K, N)
        with nn.exact_numerics():          # f32 accumulation, as the kernel
            mm = lambda: torch.matmul(x, w)            # noqa: E731
            r = {"shape": [ROWS, K, N], "bound_ms": bnd, "bound_by": by,
                 "matmul_ms": cuda_ms(mm, iters=iters, reps=reps, warm=warm),
                 "matmul_device_ms": device_ms(mm, iters=iters, warm=warm),
                 "matmul_host_us": host_us(mm, iters=iters, reps=reps,
                                           warm=warm),
                 "tiled_ms": {}, "tiled_device_ms": {}, "tiled_host_us": {}}
        for tile_b in TILE_BS:
            tr = tile_b * B
            tm = lambda: tiled(x, w, tr)               # noqa: E731
            r["tiled_ms"][tr] = cuda_ms(tm, iters=iters, reps=reps, warm=warm)
            r["tiled_device_ms"][tr] = device_ms(tm, iters=iters, warm=warm)
            r["tiled_host_us"][tr] = host_us(tm, iters=iters, reps=reps,
                                             warm=warm)
        res[name] = r
    res["calls"] = calls
    return res


def host_parts(device, tile_rows=24, rows=96, tiles_in_turn=10):
    """Where the host's time a ``tiled_mm`` call goes, in us, on a product
    small enough (att_lstm's K and N, ``rows`` rows) that the host bounds
    it: the whole wrapper; its C entry alone (the launch, its tensor maps
    cached); the C entry given ``tiles_in_turn`` x operands in turn, more
    than its cache of maps holds, so that it encodes x's map each call;
    the plan uncached and cached; ``torch.empty`` of the output."""
    from insenticap_model_tpu_torch.ops import _build
    from insenticap_model_tpu_torch.ops import tiled_mm as tmm
    _, K, N = LSTM_SHAPES[0]
    xs = [make_inputs(K, N, device, seed)[0][:rows]
          for seed in range(tiles_in_turn)]
    w = make_inputs(K, N, device)[1]
    out = torch.empty(rows, N, device=device, dtype=torch.bfloat16)
    p = tmm.plan(rows, tile_rows, K, N)
    lib, stream = tmm._lib(), _build.stream_ptr(device)

    def entry(x):
        _build.check(lib.isc_tiled_mm_bf16(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, tile_rows, K,
            N, int(p.resident), int(p.wide), p.stages, p.groups, stream),
            "tiled_mm")
    turn = iter(range(10**9))
    return {
        "wrapper_us": host_us(lambda: tmm.tiled_mm(xs[0], w,
                                                   tile_rows=tile_rows)),
        "c_entry_us": host_us(lambda: entry(xs[0])),
        "c_entry_encoding_x_us": host_us(
            lambda: entry(xs[next(turn) % tiles_in_turn])),
        "plan_uncached_us": host_us(
            lambda: tmm.plan.__wrapped__(rows, tile_rows, K, N)),
        "plan_cached_us": host_us(lambda: tmm.plan(rows, tile_rows, K, N)),
        "empty_us": host_us(lambda: torch.empty(
            rows, N, device=device, dtype=torch.bfloat16))}


def ptxas_lines(log):
    """each tiled_mm_kernel instance's registers and spills, one line each"""
    out, entry, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "tiled_mm_kernel" in line else ""
        elif "spill" in line and entry:
            spill = line.strip()
        elif "registers" in line and entry:
            out.append(f"{entry}: {line.split(':')[-1].strip()}; {spill}")
            entry = ""
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.realpath(args.root)
    if os.path.commonpath([root, os.path.realpath(HERE)]) != \
            os.path.realpath(HERE):
        ap.error(f"--root {args.root} lies outside this checkout")
    if not torch.cuda.is_available():
        sys.exit("bench_torch_megacell: needs a CUDA card")
    sys.path.insert(0, root)
    from insenticap_model_tpu_torch.ops import _build
    from insenticap_model_tpu_torch.ops import tiled_mm as tmm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    print(f"package: {os.path.dirname(tmm.__file__)}")
    print(f"serving config: bs={BS} beam={B} rows={ROWS}")
    tmm._lib()
    for line in ptxas_lines(_build.build_logs.get("tiled_mm", "")):
        print(f"  ptxas: {line}")
    plans = {}
    if hasattr(tmm, "plan"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for name, K, N in LSTM_SHAPES:
            plans[name] = {tb * B: tmm.plan(ROWS, tb * B, K, N, sms)._asdict()
                           for tb in TILE_BS}
            print(f"plan {name}: " + "; ".join(
                f"tile_rows={tr} n={p['n']} "
                f"{'resident' if p['resident'] else 'streamed'} "
                f"{p['panels']} panels a stage of {p['stage_rows']} rows "
                f"stages={p['stages']} groups={p['groups']} smem={p['smem']}"
                for tr, p in plans[name].items()))
    res = measure(torch.device("cuda"))
    if hasattr(tmm, "plan"):
        res["host_parts"] = host_parts(torch.device("cuda"))
        print("host us a call at [96x1536]@[1536x2048], tile 24: " + ", ".join(
            f"{k[:-3]} {v:.2f}" for k, v in res["host_parts"].items()))
    for name, _, _ in LSTM_SHAPES:
        r = res[name]
        rows, K, N = r["shape"]
        dev_mm = r["matmul_device_ms"]
        line = [f"{name}: torch.matmul [{rows}x{K}]@[{K}x{N}] device "
                f"{dev_mm:.4f} ms, events {r['matmul_ms']:.4f} ms, host "
                f"{r['matmul_host_us']:.1f} us a call (bound "
                f"{r['bound_ms']:.4f} ms, {r['bound_by']})"]
        for tr, t in r["tiled_device_ms"].items():
            line.append(f"tiled_mm tile_rows={tr}: device {t:.4f} ms "
                        f"({t / dev_mm:.2f}x), events "
                        f"{r['tiled_ms'][tr]:.4f} ms, host "
                        f"{r['tiled_host_us'][tr]:.1f} us a call")
        print("\n  ".join(line), flush=True)
    rec = json.dumps({"device": smi, "root": root, "results": res,
                      "plans": plans, "budget": budget()})
    print(rec, flush=True)
    for b in budget():
        print(f"tile_b={b['tile_b']} ({b['tile_rows']} rows): att+p_att "
              f"{b['att_p_att_bytes'] / 1e3:.1f} KB against "
              f"{SMEM_BYTES / 1e3:.1f} KB of shared memory a block "
              f"({'fits' if b['fits_shared_memory'] else 'does not fit'}); "
              f"LSTM weights {b['lstm_weight_bytes'] / 1e6:.2f} MB against "
              f"the {L2_BYTES / 1e6:.0f} MB L2 "
              f"({'fit' if b['weights_fit_l2'] else 'do not fit'})")


if __name__ == "__main__":
    main()

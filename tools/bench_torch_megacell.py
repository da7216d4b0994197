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

    python3 tools/bench_torch_megacell.py

Each product is timed two ways: CUDA events around 64 back-to-back
launches after a warm-up, the median of 10 such runs, which below some
50 us a call also reads the host's dispatch of each launch; and the
device time of 64 calls that ``torch.profiler`` records, the kernels
alone. The JAX tool chains its steps
through a ``lax.scan`` that folds each output back into the input; that
only keeps XLA from eliding steps, which eager PyTorch does not do, so the
launches here are independent. It needs a CUDA card and exits non-zero
without one.
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from insenticap_model_tpu_torch import nn  # noqa: E402
from insenticap_model_tpu_torch.ops.tiled_mm import tiled_mm  # noqa: E402
from insenticap_model_tpu_torch.utils.timing import (  # noqa: E402
    cuda_ms, device_ms)

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


def measure(device, iters=64, reps=10, warm=3):
    """Both LSTM products: torch.matmul at M = 1152 and ``tiled_mm`` at
    each tile size, in CUDA-event ms (``cuda_ms``) and device ms
    (``device_ms``). Returns {name: {"shape", "matmul_ms",
    "matmul_device_ms", "tiled_ms": {tile_rows: ms}, "tiled_device_ms":
    {tile_rows: ms}, "bound_ms", "bound_by"}} and, under "calls", the
    number of ``tiled_mm`` calls made."""
    res = {}
    calls = 0
    for seed, (name, K, N) in enumerate(LSTM_SHAPES):
        x, w = make_inputs(K, N, device, seed)
        bnd, by = bound_ms(K, N)
        with nn.exact_numerics():          # f32 accumulation, as the kernel
            mm = lambda: torch.matmul(x, w)            # noqa: E731
            r = {"shape": [ROWS, K, N], "bound_ms": bnd, "bound_by": by,
                 "matmul_ms": cuda_ms(mm, iters=iters, reps=reps, warm=warm),
                 "matmul_device_ms": device_ms(mm, iters=iters, warm=warm),
                 "tiled_ms": {}, "tiled_device_ms": {}}
        for tile_b in TILE_BS:
            tr = tile_b * B
            tm = lambda: tiled_mm(x, w, tile_rows=tr)  # noqa: E731
            r["tiled_ms"][tr] = cuda_ms(tm, iters=iters, reps=reps, warm=warm)
            r["tiled_device_ms"][tr] = device_ms(tm, iters=iters, warm=warm)
            calls += 2 * warm + iters * (reps + 1)
        res[name] = r
    res["calls"] = calls
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_megacell: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    print(f"serving config: bs={BS} beam={B} rows={ROWS}")
    res = measure(torch.device("cuda"))
    for name, _, _ in LSTM_SHAPES:
        r = res[name]
        rows, K, N = r["shape"]
        dev_mm = r["matmul_device_ms"]
        line = [f"{name}: torch.matmul [{rows}x{K}]@[{K}x{N}] device "
                f"{dev_mm:.4f} ms, events {r['matmul_ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f} ms, {r['bound_by']})"]
        for tr, t in r["tiled_device_ms"].items():
            line.append(f"tiled_mm tile_rows={tr}: device {t:.4f} ms "
                        f"({t / dev_mm:.2f}x), events "
                        f"{r['tiled_ms'][tr]:.4f} ms")
        print("\n  ".join(line), flush=True)
    for b in budget():
        print(f"tile_b={b['tile_b']} ({b['tile_rows']} rows): att+p_att "
              f"{b['att_p_att_bytes'] / 1e3:.1f} KB against "
              f"{SMEM_BYTES / 1e3:.1f} KB of shared memory a block "
              f"({'fits' if b['fits_shared_memory'] else 'does not fit'}); "
              f"LSTM weights {b['lstm_weight_bytes'] / 1e6:.2f} MB against "
              f"the {L2_BYTES / 1e6:.0f} MB L2 "
              f"({'fit' if b['weights_fit_l2'] else 'do not fit'})")
    print(json.dumps({"device": smi, "results": res, "budget": budget()}))


if __name__ == "__main__":
    main()

// Fused classifier product + log-softmax + bans + exact top-k on Hopper.
//
// Replaces the Pallas kernel insenticap_model_tpu/ops/fused_topk.py
// `_kernel` with `_merge_topk`. For every candidate row r of the beam:
//
//   logits[r, v] = h[r] . W[v] + b[v]                (f32 accumulation)
//   lse[r]       = log sum_v exp(logits[r, v])       (all V words)
//   out[r]       = top-k of logits[r, v] - lse[r] over the words that are
//                  neither a static ban nor last[r]; descending, the lower
//                  index first on a tie; slots with no candidate hold
//                  (-1e30, 0)
//
// W is [V, H] row-major (the port's Linear layout), so a vocab row is H
// contiguous values.
//
// What bounds it on the H100 at serving width (rows 1152, H 512, V 10,000):
// operations, 11.8 GFLOP (11.9 us at the bf16 tensor rate) against 11.5 MB
// moved (3.4 us). The design: pass 1 runs one block per (64-row block,
// 128-word vocab tile). It stages the h and W tiles through shared memory
// in 32-wide K steps and computes the 64 x 128 logits tile with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate: bf16 products are exact in
// f32, so this is the same function) or, for f32 operands, with FFMA (TF32
// would change the function). The tile lands in shared memory (aliasing
// the staging buffers); one warp per row then reduces the row's tile max,
// exp-sum and top-k (k rounds of a warp arg-max over (value desc, index
// asc), each round taking the best candidate after the previous winner)
// and writes those partials to scratch. Pass 2 is one warp per row: it
// merges the row's partials (max, rescaled sum, top-k) and writes
// value - lse. The [rows, V] logits never reach device memory. Not yet
// done: 16-byte staging loads, cp.async/TMA pipelining, wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // rows of h per block
constexpr int kCols = 128;      // vocab words per block
constexpr int kK = 32;          // K step of the staged tiles
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kMaxBanned = 8;
constexpr float kBanned = -1e30f;  // the beam's finite "banned" sentinel

struct Bans {
  int n;
  int id[kMaxBanned];
};

// shared memory: the staging buffers of either path, then the logits tile
constexpr int kStageF32 = kK * (kRows + 1) + kK * (kCols + 1);   // floats
constexpr int kStageBf16 = (kRows + kCols) * (kK + 8) / 2;       // floats
constexpr int kLogits = kRows * (kCols + 1);                     // floats
constexpr int kSmemFloats =
    kLogits > kStageF32 ? (kLogits > kStageBf16 ? kLogits : kStageBf16)
                        : (kStageF32 > kStageBf16 ? kStageF32 : kStageBf16);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (value desc, index asc): is (va, ia) ranked before (vb, ib)?
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 operands: FFMA, 4 x 8 outputs a thread (rows ty + 16 i, columns
// tx + 16 j), tiles staged k-major so a warp's reads are broadcast or
// consecutive.
__device__ __forceinline__ void logits_tile(
    const float* __restrict__ h, const float* __restrict__ w, float* smem,
    int row0, int v0, int rows, int H, int V, float acc[4][8]) {
  float* hs = smem;                         // [kK][kRows + 1]
  float* ws = smem + kK * (kRows + 1);      // [kK][kCols + 1]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kK) {
    for (int e = tid; e < kRows * kK; e += kThreads) {
      const int r = e / kK, kk = e % kK;
      const int gr = row0 + r, gk = k0 + kk;
      hs[kk * (kRows + 1) + r] =
          (gr < rows && gk < H) ? h[(size_t)gr * H + gk] : 0.f;
    }
    for (int e = tid; e < kCols * kK; e += kThreads) {
      const int c = e / kK, kk = e % kK;
      const int gv = v0 + c, gk = k0 + kk;
      ws[kk * (kCols + 1) + c] =
          (gv < V && gk < H) ? w[(size_t)gv * H + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[kk * (kRows + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk * (kCols + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_tile(const float acc[4][8],
                                           float* ls) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ls[(ty + 16 * i) * (kCols + 1) + tx + 16 * j] = acc[i][j];
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 operands: tensor cores. Warp (wm, wn) of a 2 x 4 grid owns rows
// wm*32 .. +32 (two m16 tiles) and columns wn*32 .. +32 (four n8 tiles).
// Both tiles stay K-contiguous in shared memory ([row][k], 8 bf16 of
// padding), which is the layout the A (row) and B (col) fragments read.
__device__ __forceinline__ void logits_tile(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    float* smem, int row0, int v0, int rows, int H, int V, float acc[4][8]) {
  constexpr int kS = kK + 8;                // staged row stride (bf16)
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + kRows * kS;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  // acc[mi * 2 + ni / 2][(ni % 2) * 4 + e] holds fragment e of tile (mi, ni)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kK) {
    for (int e = tid; e < kRows * kK; e += kThreads) {
      const int r = e / kK, kk = e % kK;
      const int gr = row0 + r, gk = k0 + kk;
      as[r * kS + kk] =
          (gr < rows && gk < H) ? h[(size_t)gr * H + gk] : zero;
    }
    for (int e = tid; e < kCols * kK; e += kThreads) {
      const int c = e / kK, kk = e % kK;
      const int gv = v0 + c, gk = k0 + kk;
      bs[c * kS + kk] = (gv < V && gk < H) ? w[(size_t)gv * H + gk] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p =
            as + (wm * 32 + mi * 16 + g) * kS + ks + 2 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p =
            bs + (wn * 32 + ni * 8 + g) * kS + ks + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_bf16(&acc[mi * 2 + ni / 2][(ni % 2) * 4], a[mi][0], a[mi][1],
                   a[mi][2], a[mi][3], b0, b1);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_tile_mma(const float acc[4][8],
                                               float* ls) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* c = &acc[mi * 2 + ni / 2][(ni % 2) * 4];
      const int r = wm * 32 + mi * 16 + g, col = wn * 32 + ni * 8 + 2 * t;
      ls[r * (kCols + 1) + col] = c[0];
      ls[r * (kCols + 1) + col + 1] = c[1];
      ls[(r + 8) * (kCols + 1) + col] = c[2];
      ls[(r + 8) * (kCols + 1) + col + 1] = c[3];
    }
}

// Pass 1: a (row block, vocab tile) -> per-row partials
//   part_m[tile][row], part_s[tile][row], part_v/part_i[tile][row][k]
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_tiles(const T* __restrict__ h, const T* __restrict__ w,
           const T* __restrict__ b, const long long* __restrict__ last,
           Bans bans, int rows, int H, int V, int k,
           float* __restrict__ part_f, int* __restrict__ part_i) {
  __shared__ __align__(16) float smem[kSmemFloats];
  const int v0 = blockIdx.x * kCols, row0 = blockIdx.y * kRows;
  const int tiles = gridDim.x;
  float acc[4][8];
  logits_tile(h, w, smem, row0, v0, rows, H, V, acc);
  // the staging buffers are free (logits_tile ends on a barrier)
  float* ls = smem;
  if constexpr (sizeof(T) == 2) {
    store_tile_mma(acc, ls);
  } else {
    store_tile(acc, ls);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* part_m = part_f;
  float* part_s = part_f + (size_t)tiles * rows;
  float* part_v = part_f + (size_t)2 * tiles * rows;
  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int gr = row0 + rr;
    if (gr >= rows) break;
    const long long ban_last = last ? last[gr] : -1;
    float x[kCols / 32];
    int col[kCols / 32];
    bool ok[kCols / 32], cand[kCols / 32];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols / 32; ++j) {
      col[j] = v0 + lane + 32 * j;
      ok[j] = col[j] < V;
      x[j] = ok[j] ? ls[rr * (kCols + 1) + lane + 32 * j] + to_f32(b[col[j]])
                   : -INFINITY;
      m = fmaxf(m, x[j]);
      bool banned = col[j] == ban_last;
      for (int q = 0; q < bans.n; ++q) banned |= col[j] == bans.id[q];
      cand[j] = ok[j] && !banned;
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kCols / 32; ++j)
      if (ok[j]) s += expf(x[j] - m);
    s = warp_sum(s);
    const size_t p = (size_t)blockIdx.x * rows + gr;
    if (lane == 0) {
      part_m[p] = m;
      part_s[p] = s;
    }
    float pv = INFINITY;
    int pi = -1;
    for (int q = 0; q < k; ++q) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < kCols / 32; ++j)
        if (cand[j] && before(pv, pi, x[j], col[j]) &&
            before(x[j], col[j], bv, bi)) {
          bv = x[j];
          bi = col[j];
        }
      warp_best(bv, bi);
      if (lane == 0) {
        part_v[p * k + q] = bv;
        part_i[p * k + q] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

// Pass 2: one warp per row merges the row's partials over the vocab tiles
__global__ void __launch_bounds__(kThreads)
topk_merge(const float* __restrict__ part_f, const int* __restrict__ part_i,
           int tiles, int rows, int k, float* __restrict__ out_v,
           long long* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int gr = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gr >= rows) return;
  const float* part_m = part_f;
  const float* part_s = part_f + (size_t)tiles * rows;
  const float* part_v = part_f + (size_t)2 * tiles * rows;
  float m = -INFINITY;
  for (int c = lane; c < tiles; c += 32)
    m = fmaxf(m, part_m[(size_t)c * rows + gr]);
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < tiles; c += 32) {
    const size_t p = (size_t)c * rows + gr;
    s += part_s[p] * expf(part_m[p] - m);
  }
  s = warp_sum(s);
  const float log_s = logf(s);
  float pv = INFINITY;
  int pi = -1;
  for (int q = 0; q < k; ++q) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int e = lane; e < tiles * k; e += 32) {
      const size_t p = ((size_t)(e / k) * rows + gr) * k + e % k;
      const float v = part_v[p];
      const int i = part_i[p];
      if (v != -INFINITY && before(pv, pi, v, i) && before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      const bool none = bv == -INFINITY;
      out_v[(size_t)gr * k + q] = none ? kBanned : (bv - m) - log_s;
      out_i[(size_t)gr * k + q] = none ? 0 : bi;
    }
    pv = bv;
    pi = bi;
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* last,
           const int* banned, int n_banned, int rows, int H, int V, int k,
           void* part_f, void* part_i, void* out_v, void* out_i,
           void* stream) {
  if (rows < 1 || H < 1 || V < 1 || k < 1 || k > kMaxK || n_banned < 0 ||
      n_banned > kMaxBanned)
    return (int)cudaErrorInvalidValue;
  Bans bans;
  bans.n = n_banned;
  for (int q = 0; q < kMaxBanned; ++q)
    bans.id[q] = q < n_banned ? banned[q] : -1;
  const int tiles = (V + kCols - 1) / kCols;
  const dim3 grid(tiles, (rows + kRows - 1) / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  topk_tiles<T><<<grid, kThreads, 0, st>>>(
      (const T*)h, (const T*)w, (const T*)b, (const long long*)last, bans,
      rows, H, V, k, (float*)part_f, (int*)part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const float*)part_f, (const int*)part_i, tiles, rows, k,
      (float*)out_v, (long long*)out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_topk_f32(const void* h, const void* w, const void* b,
                 const void* last, const int* banned, int n_banned, int rows,
                 int H, int V, int k, void* part_f, void* part_i, void* out_v,
                 void* out_i, void* stream) {
  return launch<float>(h, w, b, last, banned, n_banned, rows, H, V, k,
                       part_f, part_i, out_v, out_i, stream);
}

int isc_topk_bf16(const void* h, const void* w, const void* b,
                  const void* last, const int* banned, int n_banned,
                  int rows, int H, int V, int k, void* part_f, void* part_i,
                  void* out_v, void* out_i, void* stream) {
  return launch<__nv_bfloat16>(h, w, b, last, banned, n_banned, rows, H, V,
                               k, part_f, part_i, out_v, out_i, stream);
}

}  // extern "C"

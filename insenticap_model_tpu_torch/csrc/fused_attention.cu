// Beam-shared additive content attention (v1 and v2) for beam decode on
// Hopper.
//
// Replaces the Pallas kernels insenticap_model_tpu/ops/fused_attention.py:27
// `_kernel` (v1) and :51 `_kernel_v2` (v2). For every image of the batch and
// each of its B beams:
//
//   q[k]    = h[img*B + k] @ W_h2att^T + b_h2att            (f32 accumulate)
//   e[k, n] = sum_j alpha[j] * tanh(p_att[n, j] + q[k, j])  (alpha's bias
//             dropped: it shifts every logit equally and cancels in softmax)
//   w[k]    = softmax_n(e[k])                                (f32)
//   out[k]  = sum_n w[k, n] * att[n]                         (att's dtype)
//
// v2 is the same function but for one rounding: each softmax weight is
// rounded to att's dtype before the weighted sum (kRoundW; in f32 nothing
// changes, so isc_beam_att_v2_f32 runs v1's instance).
//
// What bounds it on the H100, at serving width (bs=384, N=196, Ah=Fe=512,
// B=3, bf16): att + p_att are 384*196*1024*2 B = 154 MB, read once for all
// B beams: 46.9 us at 3.35 TB/s. Beside the bytes there are 115.6 M tanh:
// with tanhf (about two special-function (MUFU) operations each) some
// 55-60 us, with tanh.approx.f32 (one MUFU op, 16 a clock an SM) about
// 30 us. The products are small beside that: the query product is
// [1152,512]x[512,512], the weighted sum 115.6 M FMAs.
//
// The design is two launches on one stream:
//  1. query_*_kernel computes Q = h @ W^T + b for all bs*B rows into an f32
//     scratch [bs*B, Ah] (allocated by the wrapper): for bf16 64 x 64 block
//     tiles on the tensor cores (mma.sync m16n8k16, f32 accumulate; h and W
//     staged through shared memory by 16-byte cp.async, 4 stages of K 32),
//     for f32 32 x 64 tiles on FFMA (no TF32: it would change the
//     function). W crosses L2 once a 64-row block (18 times at bs=384), not
//     once an image (384 times). At bs=384 it takes some 10 us for 0.6
//     GFLOP, about as long at a third of the rows: likely the memory
//     latency of 16 K stages, three in flight (the attention's 154 MB
//     stream passes through L2 between calls, so W is likely not there).
//  2. beam_att_kernel<T, B, kFast, kRoundW>, one 256-thread block an image,
//     one instance per beam size 1..8 so that the per-beam sums stay in
//     registers. The image's p_att rows, then its att rows, stream through
//     a 3-stage cp.async ring of 16-byte copies, 16 positions a stage for
//     bf16 (8 for f32), 16 KB a stage at 512 wide; the first att stages are
//     started before the softmax runs. Logits: a lane owns 8 channels (one
//     16-byte segment for bf16, two for f32) for the whole image, with their
//     B query values and alpha in registers; a warp takes one position at
//     a time and reduces the B partial logits with shuffles (a position
//     spans ceil(Ah/256) warps, their partials summed in the softmax).
//     Softmax: one warp per beam, f32. Weighted sum: a thread owns 8
//     features and a slice of the positions, with B x 8 f32 accumulators;
//     the slices are summed through shared memory (the ring's space) at the
//     end and the output is written with 16-byte stores.
//  tanh: the f32 instance keeps tanhf; the bf16 instance takes
//  tanh.approx.f32 (isc_beam_att_bf16) or tanhf (isc_beam_att_bf16_tanhf,
//  kept to measure the approximation's error); v2 in bf16
//  (isc_beam_att_v2_bf16) takes tanh.approx.f32 as v1 does.
//
// What this does about the first version's four faults: (1) every block
// recomputed the query product, reading all of W (512 KB) with 2-byte loads,
// 201 MB of L2 reads a call: now one tiled product; (2) the logits pass read
// p_att 2 bytes a lane with nothing else in flight: now 16-byte copies, two
// stages ahead; (3) the weighted sum walked the positions serially, one
// 2-byte load a step: now 16-byte reads from shared memory, 8 features x B
// beams of FMAs each, 4 position slices in parallel; (4) the dynamic
// shared-memory limit was set on every launch: now once an instance.
//
// Widths: Ah and Fe % 8 (bf16) or % 4 (f32), both at most 2048; H % 16
// (bf16) or % 4 (f32); 16-byte aligned operands; any N and bs. The wrapper
// (ops/fused_attention.py) checks them and raises otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxBeam = 8;      // softmax runs one warp per beam
constexpr int kThreads = 256;    // attention kernel
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;       // cp.async ring
constexpr int kLaneCh = 8;       // channels (features) a lane owns
constexpr int kMaxWidth = kThreads * kLaneCh;   // Ah, Fe <= 2048

// query kernels: bf16 64 rows x 64 outputs a block (8 warps, 2 x 4, of
// 32 x 16), K 32 a stage, 4 stages; f32 32 rows x 64 outputs (256 threads
// of 2 x 4), K 32 a stage, the next stage's loads held in registers
constexpr int kQM16 = 64;
constexpr int kQN16 = 64;
constexpr int kQK16 = 32;
constexpr int kQStride16 = kQK16 + 8;  // bf16 elements a staged row
constexpr int kQStages16 = 4;
constexpr int kQThreads16 = 256;
constexpr int kQWarpsN16 = 4;          // warps along the outputs
constexpr int kQMI = kQM16 / (kQThreads16 / 32 / kQWarpsN16) / 16;
constexpr int kQNI = kQN16 / kQWarpsN16 / 8;
constexpr int kQM32 = 32;                // f32
constexpr int kQN32 = 64;
constexpr int kQK32 = 32;
constexpr int kQThreads32 = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kFast>
__device__ __forceinline__ float tanh_(float x) {
  if constexpr (kFast) {
    float y;
    asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return tanhf(x);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of a row as f32, and back: 8 bf16 or 4 f32 (kVec elements)
template <typename T> struct Seg;
template <> struct Seg<bf16> {
  static constexpr int kVec = 8;
  static constexpr int kChunk = 16;   // positions a ring stage
  __device__ __forceinline__ static void load(const bf16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(v[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float* in) {
    uint4 u;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <> struct Seg<float> {
  static constexpr int kVec = 4;
  static constexpr int kChunk = 8;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

// A lane's 8 channels of a row of width W: kLaneCh / kVec segments of 16
// bytes, at segment indices u + s * units(W), so that neighbouring lanes
// read neighbouring 16 bytes (no bank conflicts) for f32 as for bf16
template <typename T>
__host__ __device__ __forceinline__ int units(int W) {
  constexpr int kSeg = kLaneCh / Seg<T>::kVec;
  return (W / Seg<T>::kVec + kSeg - 1) / kSeg;
}

// Shared memory of the attention kernel: the ring (reused for the slices'
// partial sums at the end), then the per-warp-group partial logits
// [G][B][N] and the softmax weights [B][N], all f32
struct Layout {
  size_t stage, region0, part, total;
  int G, Q;
};

template <typename T>
__host__ __device__ __forceinline__ Layout layout(int B, int Ah, int N,
                                                  int Fe) {
  Layout l;
  const int Ua = units<T>(Ah), Uf = units<T>(Fe);
  l.G = (Ua + 31) / 32;       // warps a position spans
  l.Q = kThreads / Uf;        // position slices of the weighted sum
  const int wmax = Ah > Fe ? Ah : Fe;
  l.stage = (size_t)Seg<T>::kChunk * wmax * sizeof(T);
  const size_t ring = kStages * l.stage;
  const size_t red = sizeof(float) * (size_t)(l.Q - 1) * B * kLaneCh * Uf;
  l.region0 = ((ring > red ? ring : red) + 15) / 16 * 16;
  l.part = (size_t)l.G * B * N;
  l.total = l.region0 + sizeof(float) * (l.part + (size_t)B * N);
  return l;
}

// -- 1. the query product -------------------------------------------------

// A fragment of m16n8k16 from a row-major [16][stride] bf16 tile
__device__ __forceinline__ void load_a(const bf16* a, int stride, int k0,
                                       int g, int t, uint32_t out[4]) {
  const bf16* p = a + g * stride + k0 + 2 * t;
  out[0] = *reinterpret_cast<const uint32_t*>(p);
  out[1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
  out[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  out[3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 8);
}

// q[r][j] = bias[j] + sum_i h[r][i] W[j][i]; W [Ah, H] row-major is the
// col-major B operand as it lies. Needs H % 16 == 0.
__global__ void __launch_bounds__(kQThreads16)
query_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, float* __restrict__ q, int R,
                  int H, int Ah) {
  __shared__ __align__(16) bf16 hs[kQStages16][kQM16 * kQStride16];
  __shared__ __align__(16) bf16 ws[kQStages16][kQN16 * kQStride16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kQWarpsN16, wn = warp % kQWarpsN16;
  const int r0 = blockIdx.x * kQM16, c0 = blockIdx.y * kQN16;
  const int nk = (H + kQK16 - 1) / kQK16;
  constexpr int kSegs = kQK16 / 8;   // 16-byte segments a staged row
  static_assert(kQM16 == kQN16 && kQM16 * kSegs % kQThreads16 == 0,
                "whole 16-byte copies a thread and operand a stage");

  auto stage = [&](int kt) {
    if (kt < nk) {
      const int buf = kt % kQStages16;
#pragma unroll
      for (int x = tid; x < kQM16 * kSegs; x += kQThreads16) {
        const int sr = x / kSegs, ss = x % kSegs;
        const int gk = kt * kQK16 + ss * 8;
        const int row = r0 + sr, col = c0 + sr;
        const bool okh = row < R && gk < H, okw = col < Ah && gk < H;
        cp_async16(&hs[buf][sr * kQStride16 + ss * 8],
                   okh ? h + (size_t)row * H + gk : h, okh ? 16 : 0);
        cp_async16(&ws[buf][sr * kQStride16 + ss * 8],
                   okw ? w + (size_t)col * H + gk : w, okw ? 16 : 0);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

  float acc[kQMI][kQNI][4];
#pragma unroll
  for (int mi = 0; mi < kQMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kQNI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

#pragma unroll
  for (int kt = 0; kt < kQStages16 - 1; ++kt) stage(kt);
  for (int kt = 0; kt < nk; ++kt) {
    stage(kt + kQStages16 - 1);
    cp_async_wait<kQStages16 - 1>();
    __syncthreads();
    const bf16* hb = hs[kt % kQStages16];
    const bf16* wb = ws[kt % kQStages16];
#pragma unroll
    for (int kk = 0; kk < kQK16; kk += 16) {
      uint32_t a[kQMI][4];
#pragma unroll
      for (int mi = 0; mi < kQMI; ++mi)
        load_a(hb + (wm * kQMI + mi) * 16 * kQStride16, kQStride16, kk, g, t,
               a[mi]);
#pragma unroll
      for (int ni = 0; ni < kQNI; ++ni) {
        const bf16* bp =
            wb + ((wn * kQNI + ni) * 8 + g) * kQStride16 + kk + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int mi = 0; mi < kQMI; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();   // the stage is free for the copy started next
  }

#pragma unroll
  for (int ni = 0; ni < kQNI; ++ni) {
    const int col = c0 + (wn * kQNI + ni) * 8 + 2 * t;   // Ah even: col + 1
    if (col >= Ah) continue;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mi = 0; mi < kQMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + (wm * kQMI + mi) * 16 + g + half * 8;
        if (row < R)
          *reinterpret_cast<float2*>(q + (size_t)row * Ah + col) =
              make_float2(acc[mi][ni][2 * half] + b0,
                          acc[mi][ni][2 * half + 1] + b1);
      }
  }
}

// The same in f32 on FFMA: h and W tiles staged k-major through shared
// memory (16-byte loads, the next stage's held in registers while this
// one is multiplied); a thread owns 2 x 4 outputs. Needs H % 4 == 0.
__global__ void __launch_bounds__(kQThreads32)
query_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ q, int R,
                 int H, int Ah) {
  __shared__ __align__(16) float hs[kQK32][kQM32 + 4];
  __shared__ __align__(16) float ws[kQK32][kQN32 + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = blockIdx.x * kQM32, c0 = blockIdx.y * kQN32;
  // the 16 bytes it stages: h row lr (all threads: 32 rows x 8), W rows
  // lr and lr + 32 (64 rows x 8)
  constexpr int kSegs = kQK32 / 4;
  static_assert(kQM32 * kSegs == kQThreads32 && kQN32 == 2 * kQM32,
                "one h and two W copies a thread a stage");
  const int lr = tid / kSegs, lk = (tid % kSegs) * 4;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hv = z, wv[2] = {z, z};
  auto fetch = [&](int k0) {
    const int gk = k0 + lk;
    hv = (r0 + lr < R && gk < H)
        ? *reinterpret_cast<const float4*>(h + (size_t)(r0 + lr) * H + gk)
        : z;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = c0 + lr + i * kQM32;
      wv[i] = (col < Ah && gk < H)
          ? *reinterpret_cast<const float4*>(w + (size_t)col * H + gk)
          : z;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < H; k0 += kQK32) {
    hs[lk][lr] = hv.x;
    hs[lk + 1][lr] = hv.y;
    hs[lk + 2][lr] = hv.z;
    hs[lk + 3][lr] = hv.w;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ws[lk][lr + i * kQM32] = wv[i].x;
      ws[lk + 1][lr + i * kQM32] = wv[i].y;
      ws[lk + 2][lr + i * kQM32] = wv[i].z;
      ws[lk + 3][lr + i * kQM32] = wv[i].w;
    }
    __syncthreads();
    if (k0 + kQK32 < H) fetch(k0 + kQK32);
#pragma unroll
    for (int kk = 0; kk < kQK32; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(&hs[kk][ty * 2]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[2] = {a.x, a.y};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ty * 2 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col < Ah) q[(size_t)row * Ah + col] = acc[i][j] + bias[col];
    }
  }
}

// -- 2. the attention over one image --------------------------------------

// v2's rounding: a softmax weight rounded to att's dtype (nothing in f32)
template <typename T, bool kRoundW>
__device__ __forceinline__ float round_w(float x) {
  if constexpr (kRoundW && sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

template <typename T, int B, bool kFast, bool kRoundW>
__global__ void __launch_bounds__(kThreads, B <= 4 ? 3 : 2)
beam_att_kernel(const float* __restrict__ q, const T* __restrict__ alpha,
                const T* __restrict__ p_att, const T* __restrict__ att,
                T* __restrict__ out, int Ah, int N, int Fe) {
  constexpr int V = Seg<T>::kVec;
  constexpr int kSeg = kLaneCh / V;
  constexpr int CH = Seg<T>::kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(B, Ah, N, Fe);
  float* part = reinterpret_cast<float*>(smem + L.region0);   // [G][B][N]
  float* wts = part + L.part;                                  // [B][N]

  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Sa = Ah / V, Ua = units<T>(Ah);
  const int Sf = Fe / V, Uf = units<T>(Fe);
  const int G = L.G, P = kWarps / G, Q = L.Q;
  const int nC = (N + CH - 1) / CH;
  const T* pa = p_att + (size_t)img * N * Ah;
  const T* at = att + (size_t)img * N * Fe;

  // tile i < nC: p_att positions [i*CH, ..); then att's, the same chunks
  auto copy_tile = [&](int i) {
    if (i < 2 * nC) {
      const bool is_p = i < nC;
      const int c = is_p ? i : i - nC, W = is_p ? Ah : Fe;
      const int rows = min(CH, N - c * CH);
      const T* src = (is_p ? pa : at) + (size_t)c * CH * W;
      unsigned char* dst = smem + (i % kStages) * L.stage;
      const int pieces = rows * W / V;
      for (int x = tid; x < pieces; x += kThreads)
        cp_async16(dst + 16 * x, src + (size_t)x * V);
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };
  auto arrive = [&](int i) {   // tile i landed for every thread
    copy_tile(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) copy_tile(i);

  // logits: warp = (group grp of 32 lanes along the channels, position
  // lane pl); lane's 8 channels: unit u, with its B queries and alpha
  const int grp = warp % G, pl = warp / G;
  const int u = grp * 32 + lane;
  float qr[B][kLaneCh], ar[kLaneCh];
#pragma unroll
  for (int s = 0; s < kSeg; ++s) {
    const int seg = u + s * Ua;
    const bool ok = u < Ua && seg < Sa;
    float a[V];
    if (ok) {
      Seg<T>::load(alpha + seg * V, a);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) a[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) ar[s * V + i] = a[i];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (ok) {
        Seg<float>::load(q + ((size_t)img * B + k) * Ah + seg * V,
                         &qr[k][s * V]);
        if constexpr (V == 8)
          Seg<float>::load(q + ((size_t)img * B + k) * Ah + seg * V + 4,
                           &qr[k][s * V + 4]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) qr[k][s * V + i] = 0.f;
      }
    }
  }

  for (int i = 0; i < nC; ++i) {
    arrive(i);
    const T* st = reinterpret_cast<const T*>(smem + (i % kStages) * L.stage);
    const int rows = min(CH, N - i * CH);
    if (pl < P) {
      for (int r = pl; r < rows; r += P) {
        const T* row = st + (size_t)r * Ah;
        float acc[B];
#pragma unroll
        for (int k = 0; k < B; ++k) acc[k] = 0.f;
#pragma unroll
        for (int s = 0; s < kSeg; ++s) {
          const int seg = u + s * Ua;
          if (u < Ua && seg < Sa) {
            float p[V];
            Seg<T>::load(row + seg * V, p);
#pragma unroll
            for (int j = 0; j < V; ++j)
#pragma unroll
              for (int k = 0; k < B; ++k)
                acc[k] = fmaf(ar[s * V + j],
                              tanh_<kFast>(p[j] + qr[k][s * V + j]), acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const float e = warp_sum(acc[k]);
          if (lane == 0) part[((size_t)grp * B + k) * N + i * CH + r] = e;
        }
      }
    }
    __syncthreads();   // the stage is free for the copy started next
  }

  // softmax over n, one warp per beam; the att copies are in flight
  if (warp < B) {
    float* e = wts + (size_t)warp * N;
    float m = -INFINITY;
    for (int n = lane; n < N; n += 32) {
      float x = 0.f;
      for (int g = 0; g < G; ++g) x += part[((size_t)g * B + warp) * N + n];
      e[n] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float x = expf(e[n] - m);
      e[n] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    for (int n = lane; n < N; n += 32)
      e[n] = round_w<T, kRoundW>(e[n] / sum);
  }
  __syncthreads();

  // weighted sum: thread = (feature unit fb, position slice sl)
  const int fb = tid % Uf, sl = tid / Uf;
  float acc[B][kLaneCh];
#pragma unroll
  for (int k = 0; k < B; ++k)
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) acc[k][j] = 0.f;
  for (int i = nC; i < 2 * nC; ++i) {
    arrive(i);
    const int c = i - nC;
    const T* st = reinterpret_cast<const T*>(smem + (i % kStages) * L.stage);
    const int rows = min(CH, N - c * CH);
    if (sl < Q) {
      for (int r = sl; r < rows; r += Q) {
        const T* row = st + (size_t)r * Fe;
        float wk[B];
#pragma unroll
        for (int k = 0; k < B; ++k) wk[k] = wts[(size_t)k * N + c * CH + r];
#pragma unroll
        for (int s = 0; s < kSeg; ++s) {
          const int seg = fb + s * Uf;
          if (seg < Sf) {
            float a[V];
            Seg<T>::load(row + seg * V, a);
#pragma unroll
            for (int k = 0; k < B; ++k)
#pragma unroll
              for (int j = 0; j < V; ++j)
                acc[k][s * V + j] = fmaf(wk[k], a[j], acc[k][s * V + j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // the slices' sums through shared memory (the ring's space, now idle),
  // [Q-1][B][8][Uf], then slice 0 adds them in order and stores
  cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(smem);
  if (sl >= 1 && sl < Q) {
#pragma unroll
    for (int k = 0; k < B; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j)
        red[(((size_t)(sl - 1) * B + k) * kLaneCh + j) * Uf + fb] = acc[k][j];
  }
  __syncthreads();
  if (sl == 0) {
    for (int o = 0; o < Q - 1; ++o) {
#pragma unroll
      for (int k = 0; k < B; ++k)
#pragma unroll
        for (int j = 0; j < kLaneCh; ++j)
          acc[k][j] += red[(((size_t)o * B + k) * kLaneCh + j) * Uf + fb];
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      T* orow = out + ((size_t)img * B + k) * Fe;
#pragma unroll
      for (int s = 0; s < kSeg; ++s) {
        const int seg = fb + s * Uf;
        if (seg < Sf) Seg<T>::store(orow + seg * V, &acc[k][s * V]);
      }
    }
  }
}

// -- launch ----------------------------------------------------------------

// raises the instance's dynamic shared-memory limit to the device's opt-in
// maximum, once; returns that maximum, or minus a CUDA error code
template <typename T, int B, bool kFast, bool kRoundW>
int smem_limit() {
  static const int limit = [] {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(beam_att_kernel<T, B, kFast, kRoundW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    return err == cudaSuccess ? optin : -(int)err;
  }();
  return limit;
}

int launch_query(const float* h, const float* w, const float* b, float* q,
                 int R, int H, int Ah, cudaStream_t stream) {
  const dim3 grid((R + kQM32 - 1) / kQM32, (Ah + kQN32 - 1) / kQN32);
  query_f32_kernel<<<grid, kQThreads32, 0, stream>>>(h, w, b, q, R, H, Ah);
  return (int)cudaGetLastError();
}

int launch_query(const bf16* h, const bf16* w, const bf16* b, float* q,
                 int R, int H, int Ah, cudaStream_t stream) {
  const dim3 grid((R + kQM16 - 1) / kQM16, (Ah + kQN16 - 1) / kQN16);
  query_bf16_kernel<<<grid, kQThreads16, 0, stream>>>(h, w, b, q, R, H, Ah);
  return (int)cudaGetLastError();
}

template <typename T, int B, bool kFast, bool kRoundW>
int launch_b(const void* h, const void* w, const void* b, const void* alpha,
             const void* p_att, const void* att, void* out, void* q, int bs,
             int H, int Ah, int N, int Fe, void* stream) {
  const size_t smem = layout<T>(B, Ah, N, Fe).total;
  const int limit = smem_limit<T, B, kFast, kRoundW>();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_query((const T*)h, (const T*)w, (const T*)b,
                               (float*)q, bs * B, H, Ah, s);
  if (err != 0) return err;
  beam_att_kernel<T, B, kFast, kRoundW><<<bs, kThreads, smem, s>>>(
      (const float*)q, (const T*)alpha, (const T*)p_att, (const T*)att,
      (T*)out, Ah, N, Fe);
  return (int)cudaGetLastError();
}

template <typename T, bool kFast, bool kRoundW>
int launch(const void* h, const void* w, const void* b, const void* alpha,
           const void* p_att, const void* att, void* out, void* q, int bs,
           int B, int H, int Ah, int N, int Fe, void* stream) {
  constexpr int V = Seg<T>::kVec;
  constexpr int kHMul = sizeof(T) == 2 ? 16 : 4;   // mma's K, or a float4
  if (bs < 1 || N < 1 || H < 1 || H % kHMul || Ah < V || Ah % V ||
      Fe < V || Fe % V || Ah > kMaxWidth || Fe > kMaxWidth)
    return (int)cudaErrorInvalidValue;
#define ISC_ATT_CASE(BB)                                                    \
  case BB:                                                                  \
    return launch_b<T, BB, kFast, kRoundW>(h, w, b, alpha, p_att, att, out, \
                                           q, bs, H, Ah, N, Fe, stream);
  switch (B) {
    ISC_ATT_CASE(1)
    ISC_ATT_CASE(2)
    ISC_ATT_CASE(3)
    ISC_ATT_CASE(4)
    ISC_ATT_CASE(5)
    ISC_ATT_CASE(6)
    ISC_ATT_CASE(7)
    ISC_ATT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ISC_ATT_CASE
}

static_assert(kMaxBeam <= kWarps, "softmax runs one warp per beam");

}  // namespace

extern "C" {

// q: the f32 scratch [bs*B, Ah] of the query product
int isc_beam_att_f32(const void* h, const void* w, const void* b,
                     const void* alpha, const void* p_att, const void* att,
                     void* out, void* q, int bs, int B, int H, int Ah, int N,
                     int Fe, void* stream) {
  return launch<float, false, false>(h, w, b, alpha, p_att, att, out, q, bs,
                                     B, H, Ah, N, Fe, stream);
}

int isc_beam_att_bf16(const void* h, const void* w, const void* b,
                      const void* alpha, const void* p_att, const void* att,
                      void* out, void* q, int bs, int B, int H, int Ah, int N,
                      int Fe, void* stream) {
  return launch<bf16, true, false>(h, w, b, alpha, p_att, att, out, q, bs, B,
                                   H, Ah, N, Fe, stream);
}

int isc_beam_att_bf16_tanhf(const void* h, const void* w, const void* b,
                            const void* alpha, const void* p_att,
                            const void* att, void* out, void* q, int bs,
                            int B, int H, int Ah, int N, int Fe,
                            void* stream) {
  return launch<bf16, false, false>(h, w, b, alpha, p_att, att, out, q, bs,
                                    B, H, Ah, N, Fe, stream);
}

// v2: v1's function with the softmax weights rounded to att's dtype before
// the weighted sum (in f32 the same function as v1)
int isc_beam_att_v2_f32(const void* h, const void* w, const void* b,
                        const void* alpha, const void* p_att, const void* att,
                        void* out, void* q, int bs, int B, int H, int Ah,
                        int N, int Fe, void* stream) {
  return launch<float, false, false>(h, w, b, alpha, p_att, att, out, q, bs,
                                     B, H, Ah, N, Fe, stream);
}

int isc_beam_att_v2_bf16(const void* h, const void* w, const void* b,
                         const void* alpha, const void* p_att,
                         const void* att, void* out, void* q, int bs, int B,
                         int H, int Ah, int N, int Fe, void* stream) {
  return launch<bf16, true, true>(h, w, b, alpha, p_att, att, out, q, bs, B,
                                  H, Ah, N, Fe, stream);
}

}  // extern "C"

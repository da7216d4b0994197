// Beam-shared additive content attention, v2: the products on the tensor
// cores.
//
// Replaces the Pallas kernel insenticap_model_tpu/ops/fused_attention.py
// `_kernel_v2`. For every image of the batch and each of its B beams:
//
//   q[k]    = h[img*B + k] @ W_h2att^T + b_h2att            (f32 accumulate)
//   e[k, n] = sum_j alpha[j] * tanh(p_att[n, j] + q[k, j])  (alpha's bias
//             dropped: it shifts every logit equally and cancels in softmax)
//   w[k]    = softmax_n(e[k]), then rounded to att's dtype
//   out[k]  = sum_n w[k, n] * att[n]        (f32 accumulate, att's dtype)
//
// It is v1's function (csrc/fused_attention.cu) except for the rounding of
// the softmax weights before the weighted sum, which `_kernel_v2` does
// (fused_attention.py:77-80); in f32 the two are the same function.
//
// What bounds it on the H100: the att/p_att bytes, as for v1 (154 MB a
// step at bs=384, N=196, 512 wide, bf16: 46 us at 3.35 TB/s), with 115.6 M
// tanh beside them. The design, one block per image, 8 warps:
//  1. q: for bf16, mma.sync.m16n8k16 (bf16 in, f32 accumulate; the B
//     beam rows padded to 16 in shared memory, W_h2att's [Ah, H] rows are
//     the col-major B operand as they lie, read from L2); for f32, one warp
//     per output with FFMA, as v1.
//  2. logits: one warp per position n, lanes along the channel axis with
//     16-byte loads, every p_att row read once for all B beams. This
//     [B*N, Ah] x [Ah, 1] reduction would fill 1/8 of an n8 mma tile, so it
//     stays on FFMA with warp reductions.
//  3. softmax: one warp per beam; bf16 weights go to shared memory as the
//     A operand ([16, N] row-major, padded rows and columns zero).
//  4. weighted sum: for bf16, [16, N] x [N, Fe] on mma.sync, att staged
//     through shared memory 32 positions at a time with 16-byte loads (the
//     B fragments are gathered from it in pairs along N); for f32, FFMA
//     with threads along Fe, as v1.
// Needs H % 16 == 0, Ah % 8 == 0, Fe % 8 == 0 and 16-byte aligned rows (the
// wrapper checks). Not yet done: ldmatrix, cp.async/TMA pipelining, more
// than one image per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeam = 8;     // softmax runs one warp per beam
constexpr int kChunk = 32;      // att positions staged at a time
constexpr int kFeat = 512;      // att features staged at a time
constexpr int kFeatTiles = kFeat / 8 / kWarps;   // n8 tiles per warp

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment of m16n8k16 from a row-major [16][stride] bf16 tile
__device__ __forceinline__ void load_a(const bf16* a, int stride, int k0,
                                       int g, int t, uint32_t out[4]) {
  const bf16* p = a + g * stride + k0 + 2 * t;
  out[0] = *reinterpret_cast<const uint32_t*>(p);
  out[1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
  out[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  out[3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 8);
}

// 16 bytes of a row as f32: 8 bf16 or 4 f32
template <typename T> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int n = 8;
  __device__ static void load(const bf16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(v[i]);
  }
};
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
};

// Phase 1, f32: q[k][j] = bias[j] + sum_i h[k][i] W[j][i], one warp per j
__device__ __forceinline__ void queries(const float* h_img,
                                        const float* __restrict__ w,
                                        const float* __restrict__ bias,
                                        float* region, float* qs, int B,
                                        int H, int Ah) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* hs = region;                            // [B][H]
  for (int i = tid; i < B * H; i += kThreads) hs[i] = h_img[i];
  __syncthreads();
  for (int j = warp; j < Ah; j += kWarps) {
    const float* wj = w + (size_t)j * H;
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int i = lane; i < H; i += 32) {
      const float wv = wj[i];
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < B) acc[k] = fmaf(hs[k * H + i], wv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) {
      if (k < B) {
        const float s = warp_sum(acc[k]);
        if (lane == 0) qs[k * Ah + j] = s + bias[j];
      }
    }
  }
}

// Phase 1, bf16: [16, H] x [H, Ah] on the tensor cores; rows >= B are zero
__device__ __forceinline__ void queries(const bf16* h_img,
                                        const bf16* __restrict__ w,
                                        const bf16* __restrict__ bias,
                                        float* region, float* qs, int B,
                                        int H, int Ah) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int stride = H + 8;
  bf16* hs = reinterpret_cast<bf16*>(region);    // [16][H + 8]
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < 16 * H; i += kThreads) {
    const int k = i / H, c = i % H;
    hs[k * stride + c] = k < B ? h_img[k * H + c] : zero;
  }
  __syncthreads();
  for (int nt = warp; nt < Ah / 8; nt += kWarps) {
    const int n0 = nt * 8;
    const bf16* wr = w + (size_t)(n0 + g) * H + 2 * t;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[4];
      load_a(hs, stride, k0, g, t, a);
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr + k0);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + k0 + 8);
      mma_bf16(c, a, b0, b1);
    }
    if (g < B) {
      qs[g * Ah + n0 + 2 * t] = c[0] + to_f32(bias[n0 + 2 * t]);
      qs[g * Ah + n0 + 2 * t + 1] = c[1] + to_f32(bias[n0 + 2 * t + 1]);
    }
  }
}

// Phase 4, f32: out[k][f] = sum_n w[k][n] att[n][f], threads along f
__device__ __forceinline__ void weighted_sum(const float* __restrict__ at,
                                             const float* es, float* region,
                                             float* __restrict__ out, int B,
                                             int N, int Np, int Fe) {
  for (int f = threadIdx.x; f < Fe; f += kThreads) {
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float a = at[(size_t)n * Fe + f];
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < B) acc[k] = fmaf(es[k * N + n], a, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k)
      if (k < B) out[(size_t)k * Fe + f] = acc[k];
  }
}

// Phase 4, bf16: [16, Np] x [Np, Fe] on the tensor cores. The weights
// (A, [16][Np + 8]) are at the start of the region, the att chunk
// ([kChunk][kFeat + 8]) after them.
__device__ __forceinline__ void weighted_sum(const bf16* __restrict__ at,
                                             const float* es, float* region,
                                             bf16* __restrict__ out, int B,
                                             int N, int Np, int Fe) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wstride = Np + 8, astride = kFeat + 8;
  const bf16* wb = reinterpret_cast<const bf16*>(region);
  bf16* as = reinterpret_cast<bf16*>(region) + 16 * wstride;
  for (int f0 = 0; f0 < Fe; f0 += kFeat) {
    const int fw = min(kFeat, Fe - f0);
    float acc[kFeatTiles][4];
#pragma unroll
    for (int j = 0; j < kFeatTiles; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int p0 = 0; p0 < Np; p0 += kChunk) {
      __syncthreads();               // the previous chunk is consumed
      const int vecs = fw / 8;
      for (int e = tid; e < kChunk * vecs; e += kThreads) {
        const int pp = e / vecs, fv = e % vecs;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + pp < N)
          v = *reinterpret_cast<const uint4*>(
              at + (size_t)(p0 + pp) * Fe + f0 + fv * 8);
        *reinterpret_cast<uint4*>(as + pp * astride + fv * 8) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 16) {
        if (p0 + ks >= Np) break;
        uint32_t a[4];
        load_a(wb, wstride, p0 + ks, g, t, a);
        const bf16* b = as + (ks + 2 * t) * astride + g;
#pragma unroll
        for (int j = 0; j < kFeatTiles; ++j) {
          const int n0 = (warp + kWarps * j) * 8;
          if (n0 >= fw) break;
          const uint32_t b0 = pack(b[n0], b[astride + n0]);
          const uint32_t b1 =
              pack(b[8 * astride + n0], b[9 * astride + n0]);
          mma_bf16(acc[j], a, b0, b1);
        }
      }
    }
    if (g < B) {
#pragma unroll
      for (int j = 0; j < kFeatTiles; ++j) {
        const int n0 = (warp + kWarps * j) * 8;
        if (n0 >= fw) break;
        *reinterpret_cast<uint32_t*>(out + (size_t)g * Fe + f0 + n0 +
                                     2 * t) =
            pack(__float2bfloat16(acc[j][0]), __float2bfloat16(acc[j][1]));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_att_v2_kernel(const T* __restrict__ h, const T* __restrict__ w,
                   const T* __restrict__ bias, const T* __restrict__ alpha,
                   const T* __restrict__ p_att, const T* __restrict__ att,
                   T* __restrict__ out, int B, int H, int Ah, int N,
                   int Fe) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kVec = Vec<T>::n;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) / 16 * 16;
  float* qs = smem;                  // [B][Ah]  queries
  float* as = qs + B * Ah;           // [Ah]     alpha
  float* es = as + Ah;               // [B][N]   logits, then weights
  float* region = es + ((B * N + 3) / 4) * 4;   // phase 1, then phase 4

  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < Ah; j += kThreads) as[j] = to_f32(alpha[j]);
  queries(h + (size_t)img * B * H, w, bias, region, qs, B, H, Ah);
  __syncthreads();

  // phase 2: e[k][n], one warp per position, 16-byte loads along Ah
  if (kMma) {   // the bf16 weights' tile, zero where padded
    uint32_t* wz = reinterpret_cast<uint32_t*>(region);
    for (int i = tid; i < 16 * (Np + 8) / 2; i += kThreads) wz[i] = 0u;
  }
  const T* pa = p_att + (size_t)img * N * Ah;
  for (int n = warp; n < N; n += kWarps) {
    const T* row = pa + (size_t)n * Ah;
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int j0 = lane * kVec; j0 < Ah; j0 += 32 * kVec) {
      float p[kVec];
      Vec<T>::load(row + j0, p);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float a = as[j0 + i];
#pragma unroll
        for (int k = 0; k < kMaxBeam; ++k)
          if (k < B)
            acc[k] = fmaf(a, tanhf(p[i] + qs[k * Ah + j0 + i]), acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) {
      if (k < B) {
        const float s = warp_sum(acc[k]);
        if (lane == 0) es[k * N + n] = s;
      }
    }
  }
  __syncthreads();

  // phase 3: softmax over n, one warp per beam
  if (warp < B) {
    float* e = es + warp * N;
    float m = -INFINITY;
    for (int n = lane; n < N; n += 32) m = fmaxf(m, e[n]);
    m = warp_max(m);
    float s = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float x = expf(e[n] - m);
      e[n] = x;
      s += x;
    }
    s = warp_sum(s);
    for (int n = lane; n < N; n += 32) {
      e[n] = e[n] / s;
      if (kMma)
        reinterpret_cast<bf16*>(region)[warp * (Np + 8) + n] =
            __float2bfloat16(e[n]);
    }
  }
  __syncthreads();

  // phase 4: the weighted sum, att read once for all beams
  weighted_sum(att + (size_t)img * N * Fe, es, region,
               out + (size_t)img * B * Fe, B, N, Np, Fe);
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* alpha,
           const void* p_att, const void* att, void* out, int bs, int B,
           int H, int Ah, int N, int Fe, void* stream) {
  if (B < 1 || B > kMaxBeam || bs < 1 || N < 1 || H % 16 || Ah % 8 ||
      Fe % 8)
    return (int)cudaErrorInvalidValue;
  const bool mma = sizeof(T) == 2;
  const size_t Np = (N + 15) / 16 * 16;
  const size_t head =
      sizeof(float) * ((size_t)B * Ah + Ah + ((size_t)B * N + 3) / 4 * 4);
  const size_t phase1 = mma ? 2 * 16 * ((size_t)H + 8)
                            : sizeof(float) * (size_t)B * H;
  const size_t phase4 =
      mma ? 2 * (16 * (Np + 8) + (size_t)kChunk * (kFeat + 8)) : 0;
  const size_t smem = head + (phase1 > phase4 ? phase1 : phase4);
  cudaError_t err = cudaFuncSetAttribute(
      beam_att_v2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_att_v2_kernel<T><<<bs, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)h, (const T*)w, (const T*)b, (const T*)alpha,
      (const T*)p_att, (const T*)att, (T*)out, B, H, Ah, N, Fe);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_beam_att_v2_f32(const void* h, const void* w, const void* b,
                        const void* alpha, const void* p_att,
                        const void* att, void* out, int bs, int B, int H,
                        int Ah, int N, int Fe, void* stream) {
  return launch<float>(h, w, b, alpha, p_att, att, out, bs, B, H, Ah, N, Fe,
                       stream);
}

int isc_beam_att_v2_bf16(const void* h, const void* w, const void* b,
                         const void* alpha, const void* p_att,
                         const void* att, void* out, int bs, int B, int H,
                         int Ah, int N, int Fe, void* stream) {
  return launch<bf16>(h, w, b, alpha, p_att, att, out, bs, B, H, Ah, N, Fe,
                      stream);
}

}  // extern "C"

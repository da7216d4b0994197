// Beam-shared additive content attention over int8 storage, on Hopper.
//
// Replaces the Pallas kernel tools/bench_int8.py `_kernel_i8` (the
// pallas_call at :309). att and p_att are stored as int8 with one f32 scale
// per (image, channel); the kernel dequantises them on the fly. For every
// image of the batch and each of its B beams:
//
//   q[k]    = h[img*B + k] @ W_h2att^T + b_h2att            (f32 accumulate)
//   p[n, j] = p_att_q[n, j] * p_att_s[j]                    (f32)
//   e[k, n] = sum_j alpha[j] * tanh(p[n, j] + q[k, j])      (alpha's bias
//             dropped: it shifts every logit equally and cancels in softmax)
//   w[k]    = softmax_n(e[k])
//   out[k]  = sum_n w[k, n] * (att_q[n] * att_s)            (bf16 out)
//
// What bounds it on the H100: the bytes of att and p_att, now one byte a
// value (77 MB a step at bs=384, N=196, 512 wide, plus 1.6 MB of scales:
// about 24 us at 3.35 TB/s), with 115.6 M tanh beside them. There are no
// int8 tensor-core products: int8 only halves the bytes. The design is v1's
// (csrc/fused_attention.cu), one block per image, 8 warps, but every byte
// stream is 16 bytes a thread:
//  1. q: one warp per output j, lanes along H, 8 values of W a load; the
//     image's h rows sit in shared memory in f32, laid out so that the
//     lanes' reads fall in distinct banks.
//  2. logits: one warp per position n; each lane reads 16 int8 channels of
//     the p_att row in one load and dequantises them in registers with the
//     image's scales (shared memory); the row is read once for all B beams.
//  3. softmax over n, one warp per beam, as v1.
//  4. weighted sum: warp w takes the positions n = w mod 8, each lane 16
//     channels of att in one load with their 16 scales in registers; the 8
//     warps' partial sums meet in shared memory and are added in a fixed
//     order, 512 channels at a time.
// Shared-memory arrays indexed by channel are stored chunk-major
// (index (c % V) * (C / V) + c / V for chunks of V channels), so a warp
// whose lanes hold consecutive chunks reads 32 distinct banks.
// h, W, the bias and alpha are bf16. Needs H % 8 == 0, Ah % 16 == 0,
// Fe % 16 == 0 and 16-byte aligned operands (the wrapper checks). The kernel
// is instantiated for each beam size 1..8 so that the accumulators stay in
// registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFeatChunk = 32 * 16;   // channels of one weighted-sum pass

typedef __nv_bfloat16 bf16;


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

// 8 consecutive bf16 values as f32, one 16-byte load
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(v[i]);
}

// 16 int8 values as f32, one 16-byte load
__device__ __forceinline__ void load16_i8(const int8_t* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int8_t* v = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)v[i];
}

template <int B>
__global__ void __launch_bounds__(kThreads)
beam_att_i8_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias,
                   const bf16* __restrict__ alpha,
                   const int8_t* __restrict__ p_att_q,
                   const float* __restrict__ p_att_s,
                   const int8_t* __restrict__ att_q,
                   const float* __restrict__ att_s, bf16* __restrict__ out,
                   int H, int Ah, int N, int Fe) {
  extern __shared__ __align__(16) float smem[];
  const int Ac = Ah / 16;             // 16-channel chunks of Ah
  const int Hc = H / 8;               // 8-value chunks of H
  float* qs = smem;                   // [B][Ah]  queries, chunk-major
  float* as = qs + B * Ah;            // [Ah]     alpha, chunk-major
  float* ss = as + Ah;                // [Ah]     p_att scales, chunk-major
  float* es = ss + Ah;                // [B][N]   logits, then weights
  float* region = es + (B * N + 3) / 4 * 4;   // h (phase 1), partials (4)

  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* hs = region;                 // [B][H], chunk-major by 8
  const bf16* h_img = h + (size_t)img * B * H;
  for (int i = tid; i < B * H; i += kThreads) {
    const int k = i / H, c = i % H;
    hs[k * H + (c & 7) * Hc + (c >> 3)] = __bfloat162float(h_img[i]);
  }
  const float* ps_img = p_att_s + (size_t)img * Ah;
  for (int j = tid; j < Ah; j += kThreads) {
    const int s = (j & 15) * Ac + (j >> 4);
    as[s] = __bfloat162float(alpha[j]);
    ss[s] = ps_img[j];
  }
  __syncthreads();

  // 1. q[k][j] = bias[j] + sum_i h[k][i] W[j][i]: one warp per output j
  for (int j = warp; j < Ah; j += kWarps) {
    const bf16* wj = w + (size_t)j * H;
    float acc[B];
#pragma unroll
    for (int k = 0; k < B; ++k) acc[k] = 0.f;
    for (int c = lane; c < Hc; c += 32) {
      float wv[8];
      load8(wj + c * 8, wv);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int k = 0; k < B; ++k)
          acc[k] = fmaf(hs[k * H + t * Hc + c], wv[t], acc[k]);
      }
    }
    const float bj = __bfloat162float(bias[j]);
    const int s = (j & 15) * Ac + (j >> 4);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) qs[k * Ah + s] = v + bj;
    }
  }
  __syncthreads();

  // 2. e[k][n]: one warp per position, 16 int8 channels a lane
  const int8_t* pa = p_att_q + (size_t)img * N * Ah;
  for (int n = warp; n < N; n += kWarps) {
    const int8_t* row = pa + (size_t)n * Ah;
    float acc[B];
#pragma unroll
    for (int k = 0; k < B; ++k) acc[k] = 0.f;
    for (int c = lane; c < Ac; c += 32) {
      float p[16];
      load16_i8(row + c * 16, p);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int s = t * Ac + c;
        const float pv = p[t] * ss[s];
        const float a = as[s];
#pragma unroll
        for (int k = 0; k < B; ++k)
          acc[k] = fmaf(a, tanhf(pv + qs[k * Ah + s]), acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) es[k * N + n] = v;
    }
  }
  __syncthreads();

  // 3. softmax over n, one warp per beam
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
    for (int n = lane; n < N; n += 32) e[n] = e[n] / s;
  }
  __syncthreads();

  // 4. out[k][f] = sum_n w[k][n] att[n][f], 512 channels a pass; warp w
  // sums the positions n = w mod 8, then the 8 partials are added in order
  float* part = region;               // [kWarps][B][512], chunk-major by 16
  const int8_t* at = att_q + (size_t)img * N * Fe;
  const float* as_img = att_s + (size_t)img * Fe;
  bf16* out_img = out + (size_t)img * B * Fe;
  for (int f0 = 0; f0 < Fe; f0 += kFeatChunk) {
    const int f = f0 + lane * 16;
    const bool live = f < Fe;
    float acc[B][16];
#pragma unroll
    for (int k = 0; k < B; ++k)
#pragma unroll
      for (int t = 0; t < 16; ++t) acc[k][t] = 0.f;
    if (live) {
      float sc[16];
#pragma unroll
      for (int t = 0; t < 16; t += 4) {
        const float4 v = *reinterpret_cast<const float4*>(as_img + f + t);
        sc[t] = v.x; sc[t + 1] = v.y; sc[t + 2] = v.z; sc[t + 3] = v.w;
      }
#pragma unroll 2
      for (int n = warp; n < N; n += kWarps) {
        float a[16];
        load16_i8(at + (size_t)n * Fe + f, a);
#pragma unroll
        for (int t = 0; t < 16; ++t) a[t] *= sc[t];
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const float wk = es[k * N + n];
#pragma unroll
          for (int t = 0; t < 16; ++t) acc[k][t] = fmaf(wk, a[t], acc[k][t]);
        }
      }
    }
    __syncthreads();                  // the previous pass's partials are read
#pragma unroll
    for (int k = 0; k < B; ++k)
#pragma unroll
      for (int t = 0; t < 16; ++t)
        part[(warp * B + k) * kFeatChunk + t * 32 + lane] = acc[k][t];
    __syncthreads();
    for (int item = tid; item < B * 32; item += kThreads) {
      const int k = item >> 5, l = item & 31;
      const int fo = f0 + l * 16;
      if (fo >= Fe) continue;
      float s[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) s[t] = 0.f;
      for (int wi = 0; wi < kWarps; ++wi) {
        const float* pp = part + (wi * B + k) * kFeatChunk + l;
#pragma unroll
        for (int t = 0; t < 16; ++t) s[t] += pp[t * 32];
      }
      uint4 o[2];
      bf16* ob = reinterpret_cast<bf16*>(o);
#pragma unroll
      for (int t = 0; t < 16; ++t) ob[t] = __float2bfloat16(s[t]);
      uint4* dst = reinterpret_cast<uint4*>(out_img + (size_t)k * Fe + fo);
      dst[0] = o[0];
      dst[1] = o[1];
    }
  }
}

// shared memory a block needs; a launch that needs more than the device's
// opt-in maximum (227 KB on the H100) is refused with cudaErrorInvalidValue,
// and the wrapper raises on the returned code
size_t smem_bytes(int B, int H, int Ah, int N) {
  const size_t head =
      (size_t)B * Ah + 2 * (size_t)Ah + ((size_t)B * N + 3) / 4 * 4;
  const size_t phase1 = (size_t)B * H;
  const size_t phase4 = (size_t)kWarps * B * kFeatChunk;
  return sizeof(float) * (head + (phase1 > phase4 ? phase1 : phase4));
}

// raises the instantiation's dynamic shared-memory limit to the device's
// opt-in maximum, once; returns that maximum, or minus a CUDA error code
template <int B>
int smem_limit() {
  static const int limit = [] {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(beam_att_i8_kernel<B>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    return err == cudaSuccess ? optin : -(int)err;
  }();
  return limit;
}

template <int B>
int launch_b(const void* h, const void* w, const void* b, const void* alpha,
             const void* p_att_q, const void* p_att_s, const void* att_q,
             const void* att_s, void* out, int bs, int H, int Ah, int N,
             int Fe, void* stream) {
  const size_t smem = smem_bytes(B, H, Ah, N);
  const int limit = smem_limit<B>();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  beam_att_i8_kernel<B><<<bs, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)h, (const bf16*)w, (const bf16*)b, (const bf16*)alpha,
      (const int8_t*)p_att_q, (const float*)p_att_s, (const int8_t*)att_q,
      (const float*)att_s, (bf16*)out, H, Ah, N, Fe);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_beam_att_i8_bf16(const void* h, const void* w, const void* b,
                         const void* alpha, const void* p_att_q,
                         const void* p_att_s, const void* att_q,
                         const void* att_s, void* out, int bs, int B, int H,
                         int Ah, int N, int Fe, void* stream) {
  if (bs < 1 || N < 1 || H < 8 || H % 8 || Ah < 16 || Ah % 16 || Fe < 16 ||
      Fe % 16)
    return (int)cudaErrorInvalidValue;
#define ISC_I8_CASE(BB)                                                 \
  case BB:                                                              \
    return launch_b<BB>(h, w, b, alpha, p_att_q, p_att_s, att_q, att_s, \
                        out, bs, H, Ah, N, Fe, stream);
  switch (B) {
    ISC_I8_CASE(1)
    ISC_I8_CASE(2)
    ISC_I8_CASE(3)
    ISC_I8_CASE(4)
    ISC_I8_CASE(5)
    ISC_I8_CASE(6)
    ISC_I8_CASE(7)
    ISC_I8_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ISC_I8_CASE
}

}  // extern "C"

// Beam-shared additive content attention for beam decode on Hopper.
//
// Replaces the Pallas kernel insenticap_model_tpu/ops/fused_attention.py
// `_kernel` (v1). For every image of the batch and each of its B beams:
//
//   q[k]    = h[img*B + k] @ W_h2att^T + b_h2att            (f32 accumulate)
//   e[k, n] = sum_j alpha[j] * tanh(p_att[n, j] + q[k, j])  (alpha's bias
//             dropped: it shifts every logit equally and cancels in softmax)
//   w[k]    = softmax_n(e[k])
//   out[k]  = sum_n w[k, n] * att[n]                         (att's dtype)
//
// What bounds it on the H100: at serving width (N=196, Ah=Fe=512, B=3,
// bf16) each image's att and p_att are 392 KB, read from device memory
// once for all B beams, so the step is bytes-bound (154 MB at bs=384) with
// 115.6 M tanh beside it. The design: one block per image; the B queries
// and the softmax weights live in shared memory in f32, p_att rows are
// streamed once (one warp per row, lanes along the contiguous channel
// axis) to form all B logits, and att is streamed once (threads along the
// channel axis) for all B weighted sums. W_h2att ([Ah, H], row-major) is
// read per block from L2: one warp per output row, lanes along H, so the
// reads coalesce. No tensor cores, TMA or pipelining yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeam = 8;   // softmax runs one warp per beam

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_att_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ alpha,
                const T* __restrict__ p_att, const T* __restrict__ att,
                T* __restrict__ out, int B, int H, int Ah, int N, int Fe) {
  extern __shared__ float smem[];
  float* hs = smem;              // [B][H]   the image's beam rows of h
  float* qs = hs + B * H;        // [B][Ah]  queries
  float* as = qs + B * Ah;       // [Ah]     alpha
  float* es = as + Ah;           // [B][N]   logits, then softmax weights

  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* h_img = h + (size_t)img * B * H;
  for (int i = tid; i < B * H; i += kThreads) hs[i] = to_f32(h_img[i]);
  for (int j = tid; j < Ah; j += kThreads) as[j] = to_f32(alpha[j]);
  __syncthreads();

  // q[k][j] = bias[j] + sum_i h[k][i] * W[j][i]: one warp per output j
  for (int j = warp; j < Ah; j += kWarps) {
    const T* wj = w + (size_t)j * H;
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int i = lane; i < H; i += 32) {
      const float wv = to_f32(wj[i]);
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < B) acc[k] = fmaf(hs[k * H + i], wv, acc[k]);
    }
    const float bj = to_f32(bias[j]);
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) {
      if (k < B) {
        const float s = warp_sum(acc[k]);
        if (lane == 0) qs[k * Ah + j] = s + bj;
      }
    }
  }
  __syncthreads();

  // e[k][n] = sum_j alpha[j] tanh(p_att[n][j] + q[k][j]): one warp per
  // position n; the p_att row is read once for every beam
  const T* pa = p_att + (size_t)img * N * Ah;
  for (int n = warp; n < N; n += kWarps) {
    const T* row = pa + (size_t)n * Ah;
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int j = lane; j < Ah; j += 32) {
      const float p = to_f32(row[j]);
      const float a = as[j];
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < B) acc[k] = fmaf(a, tanhf(p + qs[k * Ah + j]), acc[k]);
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

  // softmax over n, one warp per beam
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

  // out[k][f] = sum_n w[k][n] att[n][f]: threads along f; att read once
  const T* at = att + (size_t)img * N * Fe;
  for (int f = tid; f < Fe; f += kThreads) {
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float a = to_f32(at[(size_t)n * Fe + f]);
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < B) acc[k] = fmaf(es[k * N + n], a, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k)
      if (k < B) out[((size_t)img * B + k) * Fe + f] = from_f32<T>(acc[k]);
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* alpha,
           const void* p_att, const void* att, void* out, int bs, int B,
           int H, int Ah, int N, int Fe, void* stream) {
  if (B < 1 || B > kMaxBeam || bs < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)B * H + (size_t)B * Ah + Ah + (size_t)B * N);
  cudaError_t err = cudaFuncSetAttribute(
      beam_att_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_att_kernel<T><<<bs, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)h, (const T*)w, (const T*)b, (const T*)alpha,
      (const T*)p_att, (const T*)att, (T*)out, B, H, Ah, N, Fe);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_beam_att_f32(const void* h, const void* w, const void* b,
                     const void* alpha, const void* p_att, const void* att,
                     void* out, int bs, int B, int H, int Ah, int N, int Fe,
                     void* stream) {
  return launch<float>(h, w, b, alpha, p_att, att, out, bs, B, H, Ah, N, Fe,
                       stream);
}

int isc_beam_att_bf16(const void* h, const void* w, const void* b,
                      const void* alpha, const void* p_att, const void* att,
                      void* out, int bs, int B, int H, int Ah, int N, int Fe,
                      void* stream) {
  return launch<__nv_bfloat16>(h, w, b, alpha, p_att, att, out, bs, B, H,
                               Ah, N, Fe, stream);
}

}  // extern "C"

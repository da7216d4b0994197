// Winograd F(5x5, 3x3) transform kernels for the detector's chained 3x3
// convs on Hopper, spatial-major layout [H, W, B, C] with channels fastest.
//
// Replaces the Pallas kernels of insenticap_model_tpu/ops/winograd_pallas.py:
//   isc_wino_input_*  <- _input_kernel  (:67)   x -> V = B^T d B per tile
//   isc_wino_middle_* <- _middle_kernel (:99)   M -> A^T M A + bias, trim to
//                        h x w, SAME re-pad, -> B^T d B for the next conv
//   isc_wino_output_* <- _output_kernel (:83)   M -> A^T M A + bias -> y
// The per-layer GEMM V[49, tiles*B, C] @ U[49, C, K] between them is a
// batched matrix product outside these kernels, as it was an XLA
// dot_general outside the Pallas kernels.
//
// Shapes: V and M are [49, tiles, B, C] with tiles = th*tw (th = ceil(h/5));
// the SAME padding of the input is applied on the fly (zero outside h x w).
// The output kernel writes y [h, w, B, K] directly, dropping the tile
// overhang (the Pallas kernel wrote 15x15 and sliced).
//
// What bounds them on the H100: bytes. Each (b, c) column is independent
// and the transforms are ~700 f32 FMAs per 7x7 tile, so one thread owns a
// (b, c) column over all tiles, and neighbouring threads take neighbouring
// channels: every load and store of a warp is one contiguous 64 B (bf16)
// run. Transform arithmetic is f32; the matrices (from the port's
// cook_toom) arrive by value in a kernel parameter, so reads of them are
// constant-bank broadcasts. The middle kernel needs a whole padded
// (5*th+2)^2 f32 plane per column before it can re-transform; it keeps it
// in shared memory, laid out [position][thread] so a warp's accesses fall
// in 32 different banks (17*17*4 B * 64 threads = 74 KB per block).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kM = 5;            // output tile
constexpr int kT = kM + 2;       // input tile / transform size
constexpr int kMaxTiles = 3;     // per spatial dim: h, w <= 15
constexpr int kThreads = 256;    // input / output kernels
constexpr int kMidThreads = 64;  // middle kernel (shared-memory planes)

struct Mats {
  float bt[kT][kT];  // B^T
  float at[kM][kT];  // A^T
};

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

// v[a][b] = sum_i sum_j bt[a][i] d[i][j] bt[b][j], stored at plane a*7+b
template <typename T>
__device__ __forceinline__ void forward_store(const Mats& mt,
                                              float (&d)[kT][kT], T* v,
                                              size_t plane_stride) {
  float t1[kT][kT];
#pragma unroll
  for (int a = 0; a < kT; ++a)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kT; ++i) acc = fmaf(mt.bt[a][i], d[i][j], acc);
      t1[a][j] = acc;
    }
#pragma unroll
  for (int a = 0; a < kT; ++a)
#pragma unroll
    for (int b = 0; b < kT; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kT; ++j) acc = fmaf(mt.bt[b][j], t1[a][j], acc);
      v[(size_t)(a * kT + b) * plane_stride] = from_f32<T>(acc);
    }
}

// y[x][y] = sum_a sum_b at[x][a] m[a*7+b] at[y][b]
template <typename T>
__device__ __forceinline__ void inverse_load(const Mats& mt, const T* m,
                                             size_t plane_stride,
                                             float (&y)[kM][kM]) {
  float mm[kT][kT];
#pragma unroll
  for (int a = 0; a < kT; ++a)
#pragma unroll
    for (int b = 0; b < kT; ++b)
      mm[a][b] = to_f32(m[(size_t)(a * kT + b) * plane_stride]);
  float t2[kM][kT];
#pragma unroll
  for (int x = 0; x < kM; ++x)
#pragma unroll
    for (int b = 0; b < kT; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < kT; ++a) acc = fmaf(mt.at[x][a], mm[a][b], acc);
      t2[x][b] = acc;
    }
#pragma unroll
  for (int x = 0; x < kM; ++x)
#pragma unroll
    for (int yy = 0; yy < kM; ++yy) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < kT; ++b) acc = fmaf(mt.at[yy][b], t2[x][b], acc);
      y[x][yy] = acc;
    }
}

// x [H, W, BC] -> v [49, tiles, BC]; one thread per (b, c) column
template <typename T>
__global__ void __launch_bounds__(kThreads)
wino_input_kernel(const T* __restrict__ x, T* __restrict__ v,
                  const __grid_constant__ Mats mt, int H, int W, int th, int tw, int BC) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BC) return;
  const size_t tiles = (size_t)th * tw;
  for (int ti = 0; ti < th; ++ti)
    for (int tj = 0; tj < tw; ++tj) {
      float d[kT][kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const int r = kM * ti + i - 1;   // -1: the SAME pad
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          const int s = kM * tj + j - 1;
          d[i][j] = (r >= 0 && r < H && s >= 0 && s < W)
                        ? to_f32(x[((size_t)r * W + s) * BC + idx])
                        : 0.f;
        }
      }
      forward_store<T>(mt, d, v + ((size_t)ti * tw + tj) * BC + idx,
                       tiles * BC);
    }
}

// m [49, tiles, BK] (+ f32 bias [K]) -> y [H, W, BK]
template <typename T>
__global__ void __launch_bounds__(kThreads)
wino_output_kernel(const T* __restrict__ m, const float* __restrict__ bias,
                   T* __restrict__ y, const __grid_constant__ Mats mt,
                   int H, int W, int th, int tw, int K, int BK) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BK) return;
  const float bk = bias[idx % K];
  const size_t tiles = (size_t)th * tw;
  for (int ti = 0; ti < th; ++ti)
    for (int tj = 0; tj < tw; ++tj) {
      float yy[kM][kM];
      inverse_load<T>(mt, m + ((size_t)ti * tw + tj) * BK + idx,
                      tiles * BK, yy);
#pragma unroll
      for (int a = 0; a < kM; ++a)
#pragma unroll
        for (int b = 0; b < kM; ++b) {
          const int oh = kM * ti + a, ow = kM * tj + b;
          if (oh < H && ow < W)
            y[((size_t)oh * W + ow) * BK + idx] = from_f32<T>(yy[a][b] + bk);
        }
    }
}

// m [49, tiles, BK] (+ bias [K]) -> v [49, tiles, BK]: inverse transform,
// bias, trim to H x W, SAME re-pad and forward transform, with the padded
// plane in shared memory and never in device memory
template <typename T>
__global__ void __launch_bounds__(kMidThreads)
wino_middle_kernel(const T* __restrict__ m, const float* __restrict__ bias,
                   T* __restrict__ v, const __grid_constant__ Mats mt,
                   int H, int W, int th, int tw, int K, int BK) {
  extern __shared__ float plane[];   // [(5*th+2) * (5*tw+2)][kMidThreads]
  const int tid = threadIdx.x;
  const int idx = blockIdx.x * blockDim.x + tid;
  if (idx >= BK) return;             // columns never share plane entries
  const int hp = kM * th + 2, wp = kM * tw + 2;
  for (int p = 0; p < hp * wp; ++p) plane[p * kMidThreads + tid] = 0.f;
  const float bk = bias[idx % K];
  const size_t tiles = (size_t)th * tw;
  for (int ti = 0; ti < th; ++ti)
    for (int tj = 0; tj < tw; ++tj) {
      float yy[kM][kM];
      inverse_load<T>(mt, m + ((size_t)ti * tw + tj) * BK + idx,
                      tiles * BK, yy);
#pragma unroll
      for (int a = 0; a < kM; ++a)
#pragma unroll
        for (int b = 0; b < kM; ++b) {
          const int oh = kM * ti + a, ow = kM * tj + b;
          if (oh < H && ow < W)   // trim the tile overhang, then +1: pad
            plane[((oh + 1) * wp + ow + 1) * kMidThreads + tid] =
                yy[a][b] + bk;
        }
    }
  for (int ti = 0; ti < th; ++ti)
    for (int tj = 0; tj < tw; ++tj) {
      float d[kT][kT];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j)
          d[i][j] =
              plane[((kM * ti + i) * wp + kM * tj + j) * kMidThreads + tid];
      forward_store<T>(mt, d, v + ((size_t)ti * tw + tj) * BK + idx,
                       tiles * BK);
    }
}

Mats make_mats(const float* host) {  // host: B^T (49) then A^T (35)
  Mats mt;
  memcpy(mt.bt, host, sizeof(mt.bt));
  memcpy(mt.at, host + kT * kT, sizeof(mt.at));
  return mt;
}

int tiles_of(int n) { return (n + kM - 1) / kM; }

bool bad_extent(int H, int W, int cols) {
  return H < 1 || W < 1 || cols < 1 || tiles_of(H) > kMaxTiles ||
         tiles_of(W) > kMaxTiles;
}

template <typename T>
int input(const void* x, void* v, const float* mats, int H, int W, int BC,
          void* stream) {
  if (bad_extent(H, W, BC)) return (int)cudaErrorInvalidValue;
  wino_input_kernel<T><<<(BC + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)x, (T*)v, make_mats(mats), H, W, tiles_of(H), tiles_of(W),
      BC);
  return (int)cudaGetLastError();
}

template <typename T>
int output(const void* m, const void* bias, void* y, const float* mats,
           int H, int W, int K, int BK, void* stream) {
  if (bad_extent(H, W, BK) || K < 1 || BK % K)
    return (int)cudaErrorInvalidValue;
  wino_output_kernel<T><<<(BK + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)m, (const float*)bias, (T*)y, make_mats(mats), H, W, tiles_of(H),
      tiles_of(W), K, BK);
  return (int)cudaGetLastError();
}

template <typename T>
int middle(const void* m, const void* bias, void* v, const float* mats,
           int H, int W, int K, int BK, void* stream) {
  if (bad_extent(H, W, BK) || K < 1 || BK % K)
    return (int)cudaErrorInvalidValue;
  const int th = tiles_of(H), tw = tiles_of(W);
  const size_t smem =
      sizeof(float) * (size_t)(kM * th + 2) * (kM * tw + 2) * kMidThreads;
  cudaError_t err = cudaFuncSetAttribute(
      wino_middle_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wino_middle_kernel<T><<<(BK + kMidThreads - 1) / kMidThreads, kMidThreads,
                          smem, (cudaStream_t)stream>>>(
      (const T*)m, (const float*)bias, (T*)v, make_mats(mats), H, W, th, tw, K,
      BK);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_wino_input_f32(const void* x, void* v, const float* mats, int H,
                       int W, int BC, void* stream) {
  return input<float>(x, v, mats, H, W, BC, stream);
}
int isc_wino_input_bf16(const void* x, void* v, const float* mats, int H,
                        int W, int BC, void* stream) {
  return input<__nv_bfloat16>(x, v, mats, H, W, BC, stream);
}
int isc_wino_middle_f32(const void* m, const void* bias, void* v,
                        const float* mats, int H, int W, int K, int BK,
                        void* stream) {
  return middle<float>(m, bias, v, mats, H, W, K, BK, stream);
}
int isc_wino_middle_bf16(const void* m, const void* bias, void* v,
                         const float* mats, int H, int W, int K, int BK,
                         void* stream) {
  return middle<__nv_bfloat16>(m, bias, v, mats, H, W, K, BK, stream);
}
int isc_wino_output_f32(const void* m, const void* bias, void* y,
                        const float* mats, int H, int W, int K, int BK,
                        void* stream) {
  return output<float>(m, bias, y, mats, H, W, K, BK, stream);
}
int isc_wino_output_bf16(const void* m, const void* bias, void* y,
                         const float* mats, int H, int W, int K, int BK,
                         void* stream) {
  return output<__nv_bfloat16>(m, bias, y, mats, H, W, K, BK, stream);
}

}  // extern "C"

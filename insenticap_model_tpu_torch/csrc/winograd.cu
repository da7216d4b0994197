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
// overhang (the Pallas kernel wrote 15x15 and sliced). The input kernel
// reads x through its strides (position row, position column, image; the
// channels at stride 1), so the detector's [B, H, W, C] features go in as
// their permuted view, with no copy.
//
// What bounds them on the H100: bytes. At the serving shape (bs=384, 14x14,
// 2048 -> 1024 -> 512, bf16) the input transform reads 308 MB and writes
// 694 MB, the middle one reads and writes 347 MB each, the output one reads
// 173 MB and writes 77 MB; their f32 transforms would
// take 0.5-0.8 of that time in FFMA instruction slots if every term of the
// 7x7 products were taken, so the kernels skip the terms that are zero in
// B^T (15 of 49) and A^T (8 of 35): the nonzero pattern is a compile-time
// mask below, and the host entry points refuse matrices with another one.
//
// wino_input_kernel<T, kVec>: one block a slab of one image x 64 channels
// (two channels a lane, three warps). Its threads bring the slab's h x w
// positions into shared memory once, by 16-byte cp.async in whole 128-byte
// lines (or element by element where x's base or strides are not 16-byte
// multiples), so each byte of x leaves device memory once although the 7x7
// windows overlap at stride 5 (2.25x). Then a warp takes a tile, a lane two
// adjacent channels: it reads its 7x7 window from shared memory a column at
// a time, transforms in f32 and stores V with two-channel stores (bf16x2),
// a warp 64 contiguous channels of each of the 49 planes.
// Several small blocks an SM keep one block's loads in flight while the
// others transform.
//
// wino_middle_kernel<T, kVec>: one block a slab (one image, 64 channels).
// Phase 1: a warp takes a tile and loads its 49 M planes straight into
// registers with two-channel loads (49 independent loads a lane, a warp 64
// contiguous channels each), inverse-transforms in f32, adds the f32 bias
// and writes the h x w interior (trimmed) into an f32 shared-memory plane
// [h*w][64]. The pad ring and the tile overhang are
// zeros known in advance: they are neither stored nor cleared, the reads
// of phase 2 test the extent instead. Phase 2 (after one barrier): the
// forward transform of each tile from that plane, stored as the input
// kernel stores. The plane is h*w*64*4 bytes (50 KB at 14x14), so shared
// memory bounds the blocks an SM holds (4), and each lane may keep all its
// sums in registers (some 166). The channels a lane, the warps a block and
// the blocks an SM that the launch bounds ask for (the constants below)
// measured best on the H100 among the variants tried (PERF.md). The
// dynamic shared-memory limit is raised once per instantiation.
//
// wino_output_kernel<T, kVec>: the middle kernel's phase 1 with the store
// going to y in place of the shared-memory plane. One block a slab (one
// image, 64 channels), a warp a tile, a lane two adjacent channels: 49
// independent two-channel loads of M straight into registers (a warp 128
// contiguous bytes each in bf16), the inverse transform in f32 with A^T's
// zeros skipped, the f32 bias, and the trimmed 5x5 written with
// two-channel stores (a warp 64 contiguous channels of each output
// position). It needs no shared memory, so registers bound the blocks an
// SM (a lane holds 50 output sums and a column of 7 planes), as the launch
// bounds below ask.
//
// kVec false (M's or y's base not aligned to two elements, or an odd
// channel count) loads and stores element by element in the same kernel.
//
// All three keep the arithmetic and the order of sums of the
// one-thread-a-column kernels of the first design (f32 transforms in the
// same index order, one rounding into the output's dtype, the bias summed
// in f32), so their results equal those kernels' except for the sign of a
// zero. The matrices arrive by value in a kernel parameter (constant-bank
// reads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kM = 5;            // output tile
constexpr int kT = kM + 2;       // input tile / transform size
constexpr int kMaxTiles = 3;     // per spatial dim: h, w <= 15
constexpr int kMaxExtent = kM * kMaxTiles;
constexpr int kNC = 2;           // channels a lane (input and middle)
constexpr int kWarps = 3;        // warps a block (input and middle)
constexpr int kCB = 32 * kNC;    // channels a block (a slab)
// blocks an SM that __launch_bounds__ asks room for, which caps the
// registers a lane at 65536 / (that x the block's threads). The input
// kernel's slab is small (25 KB at 14x14), so registers bound it: the
// forward transform keeps 49 f32 sums a channel, some 128 registers a lane,
// so 5 blocks of 96 threads. The middle kernel's f32 plane (50 KB) lets 4
// blocks share an SM's 227 KB, so it may take 170 registers a lane and
// spill nothing.
constexpr int kInMinBlocks = 5;
constexpr int kMidMinBlocks = 4;
// The output kernel has no shared memory: a lane's 50 output sums and a
// column of 7 planes bound it, so its launch bounds trade registers for
// blocks an SM. At 5 (128 registers a lane) it was the fastest of 3, 4
// and 5 in each of three rounds taken in turns, about 10% ahead; 3 and 4
// both give 168 registers, 4 blocks an SM, and spill more in the bf16
// vector instance (44 bytes against 24).
constexpr int kOutMinBlocks = 5;

// nonzero entries of B^T (bit a*7+i) and A^T (bit x*7+a) of the port's
// cook_toom(5, 3, [0, 1, -1, 2, -2, 1/2]) (ops/winograd.py _BT5, _AT5)
constexpr unsigned long long kBTMask = 0x1f95367cf9f3fULL;
constexpr unsigned long long kATMask = 0x7e7cf9f3fULL;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; the bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- the two adjacent channels of a lane, as f32 ---------------------------

// from shared memory (aligned to two elements)
template <typename T>
__device__ __forceinline__ void lds(const T* p, float (&o)[kNC]) {
  float2 f;
  if constexpr (sizeof(T) == 2)
    f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  else
    f = *reinterpret_cast<const float2*>(p);
  o[0] = f.x;
  o[1] = f.y;
}

// from device memory: one two-channel load where kVec (p aligned to two
// elements, the channel count even), else element by element; channels at
// or past `valid` read as zero
template <typename T, bool kVec>
__device__ __forceinline__ void ldg(const T* __restrict__ p, float (&o)[kNC],
                                    int valid) {
  if constexpr (kVec) {
    float2 f = make_float2(0.f, 0.f);
    if (valid >= kNC) {
      if constexpr (sizeof(T) == 2)
        f = __bfloat1622float2(
            __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
      else
        f = __ldg(reinterpret_cast<const float2*>(p));
    }
    o[0] = f.x;
    o[1] = f.y;
  } else {
#pragma unroll
    for (int n = 0; n < kNC; ++n)
      o[n] = n < valid ? to_f32(__ldg(p + n)) : 0.f;
  }
}

// to device memory, one rounding; channels at or past `valid` are skipped
template <typename T, bool kVec>
__device__ __forceinline__ void stg(T* p, const float (&o)[kNC], int valid) {
  if constexpr (kVec) {
    if (valid < kNC) return;
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(o[0],
                                                                     o[1]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
#pragma unroll
    for (int n = 0; n < kNC; ++n)
      if (n < valid) p[n] = from_f32<T>(o[n]);
  }
}

// -- the transforms, a column at a time ------------------------------------

// v[a][b] = sum_j bt[b][j] (sum_i bt[a][i] d[i][j]): load(i, j, d) gives
// d[i][j], store(a*7+b, v) takes plane a*7+b. The sums run over i, then
// j, ascending from 0, the zero terms left out.
template <typename Load, typename Store>
__device__ __forceinline__ void forward_tile(const Mats& mt, Load load,
                                             Store store) {
  float v[kT][kT][kNC];
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    float d[kT][kNC];
#pragma unroll
    for (int i = 0; i < kT; ++i) load(i, j, d[i]);
#pragma unroll
    for (int a = 0; a < kT; ++a) {
      float t[kNC];
#pragma unroll
      for (int n = 0; n < kNC; ++n) t[n] = 0.f;
#pragma unroll
      for (int i = 0; i < kT; ++i)
        if ((kBTMask >> (a * kT + i)) & 1)
#pragma unroll
          for (int n = 0; n < kNC; ++n) t[n] = fmaf(mt.bt[a][i], d[i][n], t[n]);
#pragma unroll
      for (int b = 0; b < kT; ++b) {
        if (j == 0)
#pragma unroll
          for (int n = 0; n < kNC; ++n) v[a][b][n] = 0.f;
        if ((kBTMask >> (b * kT + j)) & 1)
#pragma unroll
          for (int n = 0; n < kNC; ++n)
            v[a][b][n] = fmaf(mt.bt[b][j], t[n], v[a][b][n]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kT; ++a)
#pragma unroll
    for (int b = 0; b < kT; ++b) store(a * kT + b, v[a][b]);
}

// y[x][yy] = sum_b at[yy][b] (sum_a at[x][a] m[a*7+b]): load(p, m) gives
// plane p. The sums run over a, then b, as the one-thread-a-column
// kernels of the first design took them.
template <typename Load>
__device__ __forceinline__ void inverse_tile(const Mats& mt, Load load,
                                             float (&y)[kM][kM][kNC]) {
#pragma unroll
  for (int b = 0; b < kT; ++b) {
    float m[kT][kNC];
#pragma unroll
    for (int a = 0; a < kT; ++a) load(a * kT + b, m[a]);
#pragma unroll
    for (int x = 0; x < kM; ++x) {
      float t[kNC];
#pragma unroll
      for (int n = 0; n < kNC; ++n) t[n] = 0.f;
#pragma unroll
      for (int a = 0; a < kT; ++a)
        if ((kATMask >> (x * kT + a)) & 1)
#pragma unroll
          for (int n = 0; n < kNC; ++n) t[n] = fmaf(mt.at[x][a], m[a][n], t[n]);
#pragma unroll
      for (int yy = 0; yy < kM; ++yy) {
        if (b == 0)
#pragma unroll
          for (int n = 0; n < kNC; ++n) y[x][yy][n] = 0.f;
        if ((kATMask >> (yy * kT + b)) & 1)
#pragma unroll
          for (int n = 0; n < kNC; ++n)
            y[x][yy][n] = fmaf(mt.at[yy][b], t[n], y[x][yy][n]);
      }
    }
  }
}

// the slab of image b, channels [c0, c0 + kCB), of x [H, W, B, C] (strides
// sH, sW, sB; channels at 1) -> s [H*W][kCB], zeros past C. kVec starts
// 16-byte cp.async copies (the caller commits and waits); else
// element-wise loads and stores
template <typename T, bool kVec>
__device__ __forceinline__ void load_slab(const T* __restrict__ x, T* s,
                                          int H, int W, int C, long long sH,
                                          long long sW, long long sB,
                                          int groups, int slab) {
  const int P = H * W;
  const int b = slab / groups, c0 = (slab - b * groups) * kCB;
  const T* xb = x + b * sB + c0;
  if constexpr (kVec) {
    constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
    constexpr int CH = kCB / E;        // chunks a position
    for (int q = threadIdx.x; q < P * CH; q += blockDim.x) {
      const int p = q / CH, k = q - p * CH;
      const int r = p / W, sc = p - r * W;
      const int left = C - (c0 + k * E);
      const int nb = (left <= 0 ? 0 : left >= E ? E : left) * (int)sizeof(T);
      const T* src = xb + r * sH + sc * sW + k * E;
      cp_async16(s + p * kCB + k * E, nb ? src : x, nb);
    }
  } else {
    for (int q = threadIdx.x; q < P * kCB; q += blockDim.x) {
      const int p = q / kCB, k = q - p * kCB;
      const int r = p / W, sc = p - r * W;
      s[q] = c0 + k < C ? xb[r * sH + sc * sW + k] : from_f32<T>(0.f);
    }
  }
}

// x [H, W, B, C] (strided) -> v [49, tiles, B, C]; a block a slab
// (slab = image * groups + channel group)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, kInMinBlocks)
wino_input_kernel(const T* __restrict__ x, T* __restrict__ v,
                  const __grid_constant__ Mats mt, int H, int W, int th,
                  int tw, int B, int C, long long sH, long long sW,
                  long long sB, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);   // [H*W][kCB]
  load_slab<T, kVec>(x, slab, H, W, C, sH, sW, sB, groups, blockIdx.x);
  if constexpr (kVec) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * kCB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane * kNC, valid = C - (c0 + cl);
  const int tiles = th * tw;
  const size_t plane = (size_t)tiles * B * C;
  for (int t = warp; t < tiles; t += kWarps) {
    const int ti = t / tw, tj = t - ti * tw;
    T* vt = v + ((size_t)t * B + b) * C + c0 + cl;
    forward_tile(
        mt,
        [&](int i, int j, float(&d)[kNC]) {
          const int r = kM * ti + i - 1, s = kM * tj + j - 1;  // -1: the pad
          if (r >= 0 && r < H && s >= 0 && s < W) {
            lds<T>(slab + (r * W + s) * kCB + cl, d);
          } else {
#pragma unroll
            for (int n = 0; n < kNC; ++n) d[n] = 0.f;
          }
        },
        [&](int p, const float(&o)[kNC]) {
          stg<T, kVec>(vt + p * plane, o, valid);
        });
  }
}

// m [49, tiles, B, K] (+ f32 bias [K]) -> y [H, W, B, K]: inverse
// transform, bias, trimmed to H x W; a block a slab (one image, 64
// channels), a warp a tile, a lane two channels, no shared memory
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, kOutMinBlocks)
wino_output_kernel(const T* __restrict__ m, const float* __restrict__ bias,
                   T* __restrict__ y, const __grid_constant__ Mats mt,
                   int H, int W, int th, int tw, int B, int K, int groups) {
  const int g = blockIdx.x % groups, b = blockIdx.x / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = g * kCB + lane * kNC, valid = K - c;
  const int tiles = th * tw;
  const size_t pstride = (size_t)tiles * B * K;
  float bk[kNC];
#pragma unroll
  for (int n = 0; n < kNC; ++n) bk[n] = n < valid ? bias[c + n] : 0.f;
  for (int t = warp; t < tiles; t += kWarps) {
    const int ti = t / tw, tj = t - ti * tw;
    const T* mt_ = m + ((size_t)t * B + b) * K + c;
    float yv[kM][kM][kNC];
    inverse_tile(
        mt,
        [&](int p, float(&o)[kNC]) {
          ldg<T, kVec>(mt_ + p * pstride, o, valid);
        },
        yv);
#pragma unroll
    for (int a = 0; a < kM; ++a)
#pragma unroll
      for (int bb = 0; bb < kM; ++bb) {
        const int oh = kM * ti + a, ow = kM * tj + bb;
        if (oh < H && ow < W) {   // trim the tile overhang
          float o[kNC];
#pragma unroll
          for (int n = 0; n < kNC; ++n) o[n] = yv[a][bb][n] + bk[n];
          stg<T, kVec>(y + (((size_t)oh * W + ow) * B + b) * K + c, o,
                       valid);
        }
      }
  }
}

// m [49, tiles, B, K] (+ bias [K]) -> v [49, tiles, B, K]: inverse
// transform, bias, trim to H x W, SAME re-pad and forward transform, the
// f32 interior in shared memory and never in device memory
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, kMidMinBlocks)
wino_middle_kernel(const T* __restrict__ m, const float* __restrict__ bias,
                   T* __restrict__ v, const __grid_constant__ Mats mt,
                   int H, int W, int th, int tw, int B, int K, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* plane = reinterpret_cast<float*>(smem_raw);   // [H*W][kCB]
  const int g = blockIdx.x % groups, b = blockIdx.x / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane * kNC, c = g * kCB + cl, valid = K - c;
  const int tiles = th * tw;
  const size_t pstride = (size_t)tiles * B * K;
  float bk[kNC];
#pragma unroll
  for (int n = 0; n < kNC; ++n) bk[n] = n < valid ? bias[c + n] : 0.f;
  for (int t = warp; t < tiles; t += kWarps) {
    const int ti = t / tw, tj = t - ti * tw;
    const T* mt_ = m + ((size_t)t * B + b) * K + c;
    float y[kM][kM][kNC];
    inverse_tile(
        mt,
        [&](int p, float(&o)[kNC]) {
          ldg<T, kVec>(mt_ + p * pstride, o, valid);
        },
        y);
#pragma unroll
    for (int a = 0; a < kM; ++a)
#pragma unroll
      for (int bb = 0; bb < kM; ++bb) {
        const int oh = kM * ti + a, ow = kM * tj + bb;
        if (oh < H && ow < W) {   // trim the tile overhang
          *reinterpret_cast<float2*>(plane + (oh * W + ow) * kCB + cl) =
              make_float2(y[a][bb][0] + bk[0], y[a][bb][1] + bk[1]);
        }
      }
  }
  __syncthreads();
  for (int t = warp; t < tiles; t += kWarps) {
    const int ti = t / tw, tj = t - ti * tw;
    T* vt = v + ((size_t)t * B + b) * K + c;
    forward_tile(
        mt,
        [&](int i, int j, float(&d)[kNC]) {
          const int r = kM * ti + i - 1, s = kM * tj + j - 1;  // the pad
          if (r >= 0 && r < H && s >= 0 && s < W) {
            lds<float>(plane + (r * W + s) * kCB + cl, d);
          } else {
#pragma unroll
            for (int n = 0; n < kNC; ++n) d[n] = 0.f;
          }
        },
        [&](int p, const float(&o)[kNC]) {
          stg<T, kVec>(vt + p * pstride, o, valid);
        });
  }
}

// -- launch ----------------------------------------------------------------

// host: B^T (49) then A^T (35); false where a zero sits elsewhere than the
// kernels' masks say
bool make_mats(const float* host, Mats* mt) {
  memcpy(mt->bt, host, sizeof(mt->bt));
  memcpy(mt->at, host + kT * kT, sizeof(mt->at));
  for (int a = 0; a < kT; ++a)
    for (int i = 0; i < kT; ++i)
      if ((mt->bt[a][i] != 0.f) != (bool)((kBTMask >> (a * kT + i)) & 1))
        return false;
  for (int x = 0; x < kM; ++x)
    for (int a = 0; a < kT; ++a)
      if ((mt->at[x][a] != 0.f) != (bool)((kATMask >> (x * kT + a)) & 1))
        return false;
  return true;
}

int tiles_of(int n) { return (n + kM - 1) / kM; }

bool bad_extent(int H, int W, int cols) {
  return H < 1 || W < 1 || cols < 1 || tiles_of(H) > kMaxTiles ||
         tiles_of(W) > kMaxTiles;
}

// raises an instance's dynamic shared-memory limit to what the largest
// extent (15 x 15) needs, once
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
template <typename T, bool kVec>
cudaError_t input_smem_limit() {
  static const cudaError_t err =
      smem_limit(wino_input_kernel<T, kVec>,
                 sizeof(T) * kMaxExtent * kMaxExtent * kCB);
  return err;
}
template <typename T, bool kVec>
cudaError_t middle_smem_limit() {
  static const cudaError_t err =
      smem_limit(wino_middle_kernel<T, kVec>,
                 sizeof(float) * kMaxExtent * kMaxExtent * kCB);
  return err;
}

template <typename T, bool kVec>
int launch_input(const T* x, T* v, const Mats& mt, int H, int W, int B,
                 int C, long long sH, long long sW, long long sB,
                 cudaStream_t st) {
  const cudaError_t attr = input_smem_limit<T, kVec>();
  if (attr != cudaSuccess) return (int)attr;
  const int groups = (C + kCB - 1) / kCB;
  const size_t smem = sizeof(T) * (size_t)H * W * kCB;
  wino_input_kernel<T, kVec><<<groups * B, kWarps * 32, smem, st>>>(
      x, v, mt, H, W, tiles_of(H), tiles_of(W), B, C, sH, sW, sB, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int input(const void* x, void* v, const float* mats, int H, int W, int B,
          int C, long long sH, long long sW, long long sB, void* stream) {
  Mats mt;
  if (bad_extent(H, W, C) || B < 1 || !make_mats(mats, &mt) ||
      (long long)B * ((C + kCB - 1) / kCB) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr long long E = 16 / sizeof(T);
  const bool vec = (uintptr_t)x % 16 == 0 && sH % E == 0 && sW % E == 0 &&
                   sB % E == 0 && C % kNC == 0;
  return vec ? launch_input<T, true>((const T*)x, (T*)v, mt, H, W, B, C, sH,
                                     sW, sB, (cudaStream_t)stream)
             : launch_input<T, false>((const T*)x, (T*)v, mt, H, W, B, C,
                                      sH, sW, sB, (cudaStream_t)stream);
}

template <typename T, bool kVec>
int launch_output(const T* m, const float* bias, T* y, const Mats& mt, int H,
                  int W, int B, int K, cudaStream_t st) {
  const int groups = (K + kCB - 1) / kCB;
  wino_output_kernel<T, kVec><<<groups * B, kWarps * 32, 0, st>>>(
      m, bias, y, mt, H, W, tiles_of(H), tiles_of(W), B, K, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int output(const void* m, const void* bias, void* y, const float* mats,
           int H, int W, int K, int BK, void* stream) {
  Mats mt;
  if (bad_extent(H, W, BK) || K < 1 || BK % K || !make_mats(mats, &mt) ||
      (long long)(BK / K) * ((K + kCB - 1) / kCB) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)m % (kNC * sizeof(T)) == 0 &&
                   (uintptr_t)y % (kNC * sizeof(T)) == 0 && K % kNC == 0;
  return vec ? launch_output<T, true>((const T*)m, (const float*)bias, (T*)y,
                                      mt, H, W, BK / K, K,
                                      (cudaStream_t)stream)
             : launch_output<T, false>((const T*)m, (const float*)bias,
                                       (T*)y, mt, H, W, BK / K, K,
                                       (cudaStream_t)stream);
}

template <typename T, bool kVec>
int launch_middle(const T* m, const float* bias, T* v, const Mats& mt, int H,
                  int W, int B, int K, cudaStream_t st) {
  const cudaError_t attr = middle_smem_limit<T, kVec>();
  if (attr != cudaSuccess) return (int)attr;
  const int groups = (K + kCB - 1) / kCB;
  const size_t smem = sizeof(float) * (size_t)H * W * kCB;
  wino_middle_kernel<T, kVec><<<groups * B, kWarps * 32, smem, st>>>(
      m, bias, v, mt, H, W, tiles_of(H), tiles_of(W), B, K, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int middle(const void* m, const void* bias, void* v, const float* mats,
           int H, int W, int K, int BK, void* stream) {
  Mats mt;
  if (bad_extent(H, W, BK) || K < 1 || BK % K || !make_mats(mats, &mt) ||
      (long long)(BK / K) * ((K + kCB - 1) / kCB) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)m % (kNC * sizeof(T)) == 0 && K % kNC == 0;
  return vec ? launch_middle<T, true>((const T*)m, (const float*)bias, (T*)v,
                                      mt, H, W, BK / K, K,
                                      (cudaStream_t)stream)
             : launch_middle<T, false>((const T*)m, (const float*)bias,
                                       (T*)v, mt, H, W, BK / K, K,
                                       (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int isc_wino_input_f32(const void* x, void* v, const float* mats, int H,
                       int W, int B, int C, long long sH, long long sW,
                       long long sB, void* stream) {
  return input<float>(x, v, mats, H, W, B, C, sH, sW, sB, stream);
}
int isc_wino_input_bf16(const void* x, void* v, const float* mats, int H,
                        int W, int B, int C, long long sH, long long sW,
                        long long sB, void* stream) {
  return input<__nv_bfloat16>(x, v, mats, H, W, B, C, sH, sW, sB, stream);
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

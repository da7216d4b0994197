// Ceil-mode 3x3 / stride-2 / pad-0 max pool of the encoder stem on Hopper.
//
// Replaces the Pallas kernel insenticap_model_tpu/ops/pool_pallas.py
// `_pool_kernel` (:38; wrappers ceil_maxpool_3x3s2_sm :95 and
// ceil_maxpool_3x3s2_nhwc :140): MaxPool2d(3, stride 2, padding 0,
// ceil_mode=True) (reference models/encoder.py:12). For x viewed as
// [B, H, W, C] with channels fastest,
//
//   oh = ceil((H - 3) / 2) + 1,  ow = ceil((W - 3) / 2) + 1
//   y[b, i, j, c] = max over di, dj in 0..2 of x[b, 2i + di, 2j + dj, c],
//                   taps past the bottom/right edge left out (-inf)
//
// Max is exact, so the result equals the plain version bit for bit in
// every dtype.
//
// What bounds it on the H100: bytes. It reads every input value about
// once (the nine taps of neighbouring outputs overlap and hit in L1/L2) and
// writes a quarter as many, with 8 comparisons an output and no other
// arithmetic. At the serving shape, bf16 bs=32 at 448x448, that is 205.5 MB
// in and 51.4 MB out: 0.077 ms at 3.35 TB/s.
//
// The design: one thread owns one output pixel x V channels, V = 16 bytes
// of the dtype (8 bf16, 4 f32), so each of its nine taps is one 16-byte
// load; neighbouring threads take neighbouring channel groups, so a warp's
// loads and stores are contiguous runs. The ceil-mode edge is masked in
// registers (the first tap 2i, 2j is always inside), never padded in
// memory. The kernel takes the input's and the output's batch, row and
// column strides (the channel stride is 1), so the spatial-major form
// [H, W, B, C] is a permuted view that launches the same kernel with no
// transpose. A scalar instance (V = 1) takes channel counts, strides or
// pointers the 16-byte path cannot. A NaN tap makes its output NaN, as
// torch.maximum does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Shape {
  long long total;               // outputs x channel groups
  long long xb, xh, xw;          // input strides, in elements
  long long yb, yh, yw;          // output strides, in elements
  int H, W, oh, ow, groups;      // groups = C / V
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// m = max(m, v) lane by lane; a NaN in either stays
template <typename T, int V>
__device__ __forceinline__ void vmax(Vec<T, V>& m, const Vec<T, V>& v) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float a = to_f32(m.v[k]), b = to_f32(v.v[k]);
    if (b > a || b != b) m.v[k] = v.v[k];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_kernel(const T* __restrict__ x, T* __restrict__ y, Shape s) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= s.total) return;
  const int g = (int)(t % s.groups);
  long long r = t / s.groups;
  const int j = (int)(r % s.ow);
  r /= s.ow;
  const int i = (int)(r % s.oh);
  const long long b = r / s.oh;
  const int r0 = 2 * i, c0 = 2 * j;
  const T* base = x + b * s.xb + r0 * s.xh + c0 * s.xw + (long long)g * V;
  Vec<T, V> m = *reinterpret_cast<const Vec<T, V>*>(base);
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    if (r0 + di >= s.H) break;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      if (c0 + dj >= s.W) break;
      if (di == 0 && dj == 0) continue;
      const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(
          base + di * s.xh + dj * s.xw);
      vmax<T, V>(m, v);
    }
  }
  *reinterpret_cast<Vec<T, V>*>(y + b * s.yb + i * s.yh + j * s.yw +
                                (long long)g * V) = m;
}

int out_extent(int n) { return n >= 2 ? (n - 2) / 2 + 1 : 0; }

template <typename T>
int launch(const void* x, void* y, int B, int H, int W, int C,
           long long xb, long long xh, long long xw, long long yb,
           long long yh, long long yw, int vec, void* stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (B < 1 || H < 2 || W < 2 || C < 1 || (vec != 1 && vec != kVec) ||
      C % vec)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.H = H;
  s.W = W;
  s.oh = out_extent(H);
  s.ow = out_extent(W);
  s.groups = C / vec;
  s.total = (long long)B * s.oh * s.ow * s.groups;
  s.xb = xb;
  s.xh = xh;
  s.xw = xw;
  s.yb = yb;
  s.yh = yh;
  s.yw = yw;
  const long long blocks = (s.total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec == kVec)
    maxpool_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>((const T*)x, (T*)y, s);
  else
    maxpool_kernel<T, 1><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>((const T*)x, (T*)y, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_maxpool_f32(const void* x, void* y, int B, int H, int W, int C,
                    long long xb, long long xh, long long xw, long long yb,
                    long long yh, long long yw, int vec, void* stream) {
  return launch<float>(x, y, B, H, W, C, xb, xh, xw, yb, yh, yw, vec,
                       stream);
}

int isc_maxpool_bf16(const void* x, void* y, int B, int H, int W, int C,
                     long long xb, long long xh, long long xw, long long yb,
                     long long yh, long long yw, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, y, B, H, W, C, xb, xh, xw, yb, yh, yw,
                               vec, stream);
}

}  // extern "C"

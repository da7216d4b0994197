// Beam-shared additive content attention (v1, v2 and over int8 storage)
// for beam decode on Hopper.
//
// Replaces the Pallas kernels insenticap_model_tpu/ops/fused_attention.py:27
// `_kernel` (v1) and :51 `_kernel_v2` (v2), and the int8 study's
// tools/bench_int8.py:283 `_kernel_i8` (its pallas_call at :309). For every
// image of the batch and each of its B beams:
//
//   q[k]    = h[img*B + k] @ W_h2att^T + b_h2att            (f32 accumulate)
//   e[k, n] = sum_j alpha[j] * tanh(p_att[n, j] + q[k, j])  (alpha's bias
//             dropped: it shifts every logit equally and cancels in softmax)
//   w[k]    = softmax_n(e[k])                                (f32)
//   out[k]  = sum_n w[k, n] * att[n]                         (att's dtype)
//
// v2 is the same function but for one rounding: each softmax weight is
// rounded to att's dtype before the weighted sum (kRoundW; in f32 nothing
// changes, so isc_beam_att_v2_f32 runs v1's instance). The int8 variant
// stores att and p_att as int8 with one f32 scale per (image, channel),
// p_att[n, j] = p_att_q[n, j] * p_att_s[j] and att[n, f] = att_q[n, f] *
// att_s[f]; h, W, the bias and alpha are bf16 and so is the output.
//
// What bounds it on the H100, at serving width (bs=384, N=196, Ah=Fe=512,
// B=3, bf16): att + p_att are 384*196*1024*2 B = 154 MB, read once for all
// B beams: 46.9 us at 3.35 TB/s. Beside the bytes there are 115.6 M tanh:
// with tanhf (about two special-function (MUFU) operations each) some
// 55-60 us, with tanh.approx.f32 (one MUFU op, 16 a clock an SM) 27.6 us
// at 1.98 GHz. The products are small beside that: the query product is
// [1152,512]x[512,512], the weighted sum 115.6 M FMAs. In int8 the bytes
// halve, 81.5 MB with the scales: 24.3 us, so there the tanh bound the
// kernel (27.6 us against 24.3 at one MUFU operation a tanh), not the
// bytes.
//
// The design is two launches on one stream:
//  1. query_*_kernel computes Q = h @ W^T + b for all bs*B rows into an f32
//     scratch [bs*B, Ah] (allocated by the wrapper): for bf16 (v1, v2 and
//     int8) 64 x 64 block tiles on the tensor cores (mma.sync m16n8k16, f32
//     accumulate; h and W staged through shared memory by 16-byte cp.async,
//     4 stages of K 32), for f32 32 x 64 tiles on FFMA (no TF32: it would
//     change the function). W crosses L2 once a 64-row block (18 times at
//     bs=384), not once an image (384 times). At bs=384 it takes some 10 us
//     for 0.6 GFLOP, about as long at a third of the rows: likely the memory
//     latency of 16 K stages, three in flight (the attention's stream
//     passes through L2 between calls, so W is likely not there).
//  2. beam_att_kernel<T, B, kFast, kRoundW> and beam_att_i8_kernel<B,
//     kFast>, one 256-thread block an image, one instance per beam size
//     1..8 so that the per-beam sums stay in registers. The image's p_att
//     rows, then its att rows, stream through a 3-stage cp.async ring
//     (Ring) of 16-byte copies, 16 KB a stage at 512 wide: 16 positions for
//     bf16, 8 for f32, 32 for int8; the first att stages are started before
//     the softmax runs. Logits: a lane owns 8 channels (one 16-byte segment
//     for bf16, two for f32, 8 bytes of the stage for int8) for the whole
//     image, with their B query values and alpha (and for int8 the p_att
//     scales) in registers; a warp takes one position at a time and reduces
//     the B partial logits with shuffles (a position spans ceil(Ah/256)
//     warps, their partials summed in the softmax). Softmax (softmax_beams):
//     one warp per beam, f32. Weighted sum: a thread owns 8 features and a
//     slice of the positions, with B x 8 f32 accumulators; the slices are
//     summed through shared memory (the ring's space) at the end
//     (gather_slices) and the output is written with 16-byte stores; the
//     int8 variant applies att's scale once a feature after the sum,
//     out = s_f * sum_n w * att_q (another f32 order of the same sum).
//  tanh: the f32 instance keeps tanhf; the bf16 instance takes
//  tanh.approx.f32 (isc_beam_att_bf16) or tanhf (isc_beam_att_bf16_tanhf,
//  kept to measure the approximation's error); v2 in bf16
//  (isc_beam_att_v2_bf16) takes tanh.approx.f32 as v1 does. The int8
//  instance takes 1 - 2 / (1 + e^2p e^2q) with e^2p shared by the beams
//  (isc_beam_att_i8_bf16, see beam_att_i8_kernel) or tanhf
//  (isc_beam_att_i8_bf16_tanhf): tanh.approx.f32 misses the int8 kernel's
//  check of one bf16 ulp.
//
// What this does about the first versions' faults (v1's first port and the
// int8 kernel's, which had the same ones): (1) every block recomputed
// the query product, reading all of W (512 KB), 201 MB of L2 reads a call:
// now one tiled product; (2) the logits pass read p_att with nothing else
// in flight: now 16-byte copies, two stages ahead; (3) the weighted sum
// walked the positions serially with no copy ahead (int8: B x 16
// accumulators a thread, spilling at large B): now the ring, B x 8
// accumulators, 4 position slices in parallel; (4) the dynamic
// shared-memory limit was set on every launch: now once an instance. And
// for int8: (5) tanhf took two MUFU operations a tanh, 2B a value: the
// default entry takes 1 + B (e^2p once for the B beams, one reciprocal a
// beam), as accurate; (6) every int8 value went through the int-to-float
// convert, 77 M a call at 16 a clock an SM, the MUFU's rate, competing
// with the tanh for it: now a byte permute (prmt) builds a float of
// exponent 2^23 from the byte offset by 128, and one FADD takes 2^23 + 128
// away, exactly, on the integer and FMA pipes (Seg<int8_t>::load).
//
// Widths: Ah and Fe % 8 (bf16), % 4 (f32) or % 16 (int8), all at most
// 2048; H % 16 (bf16), % 4 (f32) or % 8 (int8, whose query product stages
// H in zero-filled 8-element segments); 16-byte aligned operands; any N
// and bs. The wrappers (ops/fused_attention.py, ops/fused_attention_i8.py)
// check them and raise otherwise.
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

// the instances a launch picks from, one a beam size 1..kMaxBeam
#define ISC_BEAM_CASES(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)

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

// ex2.approx (2^x, about 2 ulp) and rcp.approx (1 / x, 1 ulp), one
// special-function (MUFU) operation each; rcp(inf) = 0
__device__ __forceinline__ float ex2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// A segment of a row as f32, and back: 8 bf16 or 4 f32 (16 bytes), or
// 8 int8 (8 bytes: a lane's channels; kVec elements)
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
template <> struct Seg<int8_t> {
  static constexpr int kVec = 8;
  static constexpr int kChunk = 32;
  // Without the int-to-float convert (16 a clock an SM, the MUFU's rate):
  // byte b ^ 0x80 = b + 128 in [0, 255] becomes the low mantissa byte of
  // 0x4b0000xx = 2^23 + b + 128 (prmt), and one FADD of -(2^23 + 128)
  // leaves b, exactly. The offset is not folded into a later scale
  // multiply: fma(f, s, -(2^23 + 128) s) would cancel catastrophically.
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t f;
      asm("prmt.b32 %0, %1, %2, %3;"
          : "=r"(f)
          : "r"(w[i / 4]), "r"(0x4b000000u), "r"(0x7440u | (i % 4)));
      out[i] = __uint_as_float(f) - 8388736.f;
    }
  }
};

// A lane's 8 channels of a row of width W: kLaneCh / kVec segments, at
// segment indices u + s * units(W), so that neighbouring lanes read
// neighbouring segments (no bank conflicts) for f32 as for bf16 and int8
template <typename T>
__host__ __device__ __forceinline__ int units(int W) {
  constexpr int kSeg = kLaneCh / Seg<T>::kVec;
  return (W / Seg<T>::kVec + kSeg - 1) / kSeg;
}

// Shared memory of an attention kernel: the ring (reused for the slices'
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

// The image's two row streams through the kStages-stage cp.async ring:
// tile i < nC holds positions [i*CH, ..) of `first` (rows of W1 elements,
// p_att), tile nC + c the same positions of `second` (W2, att). Every
// thread issues its share of a tile's 16-byte copies.
template <typename T>
struct Ring {
  static constexpr int CH = Seg<T>::kChunk;
  const T* first;
  const T* second;
  int W1, W2, N, nC;
  size_t stage;
  unsigned char* smem;

  __device__ __forceinline__ void copy(int i, int tid) const {
    constexpr int V = 16 / sizeof(T);   // elements a copy
    if (i < 2 * nC) {
      const bool is1 = i < nC;
      const int c = is1 ? i : i - nC, W = is1 ? W1 : W2;
      const int rows = min(CH, N - c * CH);
      const T* src = (is1 ? first : second) + (size_t)c * CH * W;
      unsigned char* dst = smem + (i % kStages) * stage;
      const int pieces = rows * W / V;
      for (int x = tid; x < pieces; x += kThreads)
        cp_async16(dst + 16 * x, src + (size_t)x * V);
    }
    cp_async_commit();   // an empty group past the end keeps the count
  }
  __device__ __forceinline__ void start(int tid) const {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) copy(i, tid);
  }
  // tile i, landed for every thread; the copy kStages - 1 tiles on starts
  __device__ __forceinline__ const T* arrive(int i, int tid) const {
    copy(i + kStages - 1, tid);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    return reinterpret_cast<const T*>(smem + (i % kStages) * stage);
  }
};

// v2's rounding: a softmax weight rounded to att's dtype (nothing in f32)
template <typename T, bool kRoundW>
__device__ __forceinline__ float round_w(float x) {
  if constexpr (kRoundW && sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// softmax over n, one warp per beam: the logits, summed over the G warp
// groups' partials part [G][B][N], become the weights wts [B][N]
template <typename T, bool kRoundW>
__device__ __forceinline__ void softmax_beams(const float* part, float* wts,
                                              int G, int B, int N, int warp,
                                              int lane) {
  if (warp >= B) return;
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
  for (int n = lane; n < N; n += 32) e[n] = round_w<T, kRoundW>(e[n] / sum);
}

// The weighted sum's position slices meet through shared memory (the
// ring's space, idle once every copy has landed), [Q-1][B][8][Uf]; slice 0
// adds them to its own in order
template <int B>
__device__ __forceinline__ void gather_slices(float (&acc)[B][kLaneCh],
                                              unsigned char* smem, int sl,
                                              int Q, int Uf, int fb) {
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
  }
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
// col-major B operand as it lies. Needs H % 8 == 0: K is staged in 8-element
// segments, those past H filled with zeros.
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
  const Ring<T> ring{p_att + (size_t)img * N * Ah, att + (size_t)img * N * Fe,
                     Ah, Fe, N, nC, L.stage, smem};
  ring.start(tid);

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
    const T* st = ring.arrive(i, tid);
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

  // softmax over n; the att copies are in flight
  softmax_beams<T, kRoundW>(part, wts, G, B, N, warp, lane);
  __syncthreads();

  // weighted sum: thread = (feature unit fb, position slice sl)
  const int fb = tid % Uf, sl = tid / Uf;
  float acc[B][kLaneCh];
#pragma unroll
  for (int k = 0; k < B; ++k)
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) acc[k][j] = 0.f;
  for (int i = nC; i < 2 * nC; ++i) {
    const T* st = ring.arrive(i, tid);
    const int c = i - nC;
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

  gather_slices<B>(acc, smem, sl, Q, Uf, fb);
  if (sl == 0) {
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

// The same over int8 storage: p_att and att stream through the ring at one
// byte a value (32 positions a 16 KB stage at 512 wide), a lane's 8
// channels as one 8-byte read of the stage, converted by Seg<int8_t>. The
// lane keeps its channels' B queries, alpha and p_att scales in registers
// (at B = 8 the queries alone are 64), so p = p_att_q * p_att_s costs one
// multiply a value; att's scale is applied once a feature after the sum.
//
// tanh: kFast false takes tanhf (two MUFU operations and a dozen others a
// tanh). kFast true takes tanh(p + q) = 1 - 2 r, r = 1 / (1 + e^2p e^2q):
// e^2q is a lane's B x 8 registers, made once an image, e^2p one ex2 a
// value for all B beams, then one FMA, one rcp and one FMA a beam, with the
// logit summed as A - 2 sum_j alpha_j r_j (A: the lane's sum of alpha).
// That is 1 + B MUFU operations a value against tanhf's 2B, within f32
// rounding of tanh: tanh.approx.f32 (B operations) errs by up to 2^-11
// relative, which summed over 512 channels moved the output by up to 9 bf16
// ulps on the card tests. e^2p e^2q stays finite and nonzero where |2p
// log2 e| and |2q log2 e| are at most 62; a block whose image's scales or
// queries may pass that (|p| or |q| above 21.5) takes r = 1 / (1 + 2^(2 (p
// + q) log2 e)) a beam instead, two MUFU operations, exact at any
// magnitude (2^x overflows to inf and r to 0, or underflows and r is 1).
template <int B, bool kFast>
__global__ void __launch_bounds__(kThreads, B <= 4 ? 3 : 2)
beam_att_i8_kernel(const float* __restrict__ q, const bf16* __restrict__ alpha,
                   const int8_t* __restrict__ p_att_q,
                   const float* __restrict__ p_att_s,
                   const int8_t* __restrict__ att_q,
                   const float* __restrict__ att_s, bf16* __restrict__ out,
                   int Ah, int N, int Fe) {
  constexpr int CH = Seg<int8_t>::kChunk;
  constexpr float kTwoLog2e = 2.885390081777927f;   // e^2x = 2^(x kTwoLog2e)
  constexpr float kMaxArg = 62.f;                   // 2^±62 products: normal
  static_assert(Seg<int8_t>::kVec == kLaneCh, "a lane's channels: one read");
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<int8_t>(B, Ah, N, Fe);
  float* part = reinterpret_cast<float*>(smem + L.region0);   // [G][B][N]
  float* wts = part + L.part;                                  // [B][N]

  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ua = units<int8_t>(Ah), Uf = units<int8_t>(Fe);
  const int G = L.G, P = kWarps / G, Q = L.Q;
  const int nC = (N + CH - 1) / CH;
  const Ring<int8_t> ring{p_att_q + (size_t)img * N * Ah,
                          att_q + (size_t)img * N * Fe, Ah, Fe, N, nC,
                          L.stage, smem};
  ring.start(tid);

  // logits: warp = (group grp of 32 lanes along the channels, position
  // lane pl); lane's 8 channels u*8 .. u*8+7 with their B queries, alpha
  // and p_att scales (read once, element by element)
  const int grp = warp % G, pl = warp / G;
  const int u = grp * 32 + lane;
  const bool own = u < Ua;
  float qr[B][kLaneCh], ar[kLaneCh], sr[kLaneCh];
  float A = 0.f;
#pragma unroll
  for (int j = 0; j < kLaneCh; ++j) {
    ar[j] = own ? __bfloat162float(alpha[u * kLaneCh + j]) : 0.f;
    sr[j] = own ? p_att_s[(size_t)img * Ah + u * kLaneCh + j] : 0.f;
    A += ar[j];
  }
#pragma unroll
  for (int k = 0; k < B; ++k) {
    if (own) {
      const float* qk = q + ((size_t)img * B + k) * Ah + u * kLaneCh;
      Seg<float>::load(qk, qr[k]);
      Seg<float>::load(qk + 4, qr[k] + 4);
    } else {
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) qr[k][j] = 0.f;
    }
  }
  // kFast: the factored form where the whole block's |p| <= 127 s and |q|
  // keep 2^±62; the exponents are scaled by 2 log2 e once
  bool factored = false;
  if constexpr (kFast) {
    bool small = true;
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) {
      sr[j] *= kTwoLog2e;
      small = small && 127.f * sr[j] <= kMaxArg;
#pragma unroll
      for (int k = 0; k < B; ++k) {
        qr[k][j] *= kTwoLog2e;
        small = small && fabsf(qr[k][j]) <= kMaxArg;
      }
    }
    factored = __syncthreads_and(small);
    if (factored) {
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j)
#pragma unroll
        for (int k = 0; k < B; ++k) qr[k][j] = ex2_(qr[k][j]);
    }
  }

  for (int i = 0; i < nC; ++i) {
    const int8_t* st = ring.arrive(i, tid);
    const int rows = min(CH, N - i * CH);
    if (pl < P) {
      for (int r = pl; r < rows; r += P) {
        float acc[B];
#pragma unroll
        for (int k = 0; k < B; ++k) acc[k] = 0.f;
        if (own) {
          float p[kLaneCh];
          Seg<int8_t>::load(st + (size_t)r * Ah + u * kLaneCh, p);
          if constexpr (kFast) {
            // acc = sum_j alpha_j r_j; the logit is A - 2 acc
            if (factored) {
#pragma unroll
              for (int j = 0; j < kLaneCh; ++j) {
                const float ep = ex2_(p[j] * sr[j]);
#pragma unroll
                for (int k = 0; k < B; ++k)
                  acc[k] = fmaf(ar[j], rcp_(fmaf(ep, qr[k][j], 1.f)),
                                acc[k]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < kLaneCh; ++j)
#pragma unroll
                for (int k = 0; k < B; ++k)
                  acc[k] = fmaf(
                      ar[j], rcp_(1.f + ex2_(fmaf(p[j], sr[j], qr[k][j]))),
                      acc[k]);
            }
#pragma unroll
            for (int k = 0; k < B; ++k) acc[k] = fmaf(-2.f, acc[k], A);
          } else {
#pragma unroll
            for (int j = 0; j < kLaneCh; ++j) {
              const float pv = p[j] * sr[j];
#pragma unroll
              for (int k = 0; k < B; ++k)
                acc[k] = fmaf(ar[j], tanhf(pv + qr[k][j]), acc[k]);
            }
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

  // softmax over n; the att copies are in flight
  softmax_beams<float, false>(part, wts, G, B, N, warp, lane);
  __syncthreads();

  // weighted sum of att_q: thread = (feature unit fb, position slice sl)
  const int fb = tid % Uf, sl = tid / Uf;
  float acc[B][kLaneCh];
#pragma unroll
  for (int k = 0; k < B; ++k)
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) acc[k][j] = 0.f;
  for (int i = nC; i < 2 * nC; ++i) {
    const int8_t* st = ring.arrive(i, tid);
    const int c = i - nC;
    const int rows = min(CH, N - c * CH);
    if (sl < Q) {
      for (int r = sl; r < rows; r += Q) {
        float wk[B];
#pragma unroll
        for (int k = 0; k < B; ++k) wk[k] = wts[(size_t)k * N + c * CH + r];
        float a[kLaneCh];
        Seg<int8_t>::load(st + (size_t)r * Fe + fb * kLaneCh, a);
#pragma unroll
        for (int k = 0; k < B; ++k)
#pragma unroll
          for (int j = 0; j < kLaneCh; ++j)
            acc[k][j] = fmaf(wk[k], a[j], acc[k][j]);
      }
    }
    __syncthreads();
  }

  gather_slices<B>(acc, smem, sl, Q, Uf, fb);
  if (sl == 0) {
    float s[kLaneCh];
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j)
      s[j] = att_s[(size_t)img * Fe + fb * kLaneCh + j];
#pragma unroll
    for (int k = 0; k < B; ++k) {
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) acc[k][j] *= s[j];
      Seg<bf16>::store(out + ((size_t)img * B + k) * Fe + fb * kLaneCh,
                       acc[k]);
    }
  }
}

// -- launch ----------------------------------------------------------------

// raises a kernel's dynamic shared-memory limit to the device's opt-in
// maximum; returns that maximum, or minus a CUDA error code
template <typename Kernel>
int raise_smem_limit(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err == cudaSuccess ? optin : -(int)err;
}

// the limit of each instance, raised once
template <typename T, int B, bool kFast, bool kRoundW>
int smem_limit() {
  static const int limit =
      raise_smem_limit(beam_att_kernel<T, B, kFast, kRoundW>);
  return limit;
}

template <int B, bool kFast>
int smem_limit_i8() {
  static const int limit = raise_smem_limit(beam_att_i8_kernel<B, kFast>);
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
    ISC_BEAM_CASES(ISC_ATT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ISC_ATT_CASE
}

template <int B, bool kFast>
int launch_i8_b(const void* h, const void* w, const void* b,
                const void* alpha, const void* p_att_q, const void* p_att_s,
                const void* att_q, const void* att_s, void* out, void* q,
                int bs, int H, int Ah, int N, int Fe, void* stream) {
  const size_t smem = layout<int8_t>(B, Ah, N, Fe).total;
  const int limit = smem_limit_i8<B, kFast>();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_query((const bf16*)h, (const bf16*)w,
                               (const bf16*)b, (float*)q, bs * B, H, Ah, s);
  if (err != 0) return err;
  beam_att_i8_kernel<B, kFast><<<bs, kThreads, smem, s>>>(
      (const float*)q, (const bf16*)alpha, (const int8_t*)p_att_q,
      (const float*)p_att_s, (const int8_t*)att_q, (const float*)att_s,
      (bf16*)out, Ah, N, Fe);
  return (int)cudaGetLastError();
}

template <bool kFast>
int launch_i8(const void* h, const void* w, const void* b, const void* alpha,
              const void* p_att_q, const void* p_att_s, const void* att_q,
              const void* att_s, void* out, void* q, int bs, int B, int H,
              int Ah, int N, int Fe, void* stream) {
  constexpr int kW = 16;   // a 16-byte copy of int8
  if (bs < 1 || N < 1 || H < 8 || H % 8 || Ah < kW || Ah % kW || Fe < kW ||
      Fe % kW || Ah > kMaxWidth || Fe > kMaxWidth)
    return (int)cudaErrorInvalidValue;
#define ISC_I8_CASE(BB)                                                    \
  case BB:                                                                 \
    return launch_i8_b<BB, kFast>(h, w, b, alpha, p_att_q, p_att_s, att_q, \
                                  att_s, out, q, bs, H, Ah, N, Fe, stream);
  switch (B) {
    ISC_BEAM_CASES(ISC_I8_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ISC_I8_CASE
}

static_assert(kMaxBeam <= kWarps, "softmax runs one warp per beam");
static_assert(kMaxBeam == 8, "ISC_BEAM_CASES lists the beams 1..8");

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

// int8 storage: h, W, b and alpha bf16; p_att_q [bs, N, Ah] and att_q
// [bs, N, Fe] int8 with f32 scales p_att_s [bs, Ah] and att_s [bs, Fe];
// out bf16 [bs*B, Fe]; q the f32 scratch [bs*B, Ah] of the query product
int isc_beam_att_i8_bf16(const void* h, const void* w, const void* b,
                         const void* alpha, const void* p_att_q,
                         const void* p_att_s, const void* att_q,
                         const void* att_s, void* out, void* q, int bs, int B,
                         int H, int Ah, int N, int Fe, void* stream) {
  return launch_i8<true>(h, w, b, alpha, p_att_q, p_att_s, att_q, att_s, out,
                         q, bs, B, H, Ah, N, Fe, stream);
}

int isc_beam_att_i8_bf16_tanhf(const void* h, const void* w, const void* b,
                               const void* alpha, const void* p_att_q,
                               const void* p_att_s, const void* att_q,
                               const void* att_s, void* out, void* q, int bs,
                               int B, int H, int Ah, int N, int Fe,
                               void* stream) {
  return launch_i8<false>(h, w, b, alpha, p_att_q, p_att_s, att_q, att_s, out,
                          q, bs, B, H, Ah, N, Fe, stream);
}

}  // extern "C"

// Row-tiled matrix product with the weight resident in L2, on Hopper.
//
// Replaces the Pallas kernel tools/bench_megacell.py `_mm_kernel` (the
// pallas_call of `pallas_tiled_mm`, :76-96): out = x @ w, x [rows, K] and
// w [K, N] bf16, f32 accumulation, out in bf16, with the rows cut into
// tiles of `tile_rows` (24, 48 or 96 in the decode-cell study: tile_b
// images x 3 beams). On the TPU the whole weight block stays in VMEM across
// the row grid. On the H100 no block's 227 KB of shared memory holds w
// (6 MiB for the att_lstm product), so here "resident" means resident in
// the 50 MB L2: every row tile streams all of w, and after the first tiles
// those reads hit L2.
//
// What bounds it: at [1152, 1536] x [1536, 2048] (att_lstm) 7.25 GFLOP,
// 7.3 us at 989 TFLOP/s, against 14.5 MB, 4.3 us at 3.35 TB/s: operations,
// narrowly. The study's question is what small row tiles cost, so the
// design keeps them: grid (rows / tile_rows, N / 128); each block of 4 warps
// streams K in chunks of 64 through shared memory, x[tile_rows, 64] and
// w[64, 128], double-buffered with cp.async; ldmatrix (.trans for the
// [K, N] operand) feeds mma.sync m16n8k16 (bf16 in, f32 accumulate), each
// warp 32 columns of the tile. A tile of 24 rows is padded to 32 in shared
// memory with zero rows, whose products are computed and thrown away (the
// waste the study measures), and the store is masked to the real rows. The
// epilogue rounds to bf16. Not done: wgmma, TMA, a persistent schedule.
// Needs K % 8 == 0 and N % 8 == 0 (16-byte rows); the K and N edges are
// zero-filled. tile_rows is at most 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 128;          // columns of a block
constexpr int kBK = 64;           // K of a stage
constexpr int kAStride = kBK + 8;     // bf16 elements a row of the A stage
constexpr int kBStride = kBN + 8;     // and of the B stage (conflict-free)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT m16 tiles of rows (the tile padded to 16 * MT rows)
template <int MT>
__global__ void __launch_bounds__(kThreads)
tiled_mm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int tile_rows, int K, int N) {
  constexpr int kMp = 16 * MT;
  extern __shared__ __align__(16) bf16 smem[];
  bf16* as = smem;                          // [2][kMp][kAStride]
  bf16* bs = smem + 2 * kMp * kAStride;     // [2][kBK][kBStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * tile_rows;
  const int col0 = blockIdx.y * kBN;
  const bf16* xt = x + (size_t)row0 * K;

  // the padded rows stay zero in both stages
  for (int i = tid; i < 2 * (kMp - tile_rows) * kAStride; i += kThreads) {
    const int st = i / ((kMp - tile_rows) * kAStride);
    const int r = i % ((kMp - tile_rows) * kAStride);
    as[st * kMp * kAStride + tile_rows * kAStride + r] =
        __float2bfloat16(0.f);
  }

  auto load_stage = [&](int st, int k0) {
    bf16* a = as + st * kMp * kAStride;
    for (int i = tid; i < tile_rows * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = k0 + c < K;
      cp_async16(a + r * kAStride + c, ok ? xt + (size_t)r * K + k0 + c : x,
                 ok ? 16 : 0);
    }
    bf16* b = bs + st * kBK * kBStride;
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < K && col0 + c < N;
      cp_async16(b + r * kBStride + c,
                 ok ? w + (size_t)(k0 + r) * N + col0 + c : w, ok ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  const int kt_n = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) {
      load_stage((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = as + (kt & 1) * kMp * kAStride;
    const bf16* b = bs + (kt & 1) * kBK * kBStride;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // B: two x4.trans loads give the k16 x n8 fragments of 4 n8 tiles
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int mi = lane >> 3, r = lane & 7;
        const bf16* src = b + (ks + r + (mi & 1) * 8) * kBStride +
                          warp * 32 + p * 16 + (mi >> 1) * 8;
        uint32_t t[4];
        ldmatrix_x4_trans(t, src);
        bf[2 * p][0] = t[0];
        bf[2 * p][1] = t[1];
        bf[2 * p + 1][0] = t[2];
        bf[2 * p + 1][1] = t[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];
        ldmatrix_x4(af, a + (m * 16 + (lane & 15)) * kAStride + ks +
                            (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();                  // the stage is consumed
  }

  // epilogue: round to bf16, masked to the real rows and columns
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + warp * 32 + j * 8 + 2 * t;
      if (c >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + g + half * 8;
        if (r >= tile_rows) continue;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[m][j][2 * half],
                                                 acc[m][j][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N +
                                           c) = v;
      }
    }
  }
}

template <int MT>
int launch_mt(const void* x, const void* w, void* out, int rows,
              int tile_rows, int K, int N, void* stream) {
  constexpr size_t smem =
      sizeof(bf16) * 2 * ((size_t)16 * MT * kAStride + (size_t)kBK * kBStride);
  // the dynamic shared-memory limit is raised once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiled_mm_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(rows / tile_rows, (N + kBN - 1) / kBN);
  tiled_mm_kernel<MT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)out, tile_rows, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int isc_tiled_mm_bf16(const void* x, const void* w, void* out, int rows,
                      int tile_rows, int K, int N, void* stream) {
  if (rows < 1 || tile_rows < 1 || tile_rows > 128 || rows % tile_rows ||
      K < 8 || K % 8 || N < 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  switch ((tile_rows + 15) / 16) {
    case 1: return launch_mt<1>(x, w, out, rows, tile_rows, K, N, stream);
    case 2: return launch_mt<2>(x, w, out, rows, tile_rows, K, N, stream);
    case 3: return launch_mt<3>(x, w, out, rows, tile_rows, K, N, stream);
    case 4: return launch_mt<4>(x, w, out, rows, tile_rows, K, N, stream);
    case 5: return launch_mt<5>(x, w, out, rows, tile_rows, K, N, stream);
    case 6: return launch_mt<6>(x, w, out, rows, tile_rows, K, N, stream);
    case 7: return launch_mt<7>(x, w, out, rows, tile_rows, K, N, stream);
    case 8: return launch_mt<8>(x, w, out, rows, tile_rows, K, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

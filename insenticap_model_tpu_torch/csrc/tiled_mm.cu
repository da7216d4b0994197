// Row-tiled matrix product with the weight resident in shared memory, on
// Hopper.
//
// Replaces the Pallas kernel tools/bench_megacell.py `_mm_kernel` (the
// pallas_call of `pallas_tiled_mm`, :76-96): out = x @ w, x [rows, K] and
// w [K, N] bf16, f32 accumulation, out in bf16, with the rows cut into
// tiles of `tile_rows` (24, 48 or 96 in the decode-cell study: tile_b
// images x 3 beams). On the TPU the whole weight block stays in VMEM across
// the row grid (its index_map is constant).
//
// What bounds it: at [1152, 1536] x [1536, 2048] (att_lstm) 7.25 GFLOP,
// 7.3 us at 989 TFLOP/s, against 14.5 MB, 4.3 us at 3.35 TB/s: operations,
// narrowly. But a design that streams all of w through every row tile (the
// first one here) moves w across the L2 once a tile, 302 MB at tile 24, and
// that traffic, not the tensor cores, sets its time. So:
//
// - A slab of w a CTA, resident in shared memory. A CTA owns 64 columns of
//   w for the whole K (192 KB for att_lstm, 128 KB for lang_lstm), loads
//   them once, panel by panel alongside its first row tile's x, and keeps
//   them while it walks a contiguous group of row tiles. The grid is
//   (N / 64 slabs) x (row groups), the groups chosen by the wrapper to fill
//   one wave (32 x 4 = 128 CTAs at N = 2048 on 132 SMs), so w leaves device
//   memory once and crosses the L2 4 times, not 48.
// - x through a ring of TMA copies. A stage is a few 64-wide K panels of
//   up to 48 rows of a tile (a tile of more rows takes two stages for the
//   same panels), [panels][rows][64] bf16, at least 6 KB (narrow) or 12 KB
//   (wide) of x, K padded with zero panels to whole stages. Each panel is
//   one bulk tensor copy in the 128-byte swizzle that wgmma reads; rows
//   and K past x's edge arrive as zeros. One thread of a producer warp
//   issues the copies; a full mbarrier a slot counts a stage's bytes in and
//   an empty one counts the consumer warps out, so a slot is refilled as
//   soon as the product group after its stage is issued and its own group
//   has completed. The wrapper's plan picks wide stages where the ring
//   beside the slab holds four groups' of them, else narrow ones, and as
//   many slots as fit (up to 16); this file checks the plan against the
//   budget. A stage of several panels shares its barrier waits among
//   several panels' products: with one 3 KB panel a stage at 24 rows the
//   waits, not the copies or the tensor cores, set the time.
// - wgmma with the rows as N ("swap AB"), by one consumer warpgroup:
//   out^T = w_slab^T x_tile^T as wgmma.mma_async m64 x n x k16, bf16 in,
//   f32 accumulate (bf16 products are exact in f32: the plain version's
//   function). A is the slab, read MN-major through the descriptor's
//   transpose bit (its K rows are 64 contiguous columns of w, 128 bytes, as
//   w lies in memory); B is the x stage, K-major. n is the tile's rows
//   rounded up to one of kTileNs, so tiles of 24, 48 and 96 rows pad
//   nothing and a tile of 5 takes n8; the rows past the tile are multiplied
//   and never stored. A stage's rows keep 2 or 4 accumulator sets that take
//   a panel's k16 steps in turn, so the short products of few rows do not
//   wait on each other's latency; they are summed, in f32, at the tile's
//   end.
// - The epilogue rounds to bf16 once, writes the tile transposed back into
//   the first panel of its last stages (n x 64 x 2 bytes, the tile's
//   output), and stores 16-byte pieces of output rows.
//
// Where the slab does not fit beside two groups' stages (K > 1536 or so),
// the same kernel streams w instead (kResident false, always in wide
// stages, two groups' of which fit at every n): a tile's first row stage
// carries its panels of w beside x's, and every tile reads the slab again,
// as the first design did. The wrapper's `plan` (ops/tiled_mm.py)
// picks the path, the stage width, the ring depth and the row groups;
// tests/test_torch_tiled_mm_source.py holds this file's constants against
// it. The tensor maps of the last few operands are kept (a map is a
// function of the address and the shape), so a call repeated on the same
// x and w encodes none.
//
// Needs K % 8 == 0 and N % 8 == 0 (16-byte row strides for the tensor
// maps) and tile_rows <= 128; the K and N edges are zero-filled by the
// copies and masked in the epilogue.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 128;        // one warpgroup: the product
constexpr int kThreads = kConsumers + 32;   // and one warp: the copies
constexpr int kSlabCols = 64;          // columns of w a CTA: the wgmma M
constexpr int kPanelK = 64;            // K a panel: one 128-byte swizzle row
constexpr int kRowBytes = kPanelK * 2;
constexpr int kWPanelBytes = kPanelK * kSlabCols * 2;   // 8 KB
constexpr int kSmemBudget = 232448;    // a block's shared memory, H100
constexpr int kAlignPad = 1024;        // aligns the buffers to 1 KB
constexpr int kMinStages = 2;
constexpr int kMaxStages = 16;
constexpr int kBarrierBytes = 2 * 8 * 16;   // full and empty, 16 slots
constexpr int kMaxTileRows = 128;
constexpr int kMaxStageRows = 48;      // a tile of more takes two stages
// bytes of x a stage, at least: a narrow stage, or a wide one where the
// ring still holds enough of them (the wrapper's plan picks)
constexpr int kNarrowStage = 6144;
constexpr int kWideStage = 12288;
// the wgmma n a tile takes: the first of these that holds its rows
constexpr int kTileNs[] = {8, 16, 24, 32, 48, 64, 96, 128};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarriers: a full and an empty barrier a ring stage ------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the producer's arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect_bytes(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// waits for the phase of `bar` with this parity to complete; a ring that
// never fills (a fault) traps after 10 s rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1; !mbar_try_wait(bar, parity); ++spins) {
    if (spins % 1024) continue;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t0 == 0) t0 = t;
    else if (t - t0 > 10000000000ull) __trap();
  }
}
// a box of a 2-D tensor map (inner coordinate first) into shared memory,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int inner, int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer), "r"(bar)
      : "memory");
}
// orders this thread's shared-memory accesses (generic proxy) before later
// bulk copies into the same bytes (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the async
// product
template <int S>
__device__ __forceinline__ void fence_operands(float (&d)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors in the 128-byte swizzle (layout type 1),
// 8-row groups 1024 bytes apart (the stride byte offset). The start address
// field is the byte address / 16, under 2^14 in a block's 227 KB, so an
// offset is added to a descriptor as offset / 16.
// K-major (x's rows of 64 K): the leading offset is unused; a k16 step
// advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// MN-major (the slab's K rows of 64 columns): one 64-column swizzle atom,
// so the leading offset (the step to the next 64 columns) is never taken;
// it is set to the 8-row group stride as well. A k16 step advances the
// start address by 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x NT] (+)= A[64 x 16] B[16 x NT], NT the rows of a stage: A MN-major
// (transposed), B K-major, both in shared memory; scale_d 0 overwrites d.
// In d, thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 +
// 8 i and columns 8 j + 2 (t % 4) + e at d[4 j + 2 i + e].
template <int NT>
__device__ __forceinline__ void wgmma_rows(float (&d)[NT / 2], uint64_t a,
                                           uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rows<8>(float (&d)[4], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rows<16>(float (&d)[8], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rows<24>(float (&d)[12], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rows<32>(float (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rows<48>(float (&d)[24], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rows<64>(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// rows of a ring stage for a tile of n rows: all of them, or half
__host__ __device__ constexpr int stage_rows(int nt) {
  return nt <= kMaxStageRows ? nt : nt / 2;
}
// 64-wide K panels a stage: enough for a narrow or a wide stage's bytes of
// x, so that a stage's barrier waits are shared by several panels' products
__host__ __device__ constexpr int stage_panels(int sr, bool wide) {
  return ((wide ? kWideStage : kNarrowStage) + sr * kRowBytes - 1) /
         (sr * kRowBytes);
}
// independent accumulator sets a row stage, which take the k16 steps of a
// panel in turn: a wgmma of few rows is short, and one chain of them into
// one accumulator would wait on each one's latency
__host__ __device__ constexpr int acc_sets(int sr) { return sr <= 32 ? 4 : 2; }

// the ring's next slot, counting the rounds (a slot's uses) as it wraps
__device__ __forceinline__ void next_slot(int& s, int& round, int stages) {
  if (++s == stages) {
    s = 0;
    ++round;
  }
}

// grid (slabs of 64 columns, row groups); a group is a contiguous run of
// the `tiles` row tiles. Warps 0-3 (a warpgroup) run the product and the
// epilogue, one thread of warp 4 the copies. A stage is PN 64-wide K
// panels of SR rows of a tile ([PN][SR][64] bf16); a tile of 2 SR rows
// takes two stages for the same panels (H = 2). kResident: the slab of w
// stays in shared memory (P panels of 8 KB) and a stage is x's part alone;
// else a stage also has room for its panels of w after x's, which the first
// row stage fills. K is taken in PN-panel steps; panels past K are zeros
// (the copies' fill, and the slab's pad). Stages take the ring's slots in
// turn; a slot's full barrier completes when its bytes have landed, its
// empty barrier when each consumer warp is done with it. The slot and
// round are counted, not divided out (a version that divided by the ring
// depth at each stage took 2.4x as long at 24 rows with one-panel stages:
// PERF.md).
template <int NT, bool kResident, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
tiled_mm_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                bf16* __restrict__ out, int tile_rows, int tiles, int K,
                int N, int stages) {
  static_assert(kResident || kWide, "a streamed ring is wide");
  constexpr int SR = stage_rows(NT), H = NT / SR, A = acc_sets(SR);
  constexpr int PN = stage_panels(SR, kWide);
  constexpr int kXBytes = SR * kRowBytes;   // one panel of a row stage
  constexpr int kStageBytes =
      PN * (kXBytes + (kResident ? 0 : kWPanelBytes));
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlignPad - 1) & ~(uint32_t)(kAlignPad - 1);
  const int P = (K + PN * kPanelK - 1) / (PN * kPanelK) * PN;   // padded
  const uint32_t slab = base;
  const uint32_t ring = base + (kResident ? P * kWPanelBytes : 0);
  const uint32_t full = ring + stages * kStageBytes;   // [stages] barriers
  const uint32_t empty = full + 8 * kMaxStages;        // [stages]

  const int col0 = blockIdx.x * kSlabCols;
  const int t_begin = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t_end = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer
      mbar_init(empty + 8 * s, kConsumers / 32);    // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: a slot is refilled once the consumers released its
    // previous use (the first round waits for nothing)
    if (lane != 0) return;
    int s = 0, round = 0;
    for (int tl = t_begin; tl < t_end; ++tl) {
      const bool with_w = !kResident || tl == t_begin;
      for (int kp = 0; kp < P; kp += PN) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t st = ring + s * kStageBytes, bar = full + 8 * s;
          const bool w_here = with_w && h == 0;
          mbar_expect_bytes(bar, PN * (kXBytes + (w_here ? kWPanelBytes : 0)));
#pragma unroll
          for (int p = 0; p < PN; ++p)
            tma_load(st + p * kXBytes, &xmap, (kp + p) * kPanelK,
                     tl * tile_rows + h * SR, bar);
          if (w_here)
#pragma unroll
            for (int p = 0; p < PN; ++p)
              tma_load(kResident ? slab + (kp + p) * kWPanelBytes
                                 : st + PN * kXBytes + p * kWPanelBytes,
                       &wmap, col0, (kp + p) * kPanelK, bar);
          next_slot(s, round, stages);
        }
      }
    }
    return;
  }

  float d[H][A][SR / 2];   // the accumulator sets of each row stage
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int i = 0; i < SR / 2; ++i) d[h][a][i] = 0.f;
  const int g = lane >> 2, q = lane & 3;
  int s = 0, round = 0;
  int held[H];             // the slots of the stages last consumed
  bool holding = false;
  // row tiles outside, K stages inside: the stage loop waits for all but
  // the newest wgmma group, the tile's end for all of it. A stage is
  // released when the group after it is issued and its own has completed;
  // the last stages of a tile hold the epilogue and are released by the
  // next tile's first group.
  for (int tl = t_begin; tl < t_end; ++tl) {
    for (int kp = 0; kp < P; kp += PN) {
      int cur[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        cur[h] = s;
        mbar_wait(full + 8 * s, round & 1);
        next_slot(s, round, stages);
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int a = 0; a < A; ++a) fence_operands(d[h][a]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PN; ++p) {
        const uint64_t da = desc_mnmajor(
            kResident ? slab + (kp + p) * kWPanelBytes
                      : ring + cur[0] * kStageBytes + PN * kXBytes +
                            p * kWPanelBytes);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint64_t db =
              desc_kmajor(ring + cur[h] * kStageBytes + p * kXBytes);
#pragma unroll
          for (int ks = 0; ks < kPanelK / 16; ++ks)
            wgmma_rows<SR>(d[h][ks % A], da + ks * (16 * kRowBytes >> 4),
                           db + ks * 2, (kp | p) != 0 || ks >= A);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();                     // the group before this one
      if (holding && lane == 0) {
#pragma unroll
        for (int h = 0; h < H; ++h) mbar_arrive(empty + 8 * held[h]);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) held[h] = cur[h];
      holding = true;
    }
    wgmma_wait<0>();                       // the tile's sums are complete
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int a = 0; a < A; ++a) fence_operands(d[h][a]);

    // epilogue: the tile, rounded to bf16, transposed into the first panel
    // of its last stages ([SR rows][64 columns] each, the 16-byte pieces
    // swizzled as the copies lay them), then 16-byte stores of out's rows
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      unsigned char* ep =
          smem_raw + (ring + held[j / (SR / 8)] * kStageBytes - raw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * (j % (SR / 8)) + 2 * q + e;
          const int m = 16 * warp + g + 8 * i;
          const int k = 4 * (j % (SR / 8)) + 2 * i + e;
          float v = d[j / (SR / 8)][0][k];
#pragma unroll
          for (int a = 1; a < A; ++a) v += d[j / (SR / 8)][a][k];
          *reinterpret_cast<bf16*>(ep + r * kRowBytes +
                                   (((m >> 3) ^ (r & 7)) << 4) +
                                   (m & 7) * 2) = __float2bfloat16(v);
        }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    const int row0 = tl * tile_rows;
#pragma unroll
    for (int e0 = 0; e0 < NT * 8; e0 += kConsumers) {
      const int e = e0 + tid;
      const int r = e >> 3, ch = e & 7, col = col0 + ch * 8;
      if ((NT * 8 % kConsumers == 0 || e < NT * 8) && r < tile_rows &&
          col < N) {
        const int rr = r % SR;
        const int slot = r < SR ? held[0] : held[H - 1];
        const unsigned char* ep = smem_raw + (ring + slot * kStageBytes - raw);
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + col) =
            *reinterpret_cast<const uint4*>(ep + rr * kRowBytes +
                                            ((ch ^ (rr & 7)) << 4));
      }
    }
    fence_proxy_async();   // before the copies refill these stages
  }
}

constexpr int tile_n(int tile_rows) {
  for (int v : kTileNs)
    if (v >= tile_rows) return v;
  return 0;
}

// the dynamic shared memory of a launch: the alignment pad, the barriers,
// the slab where it is resident, the ring
size_t smem_bytes(int nt, bool resident, bool wide, int K, int stages) {
  const int sr = stage_rows(nt), pn = stage_panels(sr, wide);
  const size_t P = (size_t)(K + pn * kPanelK - 1) / (pn * kPanelK) * pn;
  return kAlignPad + kBarrierBytes + (resident ? P * kWPanelBytes : 0) +
         (size_t)stages * pn *
             (sr * kRowBytes + (resident ? 0 : kWPanelBytes));
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// a row-major bf16 [outer, inner] matrix, boxes of box_outer x 64, in the
// 128-byte swizzle, zeros past its edges
bool make_map(CUtensorMap* map, const void* ptr, int outer, int inner,
              int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kPanelK, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map through a small cache of the calling thread's last maps, by
// address and shape, replaced in turn
bool cached_map(CUtensorMap* map, const void* ptr, int outer, int inner,
                int box_outer) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int outer, inner, box_outer;
  };
  constexpr int kEntries = 8;
  static thread_local Entry cache[kEntries];
  static thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.outer == outer && e.inner == inner &&
        e.box_outer == box_outer) {
      *map = e.map;
      return true;
    }
  }
  if (!make_map(map, ptr, outer, inner, box_outer)) return false;
  cache[next] = Entry{*map, ptr, outer, inner, box_outer};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return true;
}

template <int NT, bool kResident, bool kWide>
int launch(const void* x, const void* w, void* out, int rows, int tile_rows,
           int K, int N, int stages, int groups, size_t smem, void* stream) {
  // the dynamic shared-memory limit is raised once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiled_mm_kernel<NT, kResident, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap xmap, wmap;
  if (!cached_map(&xmap, x, rows, K, stage_rows(NT)) ||
      !cached_map(&wmap, w, K, N, kPanelK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kSlabCols - 1) / kSlabCols, groups);
  tiled_mm_kernel<NT, kResident, kWide>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          xmap, wmap, (bf16*)out, tile_rows, rows / tile_rows, K, N, stages);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_n(bool resident, bool wide, const void* x, const void* w,
             void* out, int rows, int tile_rows, int K, int N, int stages,
             int groups, size_t smem, void* stream) {
  auto* f = !resident ? launch<NT, false, true>
            : wide      ? launch<NT, true, true>
                        : launch<NT, true, false>;
  return f(x, w, out, rows, tile_rows, K, N, stages, groups, smem, stream);
}

}  // namespace

extern "C" {

// resident, wide, stages and groups are the wrapper's plan
// (ops/tiled_mm.py): refused unless the plan fits a block's shared memory,
// its ring holds two groups' stages and a streamed ring is wide
int isc_tiled_mm_bf16(const void* x, const void* w, void* out, int rows,
                      int tile_rows, int K, int N, int resident, int wide,
                      int stages, int groups, void* stream) {
  if (rows < 1 || tile_rows < 1 || tile_rows > kMaxTileRows ||
      rows % tile_rows || K < 8 || K % 8 || N < 8 || N % 8 ||
      stages > kMaxStages || groups < 1 ||
      groups > rows / tile_rows || (resident == 0 && wide == 0))
    return (int)cudaErrorInvalidValue;
  const int nt = tile_n(tile_rows);
  if (stages < kMinStages * (nt / stage_rows(nt)))
    return (int)cudaErrorInvalidValue;
  const bool r = resident != 0, wd = wide != 0;
  const size_t smem = smem_bytes(nt, r, wd, K, stages);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
#define ISC_TILE_CASE(V)                                                    \
  case V:                                                                   \
    return launch_n<V>(r, wd, x, w, out, rows, tile_rows, K, N, stages,     \
                       groups, smem, stream);
  switch (nt) {
    ISC_TILE_CASE(8)
    ISC_TILE_CASE(16)
    ISC_TILE_CASE(24)
    ISC_TILE_CASE(32)
    ISC_TILE_CASE(48)
    ISC_TILE_CASE(64)
    ISC_TILE_CASE(96)
    ISC_TILE_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ISC_TILE_CASE
}

}  // extern "C"

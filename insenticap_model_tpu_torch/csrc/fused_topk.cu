// Fused classifier product + log-softmax + bans + exact top-k on Hopper.
//
// Replaces the Pallas kernel insenticap_model_tpu/ops/fused_topk.py
// `_kernel` with `_merge_topk`. For every candidate row r of the beam:
//
//   logits[r, v] = h[r] . W[v] + b[v]                (f32 accumulation)
//   lse[r]       = log sum_v exp(logits[r, v])       (all V words)
//   out[r]       = top-k of logits[r, v] - lse[r] over the words that are
//                  neither a static ban nor last[r]; descending, the lower
//                  index first on a tie; slots with no candidate hold
//                  (-1e30, 0)
//
// W is [V, H] row-major (the port's Linear layout), so a vocab row is H
// contiguous values: the K-major B operand of the product as it lies.
//
// What bounds it on the H100 at serving width (rows 1152, H 512, V 10,000):
// operations, 11.8 GFLOP (11.9 us at the bf16 tensor rate) against 11.5 MB
// moved (3.4 us). Two launches on one stream:
//
//  1. bf16: topk_wgmma<K>, one 256-thread CTA (two warpgroups of 64 rows)
//     per (128-row block, vocab group); a group is a contiguous range of
//     128-word vocab tiles, and the wrapper picks the number of groups so
//     that the grid is about one wave (9 row blocks x 14 groups = 126 CTAs
//     on 132 SMs at 1152 rows). The CTA's 128 rows of h stay in shared
//     memory for its whole life (K in 64-wide panels, 16 KB each, 128 KB at
//     H = 512), so h crosses L2 once a group, not once a vocab tile. W
//     streams through a 4-stage ring of [128 words x 64 K] tiles (16 KB),
//     fed by 16-byte cp.async from all 256 threads, two tiles ahead; each h
//     panel rides with the W tile of the first vocab tile that needs it,
//     and each vocab tile's 128 biases with its first W tile (a 4-deep
//     buffer, so the epilogue reads them from shared memory). Both operands
//     lie in shared memory in the 128-byte swizzle that wgmma reads (a
//     64-wide bf16 K panel is one 128-byte row), written by the copies
//     themselves, so there is no transpose. The product is
//     wgmma.mma_async m64n128k16, bf16 in, f32 accumulate (bf16 products
//     are exact in f32: the same function as the plain version). The loop
//     nest (vocab tiles outside, K panels inside, `wgmma.wait_group 1` in
//     the inner loop and 0 after it) keeps one group of four k16 steps in
//     flight while the next panel's copies are issued; with the waits in
//     branches ptxas serialised every group (its warning C7517).
//     The [rows, V] logits never leave the registers: in the wgmma
//     accumulator layout a thread holds 2 rows x 32 columns of each tile,
//     a row's 128 values in one quad of lanes. Each thread keeps, for each
//     of its 2 rows and across the group's whole vocab range, an online max
//     and rescaled exp-sum and a sorted top-k (K = 1..8 instances, so the
//     list is K registers); the bias is added in f32. The top-k's gate is
//     the quad's threshold, the highest of its four k-th values (the row
//     already holds k values ranked before it), so most logits cost one
//     compare into a candidate mask; the static bans and the row's last
//     word are a mask of the thread's columns, built once a tile. A warp
//     with many candidates (the first tile) runs a branch-free insertion
//     network over every column; the few of later tiles go in one by one,
//     picked from registers. (An insertion network unrolled at every
//     column, candidates kept in a local-memory list, and the bias read
//     from device memory in the epilogue each made this pass slower on the
//     card.) Not done: the epilogue does not overlap the product (both
//     warpgroups reduce a tile while the tensor cores wait). At the end of
//     the range each quad merges its four lists and sums by shuffles and
//     writes one (max, sum, k values, k ids) partial per (group, row) to
//     scratch.
//     f32: topk_tiles_f32, the FFMA design of the first version (TF32 would
//     change the function): one block per (64-row block, vocab tile),
//     the logits tile reduced in shared memory, one partial per tile.
//  2. topk_merge, one warp per row, merges the row's partials (max,
//     rescaled sum, top-k) and writes value - lse.
//
// topk_wgmma<0> (isc_topk_product_bf16) runs pass 1's mainloop alone and
// writes the f32 logits: a check of the wgmma product against a library
// product, off the serving path.
//
// Limits: bf16 needs H % 8 == 0 (16-byte rows for the copies) and
// H <= 640 (ten 64-wide panels of h beside the ring in 227 KB); f32 takes
// any H. Any rows, any V; the ragged K panel, vocab tile and row block are
// zero-filled by the copies and masked in the epilogue. The wrapper
// (ops/fused_topk.py) checks these and raises otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxK = 8;
constexpr int kMaxBanned = 8;
constexpr float kBanned = -1e30f;  // the beam's finite "banned" sentinel
constexpr int kEmptyId = 0x7fffffff;
constexpr float kLog2e = 1.4426950408889634f;

struct Bans {
  int n;
  int id[kMaxBanned];
};

// (value desc, index asc): is (va, ia) ranked before (vb, ib)?
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ bool is_banned(int col, long long last,
                                          const Bans& bans) {
  bool banned = col == last;
  for (int q = 0; q < bans.n; ++q) banned |= col == bans.id[q];
  return banned;
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- 1a. bf16: wgmma over resident rows ------------------------------------

constexpr int kRowsW = 128;          // rows of h a CTA: two warpgroups
constexpr int kCols = 128;           // words a vocab tile: the wgmma N
constexpr int kPanel = 64;           // K a panel: one 128-byte swizzle row
constexpr int kPanelBytes = kRowsW * kPanel * 2;   // 16 KB, h or W alike
constexpr int kStages = 4;           // W ring
constexpr int kLead = kStages - 2;   // W tiles in flight ahead of the one
                                     // read (one more is still being read
                                     // by the wgmma group in flight)
constexpr int kMaxPanels = 10;       // H <= 640
constexpr int kThreadsW = 256;
constexpr int kBiasBufs = 4;         // vocab tiles' biases in flight
constexpr int kBiasBytes = kCols * 2;
// 1 KB to align the panels, h's panels, the W ring, the bias buffers
constexpr size_t kSmemW = 1024 +
    (size_t)(kMaxPanels + kStages) * kPanelBytes + kBiasBufs * kBiasBytes;
static_assert(kCols * kPanel * 2 == kPanelBytes, "one size of panel");
static_assert(kSmemW <= 232448, "fits the 227 KB of a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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
// the copies (generic proxy) become visible to wgmma's reads (async proxy)
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
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused for this layout. A k16
// step inside the 64-wide panel advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both K-major in shared memory;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The copies of one K panel (64 wide) of 128 rows from r0 of `src` [*, H]
// to `dst`: 1024 pieces of 16 bytes, 4 a thread. Row r's piece ch lands at
// r * 128 + ((ch ^ (r % 8)) * 16): the 128-byte swizzle (the panel bases are
// 1024-aligned). Pieces of rows from `nrows` on, or past H, are zero-filled.
__device__ __forceinline__ void copy_panel(const bf16* __restrict__ src,
                                           int r0, int nrows, int H, int kp,
                                           uint32_t dst) {
#pragma unroll
  for (int i = 0; i < kRowsW * 8 / kThreadsW; ++i) {
    const int e = threadIdx.x + i * kThreadsW, r = e >> 3, ch = e & 7;
    const int k = kp * kPanel + ch * 8;
    const bool ok = r0 + r < nrows && k < H;
    cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4),
               ok ? src + (size_t)(r0 + r) * H + k : src, ok ? 16 : 0);
  }
}

// The bit of column `id` among this thread's 32 columns of the tile at v0
// (column q of thread t is v0 + 8 (q / 2) + 2 t + q % 2), 0 where it is not
// one of them
__device__ __forceinline__ uint32_t ban_bit(int id, int v0, int t) {
  const int rel = id - v0;
  if (rel < 0 || rel >= kCols || ((rel >> 1) & 3) != t) return 0u;
  return 1u << (((rel >> 3) << 1) | (rel & 1));
}

// Inserts (v, id) into the sorted list (value desc, index asc). Values
// arrive in ascending index order, so an equal value ranks after the ones
// held; once an entry moves down, every entry below it moves too.
// Branch-free: -inf inserts nothing.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&tv)[K], int (&ti)[K],
                                              float v, int id) {
  bool moved = false;
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const bool sw = moved || v > tv[p];
    const float fv = tv[p];
    const int fi = ti[p];
    tv[p] = sw ? v : fv;
    ti[p] = sw ? id : fi;
    v = sw ? fv : v;
    id = sw ? fi : id;
    moved = sw;
  }
}

// Pass 1, bf16. K = 1..8: the top-k epilogue, partials [groups][rows];
// K = 0: the product alone, f32 logits [rows, V] (the card check).
template <int K>
__global__ void __launch_bounds__(kThreadsW, 1)
topk_wgmma(const bf16* __restrict__ h, const bf16* __restrict__ w,
           const bf16* __restrict__ b, const long long* __restrict__ last,
           Bans bans, int rows, int H, int V, float* __restrict__ part_f,
           int* __restrict__ part_i, float* __restrict__ logits) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t hs = (smem_u32(smem_raw) + 1023) & ~1023u;   // h panels
  const int P = (H + kPanel - 1) / kPanel;
  const uint32_t ring = hs + P * kPanelBytes;                 // W stages

  const int groups = gridDim.x, grp = blockIdx.x;
  const int tiles = (V + kCols - 1) / kCols;
  const int t_begin = (int)((long long)grp * tiles / groups);
  const int t_end = (int)((long long)(grp + 1) * tiles / groups);
  const int n = (t_end - t_begin) * P;           // W tiles this CTA reads
  const int row0 = blockIdx.y * kRowsW;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's two rows (accumulator rows g and g + 8 of its warp)
  const int r_lo = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;

  const uint32_t bias_s = ring + kStages * kPanelBytes;       // bf16 [4][128]
  // W tile c of this CTA (vocab tile c / P, K panel c % P); with its first
  // panel, the vocab tile's 128 biases; with the first vocab tile, h's
  // panel
  auto load = [&](int c) {
    const int tl = c / P, kp = c % P, v0 = (t_begin + tl) * kCols;
    copy_panel(w, v0, V, H, kp, ring + (c % kStages) * kPanelBytes);
    if (tl == 0) copy_panel(h, row0, rows, H, kp, hs + kp * kPanelBytes);
    if constexpr (K > 0) {
      if (kp == 0 && threadIdx.x < kBiasBytes / 16) {
        const int col = v0 + 8 * threadIdx.x;
        const int bytes = col >= V ? 0 : (V - col >= 8 ? 16 : 2 * (V - col));
        cp_async16(bias_s + (tl % kBiasBufs) * kBiasBytes + 16 * threadIdx.x,
                   bytes ? b + col : b, bytes);
      }
    }
  };

  // top-k state: rows i = 0, 1 (r_lo, r_lo + 8)
  constexpr int KK = K > 0 ? K : 1;
  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
  float tv[2][KK];
  int ti[2][KK];
  int ban_last[2];   // -1: none (ids past V never match a column)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    const long long l = (last != nullptr && r < rows) ? last[r] : -1;
    ban_last[i] = l >= 0 && l < V ? (int)l : -1;
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      tv[i][q] = -INFINITY;
      ti[i][q] = kEmptyId;
    }
  }

#pragma unroll
  for (int c = 0; c < kLead; ++c) {
    if (c < n) load(c);
    cp_async_commit();
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  // tiles outside, K panels inside: the panel loop waits for all but the
  // newest wgmma group, the tile's end for all of it
  for (int tl = 0, c = 0; tl < n / P; ++tl) {
    for (int kp = 0; kp < P; ++kp, ++c) {
      cp_async_wait<kLead - 1>();   // W tile c (and h panel kp) landed
      fence_proxy_async();
      __syncthreads();              // for every thread; slot (c + kLead) is
                                    // free: its wgmma group completed
      if (c + kLead < n) load(c + kLead);
      cp_async_commit();            // an empty group past the end keeps count

      const uint32_t a0 = hs + kp * kPanelBytes + wg * 64 * 128;
      const uint32_t b0 = ring + (c % kStages) * kPanelBytes;
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kPanel / 16; ++ks)
        wgmma_m64n128k16(d, desc_sw128(a0 + 32 * ks),
                         desc_sw128(b0 + 32 * ks), (kp | ks) != 0);
      wgmma_commit();
      wgmma_wait<1>();              // the group before this one is done
    }
    wgmma_wait<0>();                // the tile's logits are complete
    fence_operands(d);
    const int v0 = (t_begin + tl) * kCols;
    if constexpr (K == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r_lo + 8 * i, col = v0 + 8 * j + 2 * t + e;
            if (r < rows && col < V)
              logits[(size_t)r * V + col] = d[4 * j + 2 * i + e];
          }
    } else {
      // bias of this thread's 32 columns from shared memory (-inf past V)
      const __nv_bfloat162* bs = reinterpret_cast<const __nv_bfloat162*>(
          smem_raw + (bias_s - smem_u32(smem_raw)) +
          (tl % kBiasBufs) * kBiasBytes);
      const bool ragged = v0 + kCols > V;
      float bias[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 f = __bfloat1622float2(bs[4 * j + t]);
        const int col = v0 + 8 * j + 2 * t;
        bias[2 * j] = ragged && col >= V ? -INFINITY : f.x;
        bias[2 * j + 1] = ragged && col + 1 >= V ? -INFINITY : f.y;
      }
      // the static bans among this thread's columns of the tile
      uint32_t tile_bans = 0;
#pragma unroll
      for (int e = 0; e < kMaxBanned; ++e)
        if (e < bans.n) tile_bans |= ban_bit(bans.id[e], v0, t);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x[32];
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[2 * j + e] = d[4 * j + 2 * i + e] + bias[2 * j + e];
            mt = fmaxf(mt, x[2 * j + e]);
          }
        // online max and exp-sum (exp2 of log2e-scaled differences); a
        // thread whose columns all lie past V so far keeps (-inf, 0)
        const float mn = fmaxf(m[i], mt);
        const float mb = mn == -INFINITY ? 0.f : mn;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 32; ++q) sum += exp2f((x[q] - mb) * kLog2e);
        s[i] = s[i] * exp2f((m[i] - mb) * kLog2e) + sum;
        m[i] = mn;
        // top-k. The gate is the quad's threshold, the highest of its
        // four k-th values so far (the row already holds k values ranked
        // before it, all at lower indices); the candidates above it are a
        // mask, with this row's bans cleared. Many candidates (a list
        // still filling, as in the first tile) go through the insertion
        // network, every column; the few of a later tile one by one.
        float thr = tv[i][K - 1];
        thr = fmaxf(thr, __shfl_xor_sync(0xffffffffu, thr, 1));
        thr = fmaxf(thr, __shfl_xor_sync(0xffffffffu, thr, 2));
        uint32_t msk = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q) msk |= x[q] > thr ? 1u << q : 0u;
        msk &= ~(tile_bans | ban_bit(ban_last[i], v0, t));
        if (__any_sync(0xffffffffu, __popc(msk) > 8)) {
#pragma unroll
          for (int q = 0; q < 32; ++q)
            insert_sorted<K>(tv[i], ti[i], (msk >> q) & 1u ? x[q] : -INFINITY,
                             v0 + 8 * (q >> 1) + 2 * t + (q & 1));
        } else {
          while (msk) {
            const int q = __ffs(msk) - 1;
            msk &= msk - 1;
            float v = x[0];   // x[q], kept in registers
#pragma unroll
            for (int e = 1; e < 32; ++e) v = q == e ? x[e] : v;
            insert_sorted<K>(tv[i], ti[i], v,
                             v0 + 8 * (q >> 1) + 2 * t + (q & 1));
          }
        }
      }
    }
  }

  if constexpr (K > 0) {
    // the quad's four lists and sums -> one partial a (group, row)
    float* part_m = part_f;
    float* part_s = part_f + (size_t)groups * rows;
    float* part_v = part_f + (size_t)2 * groups * rows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      const size_t p = (size_t)grp * rows + r;
      float mq = m[i];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
      const float mb = mq == -INFINITY ? 0.f : mq;
      float sq = s[i] * exp2f((m[i] - mb) * kLog2e);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      if (t == 0 && r < rows) {
        part_m[p] = mq;
        part_s[p] = sq;
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        float bv = tv[i][0];
        int bi = ti[i][0];
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (before(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (t == 0 && r < rows) {
          part_v[p * K + q] = bv;
          part_i[p * K + q] = bi;
        }
        if (ti[i][0] == bi && tv[i][0] == bv) {   // this lane's head won
#pragma unroll
          for (int e = 0; e + 1 < K; ++e) {
            tv[i][e] = tv[i][e + 1];
            ti[i][e] = ti[i][e + 1];
          }
          tv[i][K - 1] = -INFINITY;
          ti[i][K - 1] = kEmptyId;
        }
      }
    }
  }
}

// -- 1b. f32: FFMA tiles ---------------------------------------------------

constexpr int kRowsF = 64;      // rows of h a block
constexpr int kKF = 32;         // K step of the staged tiles
constexpr int kThreadsF = 256;
constexpr int kWarpsF = kThreadsF / 32;
constexpr int kStageF = kKF * (kRowsF + 1) + kKF * (kCols + 1);   // floats
constexpr int kLogitsF = kRowsF * (kCols + 1);                     // floats
constexpr int kSmemF = kLogitsF > kStageF ? kLogitsF : kStageF;

// 4 x 8 outputs a thread (rows ty + 16 i, columns tx + 16 j), tiles staged
// k-major so a warp's reads are broadcast or consecutive
__device__ __forceinline__ void logits_tile_f32(
    const float* __restrict__ h, const float* __restrict__ w, float* smem,
    int row0, int v0, int rows, int H, int V, float acc[4][8]) {
  float* hs = smem;                          // [kKF][kRowsF + 1]
  float* ws = smem + kKF * (kRowsF + 1);     // [kKF][kCols + 1]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kKF) {
    for (int e = tid; e < kRowsF * kKF; e += kThreadsF) {
      const int r = e / kKF, kk = e % kKF;
      const int gr = row0 + r, gk = k0 + kk;
      hs[kk * (kRowsF + 1) + r] =
          (gr < rows && gk < H) ? h[(size_t)gr * H + gk] : 0.f;
    }
    for (int e = tid; e < kCols * kKF; e += kThreadsF) {
      const int c = e / kKF, kk = e % kKF;
      const int gv = v0 + c, gk = k0 + kk;
      ws[kk * (kCols + 1) + c] =
          (gv < V && gk < H) ? w[(size_t)gv * H + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKF; ++kk) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[kk * (kRowsF + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = ws[kk * (kCols + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// a (64-row block, vocab tile) -> per-row partials [tiles][rows]
__global__ void __launch_bounds__(kThreadsF)
topk_tiles_f32(const float* __restrict__ h, const float* __restrict__ w,
               const float* __restrict__ b, const long long* __restrict__ last,
               Bans bans, int rows, int H, int V, int k,
               float* __restrict__ part_f, int* __restrict__ part_i) {
  __shared__ __align__(16) float smem[kSmemF];
  const int v0 = blockIdx.x * kCols, row0 = blockIdx.y * kRowsF;
  const int tiles = gridDim.x;
  float acc[4][8];
  logits_tile_f32(h, w, smem, row0, v0, rows, H, V, acc);
  // the staging buffers are free (logits_tile_f32 ends on a barrier)
  float* ls = smem;
  {
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ls[(ty + 16 * i) * (kCols + 1) + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* part_m = part_f;
  float* part_s = part_f + (size_t)tiles * rows;
  float* part_v = part_f + (size_t)2 * tiles * rows;
  for (int rr = warp; rr < kRowsF; rr += kWarpsF) {
    const int gr = row0 + rr;
    if (gr >= rows) break;
    const long long ban_last = last ? last[gr] : -1;
    float x[kCols / 32];
    int col[kCols / 32];
    bool ok[kCols / 32], cand[kCols / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols / 32; ++j) {
      col[j] = v0 + lane + 32 * j;
      ok[j] = col[j] < V;
      x[j] = ok[j] ? ls[rr * (kCols + 1) + lane + 32 * j] + b[col[j]]
                   : -INFINITY;
      mx = fmaxf(mx, x[j]);
      cand[j] = ok[j] && !is_banned(col[j], ban_last, bans);
    }
    mx = warp_max(mx);
    float sm = 0.f;
#pragma unroll
    for (int j = 0; j < kCols / 32; ++j)
      if (ok[j]) sm += expf(x[j] - mx);
    sm = warp_sum(sm);
    const size_t p = (size_t)blockIdx.x * rows + gr;
    if (lane == 0) {
      part_m[p] = mx;
      part_s[p] = sm;
    }
    float pv = INFINITY;
    int pi = -1;
    for (int q = 0; q < k; ++q) {
      float bv = -INFINITY;
      int bi = kEmptyId;
#pragma unroll
      for (int j = 0; j < kCols / 32; ++j)
        if (cand[j] && before(pv, pi, x[j], col[j]) &&
            before(x[j], col[j], bv, bi)) {
          bv = x[j];
          bi = col[j];
        }
      warp_best(bv, bi);
      if (lane == 0) {
        part_v[p * k + q] = bv;
        part_i[p * k + q] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

// -- 2. the merge ----------------------------------------------------------

// one warp per row merges the row's `parts` partials
__global__ void __launch_bounds__(256)
topk_merge(const float* __restrict__ part_f, const int* __restrict__ part_i,
           int parts, int rows, int k, float* __restrict__ out_v,
           long long* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int gr = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (gr >= rows) return;
  const float* part_m = part_f;
  const float* part_s = part_f + (size_t)parts * rows;
  const float* part_v = part_f + (size_t)2 * parts * rows;
  // (max, sum) in one pass: each lane's partials, then the warp's
  float m = -INFINITY, s = 0.f;
  for (int c = lane; c < parts; c += 32) {
    const size_t p = (size_t)c * rows + gr;
    const float pm = part_m[p], ps = part_s[p];
    const float mn = fmaxf(m, pm);
    s = (m == -INFINITY ? 0.f : s * expf(m - mn)) + ps * expf(pm - mn);
    m = mn;
  }
  const float mw = warp_max(m);
  s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - mw));
  m = mw;
  const float log_s = logf(s);
  float pv = INFINITY;
  int pi = -1;
  for (int q = 0; q < k; ++q) {
    float bv = -INFINITY;
    int bi = kEmptyId;
    for (int e = lane; e < parts * k; e += 32) {
      const size_t p = ((size_t)(e / k) * rows + gr) * k + e % k;
      const float v = part_v[p];
      const int i = part_i[p];
      if (v != -INFINITY && before(pv, pi, v, i) && before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      const bool none = bv == -INFINITY;
      out_v[(size_t)gr * k + q] = none ? kBanned : (bv - m) - log_s;
      out_i[(size_t)gr * k + q] = none ? 0 : bi;
    }
    pv = bv;
    pi = bi;
  }
}

// -- launch ----------------------------------------------------------------

// raises the instance's dynamic shared-memory limit to what the largest H
// needs, once
template <int K>
cudaError_t wgmma_smem_limit() {
  static const cudaError_t err = cudaFuncSetAttribute(
      topk_wgmma<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemW);
  return err;
}

template <int K>
int launch_wgmma(const bf16* h, const bf16* w, const bf16* b,
                 const long long* last, const Bans& bans, int rows, int H,
                 int V, int groups, float* part_f, int* part_i,
                 float* logits, cudaStream_t st) {
  const cudaError_t attr = wgmma_smem_limit<K>();
  if (attr != cudaSuccess) return (int)attr;
  const int P = (H + kPanel - 1) / kPanel;
  const size_t smem = 1024 + (size_t)(P + kStages) * kPanelBytes +
                      (K > 0 ? kBiasBufs * kBiasBytes : 0);
  const dim3 grid(groups, (rows + kRowsW - 1) / kRowsW);
  topk_wgmma<K><<<grid, kThreadsW, smem, st>>>(h, w, b, last, bans, rows, H,
                                               V, part_f, part_i, logits);
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int H, int V, int groups, bool is_bf16) {
  const int tiles = (V + kCols - 1) / kCols;
  return rows < 1 || H < 1 || V < 1 || groups < 1 || groups > tiles ||
         (is_bf16 && (H % 8 || H > kMaxPanels * kPanel)) ||
         (!is_bf16 && groups != tiles);
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* last,
           const int* banned, int n_banned, int rows, int H, int V, int k,
           int groups, void* part_f, void* part_i, void* out_v, void* out_i,
           void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (bad_shape(rows, H, V, groups, kBf16) || k < 1 || k > kMaxK ||
      n_banned < 0 || n_banned > kMaxBanned)
    return (int)cudaErrorInvalidValue;
  Bans bans;
  bans.n = n_banned;
  for (int q = 0; q < kMaxBanned; ++q)
    bans.id[q] = q < n_banned ? banned[q] : -1;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if constexpr (kBf16) {
#define ISC_TOPK_CASE(KK)                                                  \
  case KK:                                                                 \
    err = launch_wgmma<KK>((const bf16*)h, (const bf16*)w, (const bf16*)b, \
                           (const long long*)last, bans, rows, H, V,       \
                           groups, (float*)part_f, (int*)part_i, nullptr,  \
                           st);                                            \
    break;
    switch (k) {
      ISC_TOPK_CASE(1)
      ISC_TOPK_CASE(2)
      ISC_TOPK_CASE(3)
      ISC_TOPK_CASE(4)
      ISC_TOPK_CASE(5)
      ISC_TOPK_CASE(6)
      ISC_TOPK_CASE(7)
      ISC_TOPK_CASE(8)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef ISC_TOPK_CASE
  } else {
    const dim3 grid(groups, (rows + kRowsF - 1) / kRowsF);
    topk_tiles_f32<<<grid, kThreadsF, 0, st>>>(
        (const float*)h, (const float*)w, (const float*)b,
        (const long long*)last, bans, rows, H, V, k, (float*)part_f,
        (int*)part_i);
    err = (int)cudaGetLastError();
  }
  if (err != 0) return err;
  topk_merge<<<(rows + 7) / 8, 256, 0, st>>>(
      (const float*)part_f, (const int*)part_i, groups, rows, k,
      (float*)out_v, (long long*)out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part_f [(2 + k) * groups * rows] f32 and part_i [k * groups * rows] int32:
// the pass-1 partials; groups: the vocab groups of the bf16 kernel (at most
// ceil(V / 128)), one per 128-word tile (exactly ceil(V / 128)) for f32
int isc_topk_f32(const void* h, const void* w, const void* b,
                 const void* last, const int* banned, int n_banned, int rows,
                 int H, int V, int k, int groups, void* part_f, void* part_i,
                 void* out_v, void* out_i, void* stream) {
  return launch<float>(h, w, b, last, banned, n_banned, rows, H, V, k,
                       groups, part_f, part_i, out_v, out_i, stream);
}

int isc_topk_bf16(const void* h, const void* w, const void* b,
                  const void* last, const int* banned, int n_banned,
                  int rows, int H, int V, int k, int groups, void* part_f,
                  void* part_i, void* out_v, void* out_i, void* stream) {
  return launch<bf16>(h, w, b, last, banned, n_banned, rows, H, V, k,
                      groups, part_f, part_i, out_v, out_i, stream);
}

// pass 1's product alone: logits [rows, V] f32 = h @ W^T (no bias)
int isc_topk_product_bf16(const void* h, const void* w, void* logits,
                          int rows, int H, int V, int groups, void* stream) {
  if (bad_shape(rows, H, V, groups, true)) return (int)cudaErrorInvalidValue;
  Bans none;
  none.n = 0;
  return launch_wgmma<0>((const bf16*)h, (const bf16*)w, nullptr, nullptr,
                         none, rows, H, V, groups, nullptr, nullptr,
                         (float*)logits, (cudaStream_t)stream);
}

}  // extern "C"

// K3's prefill for all-bf16 inputs on Hopper's warpgroup MMAs (wgmma),
// fed by tensor-memory loads (TMA) from one producer warp.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _kernel) where q, k and v are all bf16, at tile widths 64, 128 and 256
// and at MLA's Dk 192 / Dv 128, in the contract of flash_attention.cu
// (which keeps the f32 and mixed routes and widths 16, 32, 96 and 512):
// q (B,S,H,Dk), k (B,T,K,Dk), v (B,T,K,Dv), H = K*G, per-row q_pos (B,S)
// and kv_pos (B,T) (pads at 2**30), key t valid for query s iff kv_pos[t]
// <= q_pos[s] when causal and kv_pos[t] > q_pos[s] - W under a window W >
// 0; a row with no valid key gives 0.  The reference's order of rounding
// (attention.py:85, :100, :126): q scaled in bf16, scores, softmax and
// the accumulator in f32, P rounded to bf16 for P.V, the output in bf16.
// kernels/flash_attention.py::prefill_route sends a call here by its
// dtypes and head dims; prefill_plan lays out the grid.
//
// Bound on the H100: operations, 4*H*D FLOP a valid (query, key) pair at
// 989 TFLOP/s in bf16 (gemma-7b's causal 1024-token prefill, 16 heads at
// D 256: 8.6 GFLOP, 8.7 us), or below a few hundred keys the bytes of q,
// K, V and the output.
//
// Design (FlashAttention-3's shape).  A CTA of three warpgroups holds 128
// (query, head) rows of one kv head, laid out as in flash_attention.cu: row
// r is query qb*BQ + r / GS of head h0 + r % GS, so a GQA group shares each
// K/V tile and a group past 128 heads is cut into slices.  The CTA first
// stages its rows' key bounds, lists its live tiles of BN keys (those some
// row can see; fully masked tiles are never loaded) with two bits for each
// consumer warpgroup (some row of it sees a key; every row sees every key,
// so no mask), and writes Q, scaled in bf16, into shared memory in the
// 128-byte swizzle that wgmma reads (zero past the true head dim).  Then:
//   - warpgroup 0 gives up its registers (setmaxnreg) and one warp of it
//     keeps a ring of STAGES K/V tiles in flight: it waits for a stage to
//     be free (an `empty` mbarrier), issues TMA loads of 64-column panels
//     of K and V through 4-d tensor maps (head dim, kv head, token,
//     batch), which zero-fill past T and past the true head dim, and
//     writes the tile's kv_pos beside them; the stage's `full` mbarrier
//     completes when the bytes have landed and every lane has arrived;
//   - warpgroups 1 and 2 each own 64 rows.  For each live tile: S = Q K^T
//     by wgmma with both operands in shared memory (K-major, as K lies),
//     the masks from the staged kv_pos (skipped where the tile's bit says
//     every row sees every key), the online softmax in f32 registers, P
//     rounded to bf16 into wgmma's A-fragment registers, and O += P V by
//     wgmma with V read MN-major from shared memory (as V lies: no
//     transposed copy); then the stage is released.
// The last query blocks, which see the most keys, are launched first.  The
// tensor maps are encoded on the host at each launch (the driver's entry
// point found through the runtime, so nothing links against libcuda) and
// passed as __grid_constant__ parameters.
//
// Later work: overlap of a warpgroup's softmax with its next tile's QK^T
// (two S buffers), and a persistent grid.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {
namespace wg {

constexpr int kConsumers = 2;               // warpgroups of 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kRows = 64 * kConsumers;      // (query, head) rows a CTA
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes by head dims: BN keys a tile (64 at 256, whose 128-register
// accumulator leaves room for a 64-key score tile only), STAGES tiles in
// flight, and the shared-memory layout: Q's KP 64-column panels of kRows
// rows, then per stage KP panels of K and VP of V (BN rows of 128 bytes
// each, every panel 1024-byte aligned for the swizzle), then the staged
// kv_pos, the mbarriers, the rows' bounds and the live-tile list.
template <int DK_, int DV_> struct Cfg {
  static constexpr int DK = DK_, DV = DV_;
  static constexpr int BN = DV > 128 ? 64 : 128;
  static constexpr int STAGES = DK <= 64 ? 4 : 2;
  static constexpr int KP = DK / 64, VP = DV / 64;
  static constexpr int PANEL = BN * 128;
  static constexpr int Q_PANEL = kRows * 128;
  static constexpr int STAGE = (KP + VP) * PANEL;      // TMA bytes a stage
  static constexpr int OFF_STAGE = KP * Q_PANEL;
  static constexpr int OFF_POS = OFF_STAGE + STAGES * STAGE;
  static constexpr int OFF_BAR = OFF_POS + STAGES * BN * 4;
  static constexpr int OFF_LO = OFF_BAR + 2 * STAGES * 8;
  static constexpr int OFF_HI = OFF_LO + kRows * 8;
  static constexpr int OFF_RED = OFF_HI + kRows * 4;   // 4 warps x 4 bounds
  static constexpr int OFF_TILES = OFF_RED + 4 * 4 * 8 + 16;
  static size_t bytes(int n_tiles) {
    return 1024 + OFF_TILES + 4 * static_cast<size_t>(n_tiles);
  }
  static_assert(DK % 64 == 0 && DV % 64 == 0 && DV <= 256, "tile widths");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// one 64-column panel of a K or V tile: coordinates (column, kv head,
// token, batch) of the 4-d map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// A shared-memory matrix descriptor for the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO the stride between
// 64-column panels along MN for an MN-major operand (unused, 16, for a
// K-major one).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving a register's writes past a wgmma fence
template <int N> __device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

#define F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) += A (64 x 16, shared) . B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0),
        F8(8),
        F8(16),
        F8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, shared) . B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0),
        F8(8),
        F8(16),
        F8(24),
        F8(32),
        F8(40),
        F8(48),
        F8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0),
        F8(8),
        F8(16),
        F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0),
        F8(8),
        F8(16),
        F8(24),
        F8(32),
        F8(40),
        F8(48),
        F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256) += A (64 x 16, registers) . B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
      "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
      "%101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(0),
        F8(8),
        F8(16),
        F8(24),
        F8(32),
        F8(40),
        F8(48),
        F8(56),
        F8(64),
        F8(72),
        F8(80),
        F8(88),
        F8(96),
        F8(104),
        F8(112),
        F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- the kernel -----------------------------------------------------------

// One CTA: batch row b = blockIdx.z, kv head kvh = blockIdx.y, and x =
// gridDim.x - 1 - blockIdx.x = qb * NHS + hs (query block qb, head slice
// hs of NHS = ceil(G / GS)); row r < BQ*GS is query qb*BQ + r / GS of head
// kvh*G + hs*GS + r % GS where that head is < G (prefill_plan and
// prefill_row).  dk <= DK and dv <= DV are the true head dims (multiples of
// 8, the rows' lengths in memory).
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __nv_bfloat16* __restrict__ q,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int T_, int H,
                     int G, int GS, int BQ, int dk, int dv, int causal,
                     int window, float scale) {
  using C = Cfg<DK, DV>;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  int* pos = reinterpret_cast<int*>(smem + C::OFF_POS);
  long long* row_lo = reinterpret_cast<long long*>(smem + C::OFF_LO);
  int* row_hi = reinterpret_cast<int*>(smem + C::OFF_HI);
  long long* red = reinterpret_cast<long long*>(smem + C::OFF_RED);
  int* n_live_s = reinterpret_cast<int*>(smem + C::OFF_RED + 4 * 4 * 8);
  int* tiles = reinterpret_cast<int*>(smem + C::OFF_TILES);
  auto full_bar = [&](int st) { return sbase + C::OFF_BAR + 8 * st; };
  auto empty_bar = [&](int st) {
    return sbase + C::OFF_BAR + 8 * (STAGES + st);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nhs = (G + GS - 1) / GS;
  const int xb = gridDim.x - 1 - blockIdx.x;
  const int qb = xb / nhs, h0 = xb % nhs * GS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T_ + BN - 1) / BN;
  const long long kv_base = static_cast<long long>(b) * T_;

  if (tid == 0) {
    // the maps' descriptors, fetched while the prologue runs
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_v)) : "memory");
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full_bar(st), 32);            // the producer warp's lanes
      bar_init(empty_bar(st), 4 * kConsumers);   // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // each row's key bounds: key p is valid for the row iff p <= hi and p >
  // lo (64-bit: q_pos - W may not fit an int); and each consumer
  // warpgroup's loosest bounds and, over its rows that exist, tightest
  if (tid < kRows) {
    const int r = tid;
    const int s = qb * BQ + r / GS, gh = h0 + r % GS;
    const bool ok = r < BQ * GS && s < S && gh < G;
    const int qp = ok ? q_pos[static_cast<long long>(b) * S + s] : 0;
    const int hi = !ok ? INT_MIN : (causal ? qp : INT_MAX);
    const long long lo = !ok ? LLONG_MAX
                             : (window > 0 ? static_cast<long long>(qp) - window
                                           : LLONG_MIN);
    row_hi[r] = hi;
    row_lo[r] = lo;
    long long v[4] = {hi, lo, ok ? hi : INT_MAX, ok ? lo : LLONG_MIN};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[0] = max(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
      v[1] = min(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
      v[2] = min(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
      v[3] = max(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
    }
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[4 * warp + i] = v[i];
  }
  // Q, scaled in bf16 (the reference's order), into Q's panels in the
  // 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8); zero
  // past dk and in rows that do not exist
  {
    constexpr int CPR = DK / 8;
    for (int idx = tid; idx < kRows * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const int s = qb * BQ + r / GS, gh = h0 + r % GS;
      const bool ok = r < BQ * GS && s < S && gh < G && 8 * c < dk;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        x = __ldg(reinterpret_cast<const uint4*>(
            q + ((static_cast<long long>(b) * S + s) * H + kvh * G + gh) *
                    dk + 8 * c));
        uint32_t* w = &x.x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lo = __uint_as_float(w[i] << 16) * scale;
          const float hi = __uint_as_float(w[i] & 0xffff0000u) * scale;
          w[i] = pack_bf16(lo, hi);
        }
      }
      *reinterpret_cast<uint4*>(smem + (c >> 3) * C::Q_PANEL + r * 128 +
                                (((c & 7) ^ (r & 7)) << 4)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the live tiles, each with its warpgroups' bits: (live, full) of
  // consumer 0 at bits 24-25, of consumer 1 at 26-27
  {
    long long bnd[kConsumers][4];
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      const long long* a = red + 8 * c;      // its two warps' partials
      bnd[c][0] = max(a[0], a[4]);
      bnd[c][1] = min(a[1], a[5]);
      bnd[c][2] = min(a[2], a[6]);
      bnd[c][3] = max(a[3], a[7]);
    }
    for (int i = warp; i < n_tiles; i += kWarps) {
      bool live[kConsumers], full[kConsumers];
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) live[c] = false, full[c] = true;
#pragma unroll
      for (int h2 = 0; h2 < BN / 32; ++h2) {
        const int col = i * BN + lane + 32 * h2;
        const long long p = col < T_ ? __ldg(kv_pos + kv_base + col) : 0;
#pragma unroll
        for (int c = 0; c < kConsumers; ++c) {
          live[c] |= col < T_ && p <= bnd[c][0] && p > bnd[c][1];
          full[c] &= col < T_ && p <= bnd[c][2] && p > bnd[c][3];
        }
      }
      int word = i;
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        word |= __any_sync(0xffffffffu, live[c]) << (24 + 2 * c);
        word |= __all_sync(0xffffffffu, full[c]) << (25 + 2 * c);
      }
      if (lane == 0) tiles[i] = word;
    }
    __syncthreads();
    constexpr int kLive = 0x5 << 24;         // either consumer's live bit
    if (warp == 0) {                         // keep the live ones, in order
      int count = 0;
      for (int base = 0; base < n_tiles; base += 32) {
        const int w = base + lane < n_tiles ? tiles[base + lane] : 0;
        const bool f = (w & kLive) != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) tiles[count + __popc(bal & ((1u << lane) - 1))] = w;
        count += __popc(bal);
        __syncwarp();
      }
      if (lane == 0) *n_live_s = count;
    }
    __syncthreads();
  }
  const int n_live = *n_live_s;

  if (tid < 128) {
    // ---- producer: one warp keeps the ring full ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      for (int it = 0; it < n_live; ++it) {
        const int st = it % STAGES;
        bar_wait(empty_bar(st), ((it / STAGES) & 1) ^ 1);
        const int t0 = (tiles[it] & 0xffffff) * BN;
        // the tile's TMA loads first, then its kv_pos beside them (each
        // lane arrives once its entries are written)
        if (lane == 0) {
          const uint32_t dst = sbase + C::OFF_STAGE + st * C::STAGE;
          bar_expect_tx(full_bar(st), C::STAGE);
#pragma unroll
          for (int p = 0; p < C::KP; ++p)
            tma_load(dst + p * C::PANEL, &map_k, full_bar(st), 64 * p, kvh,
                     t0, b);
#pragma unroll
          for (int p = 0; p < C::VP; ++p)
            tma_load(dst + (C::KP + p) * C::PANEL, &map_v, full_bar(st),
                     64 * p, kvh, t0, b);
        }
        for (int c = lane; c < BN; c += 32)
          pos[st * BN + c] = t0 + c < T_ ? __ldg(kv_pos + kv_base + t0 + c)
                                         : INT_MAX;
        bar_arrive(full_bar(st));
      }
    }
  } else {
    // ---- consumers: 64 rows each --------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = (tid >> 7) - 1, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    int hi[2], rr[2];
    long long lo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rr[i] = 64 * c + 16 * wq + g + 8 * i;
      hi[i] = row_hi[rr[i]];
      lo[i] = row_lo[rr[i]];
    }
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};   // l: lane's part
    const uint32_t q_rows = sbase + 64 * c * 128;

    for (int it = 0; it < n_live; ++it) {
      const int st = it % STAGES;
      bar_wait(full_bar(st), (it / STAGES) & 1);
      const int word = tiles[it];
      if ((word >> (24 + 2 * c)) & 1) {
        const bool full = (word >> (25 + 2 * c)) & 1;
        const uint32_t kst = sbase + C::OFF_STAGE + st * C::STAGE;
        const uint32_t vst = kst + C::KP * C::PANEL;
        // S = Q K^T: k-steps of 16 columns, four a 64-column panel
        float s[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
        pin(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          wgmma_ss(s, desc(q_rows + (kk >> 2) * C::Q_PANEL + (kk & 3) * 32,
                           16),
                   desc(kst + (kk >> 2) * C::PANEL + (kk & 3) * 32, 16));
        wgmma_commit_wait();
        pin(s);
        // masks from the staged kv_pos: element (j, e) of the fragment is
        // row g + 8*(e >> 1), key 8j + 2t + (e & 1); a masked score is
        // -inf here, so its weight is 0 (the reference's -1e30 and where())
        if (!full) {
          const int t0 = (word & 0xffffff) * BN;
          const int* ps = pos + st * BN;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int2 p2 =
                *reinterpret_cast<const int2*>(ps + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = 8 * j + 2 * t + (e & 1);
              const long long p = (e & 1) ? p2.y : p2.x;
              const int i = e >> 1;
              const bool ok = t0 + key < T_ && p <= hi[i] && p > lo[i];
              if (!ok) s[4 * j + e] = __int_as_float(0xff800000);  // -inf
            }
          }
        }
        // the online softmax, e^x as 2^(x log2 e)
        float mx[2] = {-1e30f, -1e30f};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float corr[2], ml[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float mn = fmaxf(m[i], mx[i]);
          corr[i] = exp2f((m[i] - mn) * kLog2e);
          m[i] = mn;
          ml[i] = mn * kLog2e;
        }
        float ls[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] = exp2f(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1]));
          ls[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ls[i];
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        }
        // P in bf16 as wgmma's A fragments: k-step kk is n-tiles 2kk and
        // 2kk + 1 of the score fragment
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        pin(o);
        pin(pa);
        wgmma_fence();
        // O += P V: k-steps of 16 keys, 2048 bytes of every V panel apart
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs(o, pa[kk], desc(vst + kk * 2048, C::PANEL));
        wgmma_commit_wait();
        pin(o);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty_bar(st));
    }

    // out = acc / max(l, 1e-30), l summed over the quad; columns past dv
    // (V's zero-filled columns) are not stored.  With `lse`, the row's m +
    // log(l) for the backward (flash_backward.cu), +inf where it has no
    // valid key
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (hi[i] == INT_MIN) continue;         // a row that does not exist
      const int r = rr[i];
      const int s = qb * BQ + r / GS, gh = h0 + r % GS;
      if (lse != nullptr && t == 0)
        lse[(static_cast<long long>(b) * H + kvh * G + gh) * S + s] =
            l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(b) * S + s) * H + kvh * G + gh) * dv;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] / den,
                                    o[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, found
// once a process; null if the driver has none
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The 4-d map (head dim d, kv head, token, batch) of a (B,T,K,d) bf16
// cache, read in boxes of 64 columns x `rows` tokens of one kv head and
// batch row, 128-byte swizzled, zero past each dimension's end
bool cache_map(CUtensorMap* map, const void* base, int d, int K, int T_,
               int B, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(K),
                        static_cast<cuuint64_t>(T_),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {row, row * K, row * K * T_};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, float* lse, int B, int S, int T_,
           int H, int K, int dk, int dv, int causal, int window, float scale,
           int rows, int keys, int stages, int BQ, int GS, int n_blocks,
           cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  const int G = H / K;
  if (rows != kRows || keys != C::BN || stages != C::STAGES || GS < 1 ||
      GS > G || BQ < 1 || BQ * GS > rows || dk > DK || dv > DV ||
      static_cast<long long>(n_blocks) * BQ <
          static_cast<long long>(S) * ((G + GS - 1) / GS))
    return -1;
  CUtensorMap mk, mv;
  if (!cache_map(&mk, k, dk, K, T_, B, C::BN) ||
      !cache_map(&mv, v, dv, K, T_, B, C::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  prefill_wgmma_kernel<DK, DV>
      <<<dim3(n_blocks, K, B), kThreads, C::bytes((T_ + C::BN - 1) / C::BN),
         stream>>>(mk, mv, static_cast<const __nv_bfloat16*>(q), q_pos,
                   kv_pos, static_cast<__nv_bfloat16*>(out), lse, S, T_, H, G,
                   GS, BQ, dk, dv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace

extern "C" {

// The kernel's shared-memory opt-in on the current device (all that a
// block may have) for every instantiation, and a check that the driver
// encodes tensor maps; the wrapper calls it once a device.  Returns a
// cudaError_t.
int flash_prefill_wgmma_prepare() {
  if (wg::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define OPT_IN(DK, DV)                                                      \
  if (cudaError_t err = cudaFuncSetAttribute(                               \
          wg::prefill_wgmma_kernel<DK, DV>,                                 \
          cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem))           \
    return static_cast<int>(err);
  OPT_IN(64, 64) OPT_IN(128, 128) OPT_IN(256, 256) OPT_IN(192, 128)
#undef OPT_IN
  return 0;
}

// S > 1, q/k/v all bf16 and 16-byte aligned, laid out by prefill_plan on
// this route: `width` 64, 128 or 256 (Dk = Dv <= width, a multiple of 8,
// above the next smaller width) or 192 (Dk 192 / Dv 128); `rows` 128,
// `keys` and `stages` the instantiation's (128 keys, 64 at width 256; 4
// stages at 64, else 2), `heads` (GS) heads of one kv head a CTA, BQ
// queries with BQ*GS <= rows, n_blocks = ceil(S/BQ) * ceil(G/GS).  Returns
// a cudaError_t (0 = launched); -1 for a shape or plan it does not take.
// `lse`, where not null, (B,H,S) f32: each row's log-sum-exp in the
// scaled-score units, for the backward.
int flash_prefill_wgmma_launch(const void* q, const void* k, const void* v,
                               const int* q_pos, const int* kv_pos, void* out,
                               float* lse, int B, int S, int T_, int H,
                               int K, int D, int Dv, int causal, int window,
                               float scale,
                               int width, int rows, int keys, int stages,
                               int BQ, int heads, int n_blocks, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || T_ < 1 || D < 8 || D % 8 != 0 || Dv % 8 != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROUTE(W, DK, DV)                                                    \
  if (width == W)                                                           \
    return wg::launch<DK, DV>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_,  \
                              H, K, D, Dv, causal, window, scale, rows,     \
                              keys, stages, BQ, heads, n_blocks, s);
  if (D == Dv) {
    ROUTE(64, 64, 64)
    ROUTE(128, 128, 128)
    ROUTE(256, 256, 256)
  } else if (D == 192 && Dv == 128) {
    ROUTE(192, 192, 128)
  }
#undef ROUTE
  return -1;
}

}  // extern "C"

// Blockwise online-softmax attention forward with GQA and position masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _kernel) in the contract of src/repro/models/attention.py::
// chunked_attention, which is what the serving model runs: q (B,S,H,D),
// k/v (B,T,K,D) with H = K*G, per-row positions q_pos (B,S) and
// kv_pos (B,T) (empty cache slots carry 2**30), key t valid for query s iff
// kv_pos[t] <= q_pos[s] when causal and, with a sliding window W > 0, also
// kv_pos[t] > q_pos[s] - W.  Running max, sum and accumulator are f32; a
// masked score is -1e30 and the sum is floored at 1e-30, so a row with no
// valid key gives 0.  Not taken yet: int8 scales (no entry), and, raising
// in the wrapper, Dv != Dk (MLA) and head_dim outside 16/32/64/128/256;
// ROADMAP Queue 2 lists them under K3.
//
// q and k/v may differ in dtype (bf16 weights over the Engine's f32 cache
// give bf16 q over f32 K/V); k and v share one.  The kernels follow the
// reference's order of rounding (attention.py:85, :100, :126): q is scaled
// in its own dtype, then widened; scores, softmax and the accumulator are
// f32; the output is written in q's dtype.  Both kernels are templates on
// q's dtype TQ and the cache's TKV and read each in its own width: the
// wrapper casts nothing.  A product with an f32 operand takes the f32 path
// (3xTF32 in the prefill); only all-bf16 inputs run bf16 products.
//
// Two kernels share that contract: the tensor-core prefill kernel here and
// the split-KV decode kernel in flash_decode.cu (the two build in parallel;
// flash_common.cuh holds what they share).  The wrapper launches decode
// when S = 1 and prefill otherwise; it copies q/k/v that do not start on a
// 16-byte boundary first.
//
// Bounds on the H100.  Decode (S = 1) is bound by bytes: it reads each
// valid K/V row once for 2*G*D FMAs per key and head group, 8 FLOP per
// 4-byte element at G = 8 (tinyllama; 2 at gemma3's G = 2), far below the
// 67 TFLOP/s f32 / 3.35 TB/s = 20 FLOP/byte ridge: gemma3's ring decode
// (4 rows, 16 kv heads, D 128, 1024 slots, f32) reads 48 MB, 14.4 us.
// Prefill is bound by operations: 4*H*D FLOP per valid (query, key) pair,
// 16.6 GFLOP for gemma3's 1500-token prefill under window 1024, 0.2475 ms
// at the 67 TFLOP/s of f32 outside the tensor cores.  On the tensor cores
// the f32 path runs three TF32 products for each (below), so its own bound
// is 3 x 16.6 GFLOP / 495 TFLOP/s = 0.1006 ms; bf16 runs one product at
// 989 TFLOP/s, 0.0168 ms.
//
// Prefill design (tensor cores, mma.sync).  One CTA per (batch row, kv
// head, block of BQ queries) holds all G query heads of its kv head: 128
// (query, head) rows up to head dim 128, 16 to each of 8 warps (64 rows at
// head dim 256, below), so the GQA routing is
// index math and each K/V tile is read once per head group
// (kernels/flash_attention.py::prefill_plan lays out the grid).  The CTA
// first lists its live tiles of kBN = 64 keys: those holding a key that
// some row can see (kv_pos <= the largest row bound and > the smallest
// q_pos - W, 64-bit), so fully masked tiles are never loaded.  K, V and
// kv_pos of the live tiles stream through a two-stage ring (one stage for
// f32 at head dim 256, below) in shared
// memory with cp.async (16-byte copies, zero-filled past T, one commit
// group a tile): tile i + 1 loads while tile i is computed, one
// __syncthreads a tile.  The last query blocks, which see the most keys,
// are launched first.  Each warp skips the 8-key n-tiles of a tile that
// none of its rows can see.  The products are warp-level MMAs (mma.sync):
//   f32:  3xTF32.  Each operand x is split into hi = tf32(x) (to nearest,
//         ties away: cvt.rna's rounding, done in two integer ops) and
//         lo = x - hi, and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the
//         small terms first, accumulated in f32 by m16n8k8 TF32 MMAs
//         (HMMA).  The dropped a_lo.b_lo and lo's truncation leave about
//         2**-21 of each product, which holds the reference's 3e-5 bar; a
//         single TF32 pass (2**-11) does not (tests/test_torch_prefill.py).
//         Q (scaled in f32) sits in shared memory beside the ring; the
//         head dim is read in a permuted order that Q and K share, so a
//         lane loads 16-32 contiguous bytes a row; K rows are padded to
//         D + 4 floats.  The keys of each PV k-step are permuted so that P's
//         accumulator fragment is its A fragment, and the output columns so
//         that a lane reads contiguous V and writes D/4 contiguous floats;
//         V's 16-byte chunks are XOR-swizzled instead of padded.
//   bf16: m16n8k16 bf16 MMAs with f32 accumulators: Q's fragments (scaled
//         in bf16) in registers, K from ldmatrix, V from ldmatrix.trans,
//         P rounded to bf16 for PV; K/V rows padded to D + 8.
//   mixed: bf16 q over f32 K/V stages Q as f32 after its bf16 rounding;
//         f32 q over bf16 K/V widens each bf16 K/V chunk to f32 on its way
//         into shared memory (plain loads: cp.async cannot convert), whose
//         TF32 split is exact (lo = 0).
// Head dim 256 (gemma-7b).  A warp's accumulator of 16 rows by 256 columns
// (128 registers) does not fit beside the scores, so two warps share each
// 16-row block: both compute its scores in full, and each keeps D/2
// output columns (DO), so a CTA holds 64 rows.  In f32 the 64-row Q and one
// K/V tile take 194 KB, so the ring has one stage (the next tile loads
// after the last warp is done with this one); bf16 keeps two stages and
// reads Q's fragments from shared memory with ldmatrix instead of holding
// them in registers.
// mma.sync, not wgmma: TF32 wgmma reads B, and A unless it sits in
// registers, as K-major tiles in shared memory, so 3xTF32 would need the
// hi and lo halves of K, of a transposed V and (for want of registers) of
// Q there: at D = 128 in f32 that is more than the 227 KB a CTA has.  The
// warp-level MMAs take both halves from registers, split where they are
// loaded.
// The scores' masks come from each key's staged kv_pos, never from the
// slot index (a ring cache holds token t in slot t % W), and the row max
// and sum from the quad of lanes that share a row of the accumulator
// fragment; e^x is exp2f(x log2 e) (one FFMA, then 2^x to 2 ulp), and the
// accumulator is rescaled only in the tiles where some row's max moved.
//
// Later work: wgmma (warpgroup MMAs from shared memory; TF32 wgmma takes
// K-major operands only, so V needs a transposed copy) and TMA tensor-map
// loads, which would free the registers and the issue slots the fragment
// loads and splits take; at head dim 256, a second stage (32-key tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

// ---- prefill on tensor cores ---------------------------------------------

namespace pf {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 64;              // keys a tile
constexpr int kNT = kBN / 8;         // n-tiles of 8 keys in a tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// TF32 of x rounded to nearest, ties away from zero (cvt.rna's rounding
// of a finite x), as the register the MMA takes: half an ulp of TF32 added
// to the magnitude bits, then the low 13 bits cleared, in two integer ops
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo: hi its TF32 rounding, lo the rest, passed whole (the MMA
// reads its top 19 bits, which drops terms below 2**-21 of x)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The type the products run in: bf16 only when q and K/V are both bf16; an
// f32 operand on either side takes the f32 (3xTF32) path.
template <typename TQ, typename TKV> struct Path { using T = float; };
template <> struct Path<__nv_bfloat16, __nv_bfloat16> {
  using T = __nv_bfloat16;
};

// Rows by head dim: WPR warps share each 16-row block, each computing its
// scores and DO = D / WPR output columns; a CTA holds ROWS (query, head)
// rows.  Two warps a block at D = 256 (the accumulator of 256 columns does
// not fit a warp's registers), one below.
template <int D> struct Geom {
  static constexpr int WPR = D > 128 ? 2 : 1;
  static constexpr int ROWS = 16 * kWarps / WPR;
  static constexpr int DO = D / WPR;
};

// Shared-memory layout of one compute type and head dim (element strides).
//   f32:  K (and Q) rows padded to D + 4 floats, so the 16-byte fragment
//         loads of 8 lanes fall on 8 distinct bank groups; V rows unpadded
//         with their 16-byte chunks XOR-swizzled by vswz (below).  Q is
//         staged here; at D = 256 the ring has one stage (194 KB with Q).
//   bf16: K and V rows padded to D + 8, so the 8 rows of an ldmatrix fall
//         on 8 distinct bank groups; Q in registers, or at D = 256 here,
//         padded the same way.
template <typename T, int D> struct Layout;
template <int D> struct Layout<float, D> {
  static constexpr int KS = D + 4, VS = D, QS = D + 4;
  static constexpr int KPB = D >= 32 ? 4 : D / 8;   // k-steps a K load
  static constexpr int STAGES = D > 128 ? 1 : 2;     // K/V tiles in flight
  static constexpr int q_elems = Geom<D>::ROWS * QS;
};
template <int D> struct Layout<__nv_bfloat16, D> {
  static constexpr int KS = D + 8, VS = D + 8, QS = D > 128 ? D + 8 : 0;
  static constexpr int KPB = 0;
  static constexpr int STAGES = 2;
  static constexpr int q_elems = Geom<D>::ROWS * QS;
};

template <typename T, int D> struct Smem {
  using L = Layout<T, D>;
  static constexpr int k_elems = kBN * L::KS, v_elems = kBN * L::VS;
  static constexpr size_t stage_bytes =
      sizeof(T) * (k_elems + v_elems) + sizeof(int) * kBN;
  static constexpr size_t q_bytes = sizeof(T) * L::q_elems;
  // the ring, then Q, then the CTA's live-tile list
  static size_t bytes(int n_tiles) {
    return L::STAGES * stage_bytes + q_bytes + sizeof(int) * n_tiles;
  }
};

// The f32 V tile's chunk swizzle: logical 16-byte chunk c of key row r lies
// at chunk c ^ vswz(r).  A lane of the PV product reads rows 2t and 2t + 1
// (t its quad index) at chunks (D/32)*g + j; the swizzle spreads t over the
// chunk bits that g does not use, so the 8 lanes of a phase hit 8 distinct
// bank groups.
template <int D> __device__ __forceinline__ int vswz(int r) {
  const int t = (r >> 1) & 3;
  if constexpr (D >= 128) return t;
  else if constexpr (D == 64) return (t & 1) | ((t & 2) << 1);
  else if constexpr (D == 32) return t << 1;
  else return t;                                  // D = 16: 4 chunks a row
}

// ---- the two products of a tile, per warp --------------------------------

// Consecutive MMAs go to different accumulators (groups of kJG n-tiles):
// ILP for the MMA pipe, with 8 warps an SM.
constexpr int kJG = 4;

// c[jj] += a.b[jj] in 3xTF32 for NG accumulators: the two small products
// of every accumulator first, then the large ones
template <int NG>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const float (*b)[2]) {
  uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
  for (int jj = 0; jj < NG; ++jj) {
    split(b[jj][0], bh[jj][0], bl[jj][0]);
    split(b[jj][1], bh[jj][1], bl[jj][1]);
  }
#pragma unroll
  for (int jj = 0; jj < NG; ++jj) mma_tf32(c[jj], alo, bh[jj][0], bh[jj][1]);
#pragma unroll
  for (int jj = 0; jj < NG; ++jj) mma_tf32(c[jj], ahi, bl[jj][0], bl[jj][1]);
#pragma unroll
  for (int jj = 0; jj < NG; ++jj) mma_tf32(c[jj], ahi, bh[jj][0], bh[jj][1]);
}

// f32: s[j] (keys 8j..8j+7 of the tile) += Q K^T for the warp's 16 rows.
// Both operands read the head dim in the same permuted order: in k-block
// `blk` of KPB k-steps, lane t holds dims blk*8*KPB + 2*KPB*t + 2*kk + {0,1}
// for k-step kk, its slots t and t + 4 of the TF32 fragment, so each row is
// one 2*KPB-float load.
template <int D>
__device__ __forceinline__ void qk_tile(float (*s)[4], const float* Qw,
                                        const float* Ks, int g, int t,
                                        unsigned long long live) {
  using L = Layout<float, D>;
  constexpr int KPB = L::KPB, RL = 2 * KPB, NB = D / (8 * KPB);
#pragma unroll
  for (int blk = 0; blk < NB; ++blk) {
    alignas(16) float a0[RL];
    alignas(16) float a1[RL];
    const int col = blk * 8 * KPB + RL * t;
#pragma unroll
    for (int e = 0; e < RL; e += 4) {
      *reinterpret_cast<float4*>(a0 + e) =
          *reinterpret_cast<const float4*>(Qw + g * L::QS + col + e);
      *reinterpret_cast<float4*>(a1 + e) =
          *reinterpret_cast<const float4*>(Qw + (g + 8) * L::QS + col + e);
    }
    uint32_t ahi[KPB][4], alo[KPB][4];
#pragma unroll
    for (int kk = 0; kk < KPB; ++kk) {
      split(a0[2 * kk], ahi[kk][0], alo[kk][0]);       // (g, t)
      split(a1[2 * kk], ahi[kk][1], alo[kk][1]);       // (g + 8, t)
      split(a0[2 * kk + 1], ahi[kk][2], alo[kk][2]);   // (g, t + 4)
      split(a1[2 * kk + 1], ahi[kk][3], alo[kk][3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kJG) {
      if (!((live >> (8 * j0)) & ((1ull << (8 * kJG)) - 1))) continue;
      alignas(16) float b[kJG][RL];
#pragma unroll
      for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
        for (int e = 0; e < RL; e += 4)
          *reinterpret_cast<float4*>(b[jj] + e) =
              *reinterpret_cast<const float4*>(
                  Ks + (8 * (j0 + jj) + g) * L::KS + col + e);
#pragma unroll
      for (int kk = 0; kk < KPB; ++kk) {
        float bk[kJG][2];
#pragma unroll
        for (int jj = 0; jj < kJG; ++jj) {
          bk[jj][0] = b[jj][2 * kk];
          bk[jj][1] = b[jj][2 * kk + 1];
        }
        mma_3xtf32<kJG>(s + j0, ahi[kk], alo[kk], bk);
      }
    }
  }
}

// f32: o += P V for the warp's DO output columns from half*DO on.  The
// keys of k-step jj are ordered so that P's accumulator fragment is its A
// fragment as it stands: slot t of the fragment is key 8jj + 2t, slot
// t + 4 key 8jj + 2t + 1.  Output column n of n-tile nt is physical column
// half*DO + (DO/8)*n + nt, so a lane reads the DO/8 contiguous floats
// half*DO + (DO/8)*g.. of its two key rows, and writes DO/4 contiguous
// output floats a row.
template <int D, int DO>
__device__ __forceinline__ void pv_tile(float (*o)[4], const float (*p)[4],
                                        const float* Vs, int g, int t,
                                        unsigned long long live, int half) {
  constexpr int W = DO / 8;                    // floats a lane reads a row
  constexpr int NG = W < kJG ? W : kJG;        // accumulators a group
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    if (!((live >> (8 * jj)) & 0xffull)) continue;   // P is 0 there
    uint32_t ahi[4], alo[4];
    split(p[jj][0], ahi[0], alo[0]);           // (g, key 2t)
    split(p[jj][2], ahi[1], alo[1]);           // (g + 8, key 2t)
    split(p[jj][1], ahi[2], alo[2]);           // (g, key 2t + 1)
    split(p[jj][3], ahi[3], alo[3]);           // (g + 8, key 2t + 1)
    const int r0 = 8 * jj + 2 * t;
    alignas(16) float va[W];
    alignas(16) float vb[W];
    if constexpr (W >= 4) {
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const int lc = half * (DO / 4) + (W / 4) * g + c;   // logical chunk
        *reinterpret_cast<float4*>(va + 4 * c) =
            *reinterpret_cast<const float4*>(Vs + r0 * D +
                                             4 * (lc ^ vswz<D>(r0)));
        *reinterpret_cast<float4*>(vb + 4 * c) =
            *reinterpret_cast<const float4*>(Vs + (r0 + 1) * D +
                                             4 * (lc ^ vswz<D>(r0 + 1)));
      }
    } else {                                   // D = 16: half a chunk
      const int x = 2 * g;
      *reinterpret_cast<float2*>(va) = *reinterpret_cast<const float2*>(
          Vs + r0 * D + 4 * ((x >> 2) ^ vswz<D>(r0)) + (x & 3));
      *reinterpret_cast<float2*>(vb) = *reinterpret_cast<const float2*>(
          Vs + (r0 + 1) * D + 4 * ((x >> 2) ^ vswz<D>(r0 + 1)) + (x & 3));
    }
#pragma unroll
    for (int n0 = 0; n0 < W; n0 += NG) {
      float bk[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        bk[n][0] = va[n0 + n];
        bk[n][1] = vb[n0 + n];
      }
      mma_3xtf32<NG>(o + n0, ahi, alo, bk);
    }
  }
}

// bf16: s += Q K^T with Q's fragments in registers (qa[kk] for k-step kk,
// the natural m16n8k16 layout) or, at D = 256, from the warp's 16 rows of
// Q in shared memory (Qw) by ldmatrix, and K's from ldmatrix.
template <int D>
__device__ __forceinline__ void qk_tile_bf16(float (*s)[4],
                                             const uint32_t (*qa)[4],
                                             const __nv_bfloat16* Qw,
                                             const __nv_bfloat16* Ks,
                                             int lane,
                                             unsigned long long live) {
  using L = Layout<__nv_bfloat16, D>;
  constexpr int KS = L::KS;
  const __nv_bfloat16* row = Ks + (lane & 7) * KS;
  if constexpr (D >= 32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t a0[4], a1[4];                   // Q of k-steps kk and kk + 1
      if constexpr (L::QS > 0) {
        const __nv_bfloat16* qrow = Qw + (lane & 15) * L::QS +
                                    8 * (lane >> 4);
        ldsm_x4(a0, qrow + 16 * kk);
        ldsm_x4(a1, qrow + 16 * (kk + 1));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a0[e] = qa[kk][e];
          a1[e] = qa[kk + 1][e];
        }
      }
      uint32_t r[kNT][4];                      // k-steps kk and kk + 1
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (!((live >> (8 * j)) & 0xffull)) continue;
        ldsm_x4(r[j], row + 8 * j * KS + 16 * kk + 8 * (lane >> 3));
        mma_bf16(s[j], a0, r[j][0], r[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (!((live >> (8 * j)) & 0xffull)) continue;
        mma_bf16(s[j], a1, r[j][2], r[j][3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (!((live >> (8 * j)) & 0xffull)) continue;
      uint32_t r[2];
      ldsm_x2(r, row + 8 * j * KS + 8 * ((lane >> 3) & 1));
      mma_bf16(s[j], qa[0], r[0], r[1]);
    }
  }
}

// bf16: o += P V with P rounded to bf16 (the accumulator fragments of two
// key n-tiles are the A fragment of one k-step) and V's fragments from
// ldmatrix.trans; output n-tile nt is columns half*DO + 8nt..+7.
template <int D, int DO>
__device__ __forceinline__ void pv_tile_bf16(float (*o)[4],
                                             const float (*p)[4],
                                             const __nv_bfloat16* Vs,
                                             int lane,
                                             unsigned long long live,
                                             int half) {
  constexpr int VS = Layout<__nv_bfloat16, D>::VS;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    if (!((live >> (16 * kk)) & 0xffffull)) continue;   // P is 0 there
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* row =
        Vs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * VS + half * DO;
#pragma unroll
    for (int nt = 0; nt < DO / 8; nt += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, row + 8 * (nt + (lane >> 4)));
      mma_bf16(o[nt], a, r[0], r[1]);
      mma_bf16(o[nt + 1], a, r[2], r[3]);
    }
  }
}

// ---- the kernel -------------------------------------------------------

// One CTA: batch row b = blockIdx.z, kv head kvh = blockIdx.y, query block
// qb = gridDim.x - 1 - blockIdx.x.  Row r < BQ*G of the CTA is query
// s = qb*BQ + r / G of head kvh*G + r % G
// (kernels/flash_attention.py::prefill_plan and prefill_row).  Warp w owns
// rows 16rb..16rb+15 of row block rb = w / WPR and the output columns
// half*DO.. (half = w % WPR); its lane (g = lane / 4, t = lane % 4) holds
// rows 16rb + g and 16rb + g + 8 of every fragment.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
               const TKV* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ kv_pos, TQ* __restrict__ out, int S,
               int T_, int H, int K, int G, int BQ, int causal, int window,
               float scale) {
  using C = typename Path<TQ, TKV>::T;         // the products' type
  using L = Layout<C, D>;
  using SM = Smem<C, D>;
  constexpr bool kF32 = sizeof(C) == 4;
  constexpr int WPR = Geom<D>::WPR, DO = Geom<D>::DO, ROWS = Geom<D>::ROWS;
  constexpr int NO = DO / 8;                   // output n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int w_hi[kWarps];
  __shared__ long long w_lo[kWarps];
  __shared__ int n_live_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp / WPR, half = warp % WPR;
  // the last query blocks, which see the most keys, start first
  const int qb = gridDim.x - 1 - blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T_ + kBN - 1) / kBN;
  C* Qs = reinterpret_cast<C*>(smem + L::STAGES * SM::stage_bytes);
  int* tiles = reinterpret_cast<int*>(smem + L::STAGES * SM::stage_bytes +
                                      SM::q_bytes);

  // the lane's two rows: existence, head, query, and key bounds; key p is
  // valid for the row iff p <= hi and p > lo (64-bit: q_pos - W may not fit
  // in an int)
  int row_h[2], row_s[2], hi[2];
  long long lo[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rb * 16 + g + 8 * i;
    const int s = qb * BQ + r / G;
    row_ok[i] = r < BQ * G && s < S;
    row_s[i] = s;
    row_h[i] = kvh * G + r % G;
    const int qp = row_ok[i] ? q_pos[static_cast<long long>(b) * S + s] : 0;
    hi[i] = !row_ok[i] ? INT_MIN : (causal ? qp : INT_MAX);
    lo[i] = !row_ok[i] ? LLONG_MAX
                       : (window > 0 ? static_cast<long long>(qp) - window
                                     : LLONG_MIN);
  }
  // the warp's loosest bounds (a key outside them is masked for every row
  // of the warp) and tightest (a key inside them is valid for all its rows)
  int whi = max(hi[0], hi[1]), whi_min = min(hi[0], hi[1]);
  long long wlo = min(lo[0], lo[1]), wlo_max = max(lo[0], lo[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, o));
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
    whi_min = min(whi_min, __shfl_xor_sync(0xffffffffu, whi_min, o));
    wlo_max = max(wlo_max, __shfl_xor_sync(0xffffffffu, wlo_max, o));
  }
  if (lane == 0) {
    w_hi[warp] = whi;
    w_lo[warp] = wlo;
  }

  // Q, scaled in its own dtype (as the reference scales it): into shared
  // memory in the products' type (f32; bf16 at D = 256), or as bf16
  // fragments into registers
  uint32_t qa[kF32 || L::QS > 0 ? 1 : D / 16][4];
  if constexpr (L::QS > 0) {
    constexpr int EPC = 16 / sizeof(C);        // elements a 16-byte chunk
    for (int idx = tid; idx < ROWS * (D / EPC); idx += kThreads) {
      const int r = idx / (D / EPC), c = idx % (D / EPC);
      const int s = qb * BQ + r / G;
      alignas(16) C x[EPC];
      const bool ok = r < BQ * G && s < S;
      const TQ* src = q + ((static_cast<long long>(b) * S + (ok ? s : 0)) *
                           H + kvh * G + r % G) * D + EPC * c;
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        x[e] = from_f<C>(ok ? scaled(src[e], scale) : 0.f);
      *reinterpret_cast<uint4*>(Qs + r * L::QS + EPC * c) =
          *reinterpret_cast<const uint4*>(x);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1;                    // row g or g + 8
        const int d = 16 * kk + 8 * (e >> 1) + 2 * t;
        uint32_t w = 0;
        if (row_ok[i]) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              q + ((static_cast<long long>(b) * S + row_s[i]) * H +
                   row_h[i]) * D + d);
          w = pack_bf16(
              __bfloat162float(__float2bfloat16(__low2float(x) * scale)),
              __bfloat162float(__float2bfloat16(__high2float(x) * scale)));
        }
        qa[kk][e] = w;
      }
  }
  __syncthreads();

  // The live tiles: those holding a key that some row of the CTA can see.
  {
    int chi = INT_MIN;
    long long clo = LLONG_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      chi = max(chi, w_hi[w]);
      clo = min(clo, w_lo[w]);
    }
    const long long kv_base = static_cast<long long>(b) * T_;
    for (int i = warp; i < n_tiles; i += kWarps) {
      bool live = false;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = i * kBN + lane + 32 * h2;
        if (col < T_) {
          const int p = __ldg(kv_pos + kv_base + col);
          live |= p <= chi && static_cast<long long>(p) > clo;
        }
      }
      live = __any_sync(0xffffffffu, live);
      if (lane == 0) tiles[i] = live;
    }
    __syncthreads();
    if (warp == 0) {                           // compact the flags in place
      int count = 0;
      for (int base = 0; base < n_tiles; base += 32) {
        const bool f = base + lane < n_tiles && tiles[base + lane];
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) tiles[count + __popc(bal & ((1u << lane) - 1))] = base + lane;
        count += __popc(bal);
        __syncwarp();
      }
      if (lane == 0) n_live_s = count;
    }
    __syncthreads();
  }
  const int n_live = n_live_s;

  // one tile's K, V and kv_pos into ring stage st, zero-filled past T:
  // cp.async when K/V are already in the products' type; bf16 K/V on the
  // f32 path are widened on the way (plain loads: the copy engine cannot
  // convert), each 16-byte chunk of 8 values into two f32 chunks
  auto load_tile = [&](int tile, int st) {
    unsigned char* base = smem + st * SM::stage_bytes;
    C* Ks = reinterpret_cast<C*>(base);
    C* Vs = Ks + SM::k_elems;
    int* Ps = reinterpret_cast<int*>(Vs + SM::v_elems);
    constexpr int CPR = D * sizeof(TKV) / 16;  // 16-byte chunks a row
    constexpr int EPC = 16 / sizeof(TKV);      // elements a chunk
    const int t0 = tile * kBN;
    for (int idx = tid; idx < kBN * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const int key = t0 + r;
      const bool ok = key < T_;
      const long long off =
          ok ? ((static_cast<long long>(b) * T_ + key) * K + kvh) * D +
                   c * EPC
             : 0;
      if constexpr (std::is_same<C, TKV>::value) {
        cp_async16(Ks + r * L::KS + c * EPC, k + off, ok);
        int vc = c;
        if constexpr (kF32) vc = c ^ vswz<D>(r);
        cp_async16(Vs + r * L::VS + vc * EPC, v + off, ok);
      } else {
        uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
        if (ok) {
          kr = __ldg(reinterpret_cast<const uint4*>(k + off));
          vr = __ldg(reinterpret_cast<const uint4*>(v + off));
        }
        alignas(16) float kf[8];
        alignas(16) float vf[8];
        Vec16<__nv_bfloat16>::widen(kr, kf);
        Vec16<__nv_bfloat16>::widen(vr, vf);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          *reinterpret_cast<float4*>(Ks + r * L::KS + 8 * c + 4 * hh) =
              *reinterpret_cast<const float4*>(kf + 4 * hh);
          *reinterpret_cast<float4*>(
              Vs + r * L::VS + 4 * ((2 * c + hh) ^ vswz<D>(r))) =
              *reinterpret_cast<const float4*>(vf + 4 * hh);
        }
      }
    }
    if (tid < kBN) {
      const int key = t0 + tid;
      const bool ok = key < T_;
      cp_async4(Ps + tid,
                kv_pos + (ok ? static_cast<long long>(b) * T_ + key : 0), ok);
    }
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: lane's part

  if (n_live > 0) load_tile(tiles[0], 0);
  cp_commit();
  for (int it = 0; it < n_live; ++it) {
    const int st = it % L::STAGES;
    cp_wait_all();                              // tile it has landed
    // every thread's copies of tile it are visible, and (two stages) every
    // warp is done with tile it - 1, whose stage the next load refills
    __syncthreads();
    if constexpr (L::STAGES > 1) {
      if (it + 1 < n_live) load_tile(tiles[it + 1], (it + 1) % L::STAGES);
      cp_commit();
    }

    const int t0 = tiles[it] * kBN;
    const unsigned char* base = smem + st * SM::stage_bytes;
    const C* Ks = reinterpret_cast<const C*>(base);
    const C* Vs = Ks + SM::k_elems;
    const int* Ps = reinterpret_cast<const int*>(Vs + SM::v_elems);
    // bit c of `live`: some row of this warp sees key c; the products skip
    // the 8-key n-tiles no row sees (all of them when live is 0), and the
    // masks are skipped when every row sees every key (`full`)
    bool seen[2], all = true;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = lane + 32 * h2;
      const int p = Ps[c];
      seen[h2] = t0 + c < T_ && p <= whi && static_cast<long long>(p) > wlo;
      all &= t0 + c < T_ && p <= whi_min &&
             static_cast<long long>(p) > wlo_max;
    }
    const bool full = __all_sync(0xffffffffu, all);
    const unsigned long long live =
        __ballot_sync(0xffffffffu, seen[0]) |
        static_cast<unsigned long long>(__ballot_sync(0xffffffffu, seen[1]))
            << 32;
    if (live) {
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (kF32)
        qk_tile<D>(s, reinterpret_cast<const float*>(Qs) + rb * 16 * L::QS,
                   reinterpret_cast<const float*>(Ks), g, t, live);
      else
        qk_tile_bf16<D>(s, qa,
                        reinterpret_cast<const __nv_bfloat16*>(Qs) +
                            rb * 16 * L::QS,
                        reinterpret_cast<const __nv_bfloat16*>(Ks), lane,
                        live);

      // masks from the staged kv_pos; the online softmax on the fragments:
      // element (j, e) is row g + 8*(e >> 1), key 8j + 2t + (e & 1)
      unsigned valid = 0xffffffffu;
      if (!full) {
        valid = 0;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            const int p = Ps[c];
            const int i = e >> 1;
            const bool ok = t0 + c < T_ && p <= hi[i] &&
                            static_cast<long long>(p) > lo[i];
            s[j][e] = ok ? s[j][e] : kNegInf;
            valid |= static_cast<unsigned>(ok) << (4 * j + e);
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      // e^x as 2^(x log2 e): one FFMA and exp2f (2 ulp) an element
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
      if (full) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
            ls[e >> 1] += s[j][e];
          }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p = (valid >> (4 * j + e)) & 1u
                                ? exp2f(fmaf(s[j][e], kLog2e, -ml[i])) : 0.f;
            s[j][e] = p;
            ls[i] += p;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ls[i];
      // rescale the accumulator only where some row's max moved
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= corr[0]; o[n][1] *= corr[0];
          o[n][2] *= corr[1]; o[n][3] *= corr[1];
        }
      }
      if constexpr (kF32)
        pv_tile<D, DO>(o, s, reinterpret_cast<const float*>(Vs), g, t, live,
                       half);
      else
        pv_tile_bf16<D, DO>(o, s,
                            reinterpret_cast<const __nv_bfloat16*>(Vs), lane,
                            live, half);
    }
    if constexpr (L::STAGES == 1) {
      __syncthreads();                  // every warp is done with the stage
      if (it + 1 < n_live) load_tile(tiles[it + 1], 0);
      cp_commit();
    }
  }

  // out = acc / max(l, 1e-30), l summed over the quad, in q's dtype
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (!row_ok[i]) continue;
    const float den = fmaxf(l[i], 1e-30f);
    TQ* orow = out + ((static_cast<long long>(b) * S + row_s[i]) * H +
                      row_h[i]) * D + half * DO;
    if constexpr (kF32) {
      // lane t holds columns (DO/4)t.. : o[n][2i] at (DO/8)*2t + n, then
      // o[n][2i + 1] at (DO/8)*(2t + 1) + n
      TQ* dst = orow + (DO / 4) * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        dst[n] = from_f<TQ>(o[n][2 * i] / den);
        dst[NO + n] = from_f<TQ>(o[n][2 * i + 1] / den);
      }
    } else {
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
  }
}

// A launch laid out by prefill_plan: -1 when its rows or stages are not
// this instantiation's.
template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, int B, int S, int T_, int H, int K,
           int causal, int window, float scale, int rows, int stages, int BQ,
           int n_qblocks, cudaStream_t stream) {
  using C = typename Path<TQ, TKV>::T;
  if (rows != Geom<D>::ROWS || stages != Layout<C, D>::STAGES ||
      BQ * (H / K) > rows)
    return -1;
  const size_t smem = Smem<C, D>::bytes((T_ + kBN - 1) / kBN);
  dim3 grid(n_qblocks, K, B);
  prefill_kernel<TQ, TKV, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), q_pos, kv_pos, static_cast<TQ*>(out), S,
      T_, H, K, H / K, BQ, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace pf


}  // namespace


extern "C" {

// The prefill kernel's shared-memory opt-in on the current device (all
// that a block may have beside its static shared memory) for every
// instantiation; the wrapper calls it once a device, before that device's
// first launch.  Returns a cudaError_t.
int flash_attention_prepare() {
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
#define OPT_IN(TQ, TKV, DD)                                                 \
  if (cudaError_t err = cudaFuncGetAttributes(                              \
          &attr, pf::prefill_kernel<TQ, TKV, DD>))                          \
    return static_cast<int>(err);                                           \
  if (cudaError_t err = cudaFuncSetAttribute(                               \
          pf::prefill_kernel<TQ, TKV, DD>,                                  \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          max_smem - static_cast<int>(attr.sharedSizeBytes)))               \
    return static_cast<int>(err);
#define OPT_IN_D(DD)                                                        \
  OPT_IN(float, float, DD) OPT_IN(__nv_bfloat16, __nv_bfloat16, DD)         \
  OPT_IN(__nv_bfloat16, float, DD) OPT_IN(float, __nv_bfloat16, DD)
  OPT_IN_D(16) OPT_IN_D(32) OPT_IN_D(64) OPT_IN_D(128) OPT_IN_D(256)
#undef OPT_IN_D
#undef OPT_IN
  return 0;
}

// S > 1, laid out by prefill_plan: `rows` (query, head) rows a CTA and
// `stages` tiles in flight must be the instantiation's (128 and 2 up to
// head dim 128; 64 at 256, with one stage on the f32 path), `keys` keys a
// tile 64; BQ queries a CTA with BQ*G <= rows, n_qblocks*BQ >= S.  q/k/v
// start on 16-byte boundaries.  dtype_q, dtype_kv: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = launched; an invalid-value
// error when T needs more shared memory than the device has); -1 for a
// shape or plan this kernel does not take.
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         int B, int S, int T_, int H, int K, int D,
                         int causal, int window, float scale, int dtype_q,
                         int dtype_kv, int rows, int keys, int stages, int BQ,
                         int n_qblocks, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || keys != pf::kBN || BQ < 1 ||
      static_cast<long long>(n_qblocks) * BQ < S || T_ < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PREFILL(TQ, TKV, CQ, CKV, DD)                                       \
  if (D == DD && dtype_q == CQ && dtype_kv == CKV)                          \
    return pf::launch<TQ, TKV, DD>(q, k, v, q_pos, kv_pos, out, B, S, T_,   \
                                   H, K, causal, window, scale, rows,       \
                                   stages, BQ, n_qblocks, s);
#define PREFILL_D(DD)                                                       \
  PREFILL(float, float, 0, 0, DD)                                           \
  PREFILL(__nv_bfloat16, __nv_bfloat16, 1, 1, DD)                           \
  PREFILL(__nv_bfloat16, float, 1, 0, DD)                                   \
  PREFILL(float, __nv_bfloat16, 0, 1, DD)
  PREFILL_D(16)
  PREFILL_D(32)
  PREFILL_D(64)
  PREFILL_D(128)
  PREFILL_D(256)
#undef PREFILL_D
#undef PREFILL
  return -1;
}

}  // extern "C"

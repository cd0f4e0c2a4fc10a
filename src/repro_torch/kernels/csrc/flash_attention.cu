// Blockwise online-softmax attention forward with GQA and position masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _kernel) in the contract of src/repro/models/attention.py::
// chunked_attention, which is what the serving model runs: q (B,S,H,Dk),
// k (B,T,K,Dk), v (B,T,K,Dv) with H = K*G, per-row positions q_pos (B,S) and
// kv_pos (B,T) (empty cache slots carry 2**30), key t valid for query s iff
// kv_pos[t] <= q_pos[s] when causal and, with a sliding window W > 0, also
// kv_pos[t] > q_pos[s] - W.  Running max, sum and accumulator are f32; a
// masked score is -1e30 and the sum is floored at 1e-30, so a row with no
// valid key gives 0.  Head dims: Dk = Dv any multiple of 8 from 8 to 512,
// and here in the prefill also Dk 192 / Dv 128 (MLA's expanded K and V:
// deepseek-v2).  A head dim D that is an unpadded width (16, 32, 64, 128,
// 256, 512) runs in that width's template as it is, a CTA holding a whole
// group; any other, or a group cut into head slices (below), runs in the
// general template (kGen) of the smallest of 64, 96, 128, 256, 512 at or
// above it (the wrapper's tile_width): the true D is a runtime argument,
// columns D..DP of the Q and K tiles are zero-filled in shared memory
// (cp.async's src-size operand, or a zero where a load is widened), V's
// extra output columns are computed from zeros and never stored, and the
// caches are read where they lie, at their true row length.  At a named
// shape the zero columns are at most a quarter of the tile (72 -> 96, 224
// -> 256).  The general template is apart so that the unpadded ones keep
// their unmasked loads and stores and the row math of a whole group (on
// an H100 the masks cost them 3-14% of device time: attention_ab.py).  Not
// taken yet: int8 scales (no entry), and, raising in the wrapper, any
// other (Dk, Dv), a head dim above 512 or not a multiple of 8, and Dv !=
// Dk in decode; ROADMAP Queue 2 lists them under K3.
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
// Three kernels share that contract: the tensor-core prefill kernel here,
// the all-bf16 prefill on warpgroup MMAs and TMA in flash_prefill_wgmma.cu
// (q, k and v all bf16 at tile widths 64, 128 and 256 and at Dk 192 / Dv
// 128: kernels/flash_attention.py::prefill_route), and the split-KV decode
// kernel in flash_decode.cu (the three build in parallel;
// flash_common.cuh holds what two share).  The wrapper launches decode
// when S = 1 and a prefill kernel otherwise, picked by shape; it copies
// q/k/v that do not start on a 16-byte boundary first.  Here the prefill
// runs f32 and mixed-dtype inputs at every width, and all-bf16 inputs at
// widths 16, 32, 96 and 512.
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
// first lists its live tiles of BN = 64 keys (32 at width 512): those holding a key that
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
//   bf16 (widths 16, 32, 96 and 512 here): m16n8k16 bf16 MMAs with f32
//         accumulators: Q's fragments (scaled in bf16) in registers, K
//         from ldmatrix, V from ldmatrix.trans, P rounded to bf16 for PV;
//         K/V rows padded to D + 8.
//   mixed: bf16 q over f32 K/V stages Q as f32 after its bf16 rounding;
//         f32 q over bf16 K/V widens each bf16 K/V chunk to f32 on its way
//         into shared memory (plain loads: cp.async cannot convert), whose
//         TF32 split is exact (lo = 0).
// Dk 192 / Dv 128 (MLA).  Rows, the accumulator and the output columns go
// by Dv, as at 128: 128 rows a CTA, one warp a 16-row block.  Q, K and the
// scores' k-steps go by Dk: K rows of Dk + 4 floats (f32) or Dk + 8 bf16,
// 24 k-steps of 8 (TF32) or 12 of 16 (bf16).  In f32 the 128-row Q (100 KB)
// and one tile (83 KB) leave no room for a second stage, so the ring has
// one, as at 256; in bf16 Q's fragments (48 registers) are read from shared
// memory by ldmatrix, as at 256, and the ring keeps two stages (43 KB each).
// Head dim 256 (gemma-7b).  A warp's accumulator of 16 rows by 256 columns
// (128 registers) does not fit beside the scores, so two warps share each
// 16-row block: both compute its scores in full, and each keeps D/2
// output columns (DO), so a CTA holds 64 rows.  In f32 the 64-row Q and one
// K/V tile take 194 KB, so the ring has one stage (the next tile loads
// after the last warp is done with this one); bf16 keeps two stages and
// reads Q's fragments from shared memory with ldmatrix instead of holding
// them in registers.
// Tile width 512 (DeepSeek-V4).  Four warps share each 16-row block, each
// computing its scores in full and keeping 128 output columns, so a CTA
// holds 32 rows.  A 64-key K and V tile in f32 (263 KB) does not fit a
// CTA's 227 KB, so tiles hold 32 keys: f32 with one stage (198 KB with Q),
// bf16 with two (167 KB with Q in shared memory).
// Groups larger than a CTA's rows (G = 128 over one kv head at width 512,
// say) are cut into slices of `heads` = min(G, rows) heads: the grid's x
// is (query block, head slice), and a CTA holds rows / heads queries of
// one slice, in the general template.  One launch either way.
// mma.sync, not wgmma, for f32 and mixed inputs: TF32 wgmma reads B, and
// A unless it sits in registers, as K-major tiles in shared memory, so
// 3xTF32 would need the hi and lo halves of K, of a transposed V and (for
// want of registers) of Q there: at D = 128 in f32 that is more than the
// 227 KB a CTA has.  The warp-level MMAs take both halves from registers,
// split where they are loaded.  A bf16 wgmma reads B either K-major or
// MN-major, so all-bf16 inputs take flash_prefill_wgmma.cu instead (K and
// V as they lie, P from registers); its widths 16, 32 and 96 stay here
// (no wgmma tile below 64 columns: a padded 64 would multiply mostly
// zeros; no config has a head dim from 72 to 96), and 512, whose 256-wide
// output tile is the most a wgmma takes.
// The scores' masks come from each key's staged kv_pos, never from the
// slot index (a ring cache holds token t in slot t % W), and the row max
// and sum from the quad of lanes that share a row of the accumulator
// fragment; e^x is exp2f(x log2 e) (one FFMA, then 2^x to 2 ulp), and the
// accumulator is rescaled only in the tiles where some row's max moved.
//
// The short form (prefill_short_kernel, below).  At a short bucket the
// layout above leaves the card idle: gemma-7b's bucket 64 (D 256, G 1) is
// 16 CTAs of 64 rows on 132 SMs, each walking a serial chain (Q read and
// scaled with plain loads, the live-tile scan, then one 128 KB tile) and
// scoring each row block twice; MLA's bucket 64 fills half the rows of
// its 128 CTAs.  The short form keeps the products and the masks (3xTF32
// on mma.sync, masks from staged kv_pos, the n-tile skip, 0 for a row
// with no key, the output in f32) and changes the layout: four
// warps a CTA holding 16, 32 or 64 rows, the warps of a 16-row block
// splitting each tile's keys between them (each with its own running max,
// sum and accumulator, combined in shared memory at the end, in warp
// order: one launch, no workspace, no atomics); at Dv 256 the two output
// halves of a row go to two CTAs, each scoring the row once and loading
// half of V; Q (f32 raw, scaled at its fragment loads) in the cp.async
// group of the tiles, and where every tile fits the ring all of them
// loaded at once with no scan.  prefill_plan takes it for f32 q, K and V
// at (Dk, Dv) = (64, 64), (128, 128), (256, 256) and (192, 128), a whole
// group, at most 512 keys, no lse, where the full grid is at most half a
// wave or its rows half empty, with the fewest rows whose grid fits one
// wave at the card's occupancy.  Every other shape, bf16 q over f32 K/V
// included (no path prefills it at a short bucket), runs the
// instantiations above as they were.
// Later work: TMA tensor-map loads for the f32 and mixed routes, which
// would free the registers and issue slots the loads take; at head dim
// 256 in f32, a second stage (32-key tiles); a split over keys across
// CTAs for short buckets of several tiles (tinyllama's 128-512).
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

// Rows by V's head dim DV: WPR warps share each 16-row block, each
// computing its scores and DO = DV / WPR output columns; a CTA holds ROWS
// (query, head) rows.  Two warps a block at DV = 256 (the accumulator of
// 256 columns does not fit a warp's registers), four at 512, one below.
template <int DV> struct Geom {
  static constexpr int WPR = DV > 256 ? 4 : DV > 128 ? 2 : 1;
  static constexpr int ROWS = 16 * kWarps / WPR;
  static constexpr int DO = DV / WPR;
};

// Shared-memory layout of one compute type and pair of head dims, DK of
// q and K, DV of V (element strides).
//   f32:  K (and Q) rows padded to DK + 4 floats, so the 16-byte fragment
//         loads of 8 lanes fall on 8 distinct bank groups; V rows unpadded
//         with their 16-byte chunks XOR-swizzled by vswz (below).  Q is
//         staged here; above DK = 128 the ring has one stage (194 KB with
//         Q at 256, 184 KB at 192 / 128, 198 KB at 512 with 32-key tiles).
//   bf16: K and V rows padded to DK + 8 and DV + 8, so the 8 rows of an
//         ldmatrix fall on 8 distinct bank groups; Q in registers, or
//         above DK = 128 here, padded the same way.
// BN keys a tile: 64, or 32 at DK = 512, where a 64-key tile does not fit.
template <typename T, int DK_, int DV_> struct Layout;
template <int DK_, int DV_> struct Layout<float, DK_, DV_> {
  static constexpr int DK = DK_, DV = DV_;
  static constexpr int KS = DK + 4, VS = DV, QS = DK + 4;
  static constexpr int KPB = DK >= 32 ? 4 : DK / 8;  // k-steps a K load
  static constexpr int BN = DK > 256 ? 32 : 64;
  static constexpr int STAGES = DK > 128 ? 1 : 2;     // K/V tiles in flight
  static constexpr int q_elems = Geom<DV>::ROWS * QS;
};
template <int DK_, int DV_> struct Layout<__nv_bfloat16, DK_, DV_> {
  static constexpr int DK = DK_, DV = DV_;
  static constexpr int KS = DK + 8, VS = DV + 8, QS = DK > 128 ? DK + 8 : 0;
  static constexpr int KPB = 0;
  static constexpr int BN = DK > 256 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int q_elems = Geom<DV>::ROWS * QS;
};

template <typename T, int DK, int DV> struct Smem {
  using L = Layout<T, DK, DV>;
  static constexpr int k_elems = L::BN * L::KS, v_elems = L::BN * L::VS;
  static constexpr size_t stage_bytes =
      sizeof(T) * (k_elems + v_elems) + sizeof(int) * L::BN;
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
// bank groups (at D = 96, whose lanes read 3 chunks, it only keeps the
// chunks inside their row: 24 chunks, a multiple of 4).
template <int D> __device__ __forceinline__ int vswz(int r) {
  const int t = (r >> 1) & 3;
  if constexpr (D >= 128) return t;
  else if constexpr (D == 64) return (t & 1) | ((t & 2) << 1);
  else if constexpr (D == 32) return t << 1;
  else return t;                          // D = 16 (4 chunks a row), 96
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
// one 2*KPB-float load.  L is the f32 Layout; D its DK.  kFresh: each
// k-step's three products go to a zeroed accumulator, added to s in f32
// (the MMA aligns its terms to the largest and truncates, so a long chain
// of MMAs into one accumulator drifts by a few ulps a step: the row
// log-sum-exp that K3e's backward reads needs the scores at f32 accuracy;
// serving runs without it: with it, its f32 rows took 3-26% longer,
// PERF.md, PR 29).
template <class L, bool kFresh>
__device__ __forceinline__ void qk_tile(float (*s)[4], const float* Qw,
                                        const float* Ks, int g, int t,
                                        unsigned long long live) {
  constexpr int KPB = L::KPB, RL = 2 * KPB, NB = L::DK / (8 * KPB);
  constexpr int kNT = L::BN / 8;
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
        if constexpr (kFresh) {
          float f[kJG][4] = {};
          mma_3xtf32<kJG>(f, ahi[kk], alo[kk], bk);
#pragma unroll
          for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j0 + jj][e] += f[jj][e];
        } else {
          mma_3xtf32<kJG>(s + j0, ahi[kk], alo[kk], bk);
        }
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
// output floats a row.  L is the f32 Layout; D its DV.
template <class L, int DO>
__device__ __forceinline__ void pv_tile(float (*o)[4], const float (*p)[4],
                                        const float* Vs, int g, int t,
                                        unsigned long long live, int half) {
  constexpr int D = L::DV, kNT = L::BN / 8;
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
// Q in shared memory (Qw) by ldmatrix, and K's from ldmatrix.  L is the
// bf16 Layout; D its DK.
template <class L>
__device__ __forceinline__ void qk_tile_bf16(float (*s)[4],
                                             const uint32_t (*qa)[4],
                                             const __nv_bfloat16* Qw,
                                             const __nv_bfloat16* Ks,
                                             int lane,
                                             unsigned long long live) {
  constexpr int D = L::DK, KS = L::KS, kNT = L::BN / 8;
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
// ldmatrix.trans; output n-tile nt is columns half*DO + 8nt..+7.  L is
// the bf16 Layout.
template <class L, int DO>
__device__ __forceinline__ void pv_tile_bf16(float (*o)[4],
                                             const float (*p)[4],
                                             const __nv_bfloat16* Vs,
                                             int lane,
                                             unsigned long long live,
                                             int half) {
  constexpr int VS = L::VS;
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk) {
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

// One CTA: batch row b = blockIdx.z, kv head kvh = blockIdx.y, and x =
// gridDim.x - 1 - blockIdx.x = qb * NHS + hs: query block qb, slice hs of
// NHS = ceil(G / GS) slices of GS heads.  Row r < BQ*GS of the CTA is query
// s = qb*BQ + r / GS of head kvh*G + hs*GS + r % GS, where that head is < G
// (kernels/flash_attention.py::prefill_plan and prefill_row).  Warp w owns
// rows 16rb..16rb+15 of row block rb = w / WPR and the output columns
// half*DO.. (half = w % WPR); its lane (g = lane / 4, t = lane % 4) holds
// rows 16rb + g and 16rb + g + 8 of every fragment.  D is the tile width of
// q's and K's head dim, DV of V's and the output's (DV <= D).  With kGen
// the true head dims dk <= D and dv <= DV (multiples of 8, the length of
// the rows of q, k, v and out in memory) are the arguments dk_arg and
// dv_arg, every load and store past them is masked, and a CTA may hold a
// slice of GS < G heads; without it they are D and DV, nothing is masked,
// GS = G and NHS = 1 (a head dim equal to its width, its group in one
// CTA, runs the unpadded instantiation, with the row math of a whole
// group).  Under autograd (K3e) the launch passes `lse`, where each row's
// statistics go, and on the f32 path may pass `out32`, where the output
// goes before its rounding to q's dtype (K3e's backward takes Delta =
// rowsum(dO o O) from it); serving passes neither.  The all-bf16 path
// writes `lse` where it is not null.  The f32 path (f32 or mixed dtypes)
// does so in its kFresh instantiations, K3e's, which also add the scores
// up a k-step at a time (qk_tile); its others, serving's, store neither.
template <typename TQ, typename TKV, int D, int DV, bool kGen, bool kFresh>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
               const TKV* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ kv_pos, TQ* __restrict__ out,
               float* __restrict__ lse, float* __restrict__ out32, int S,
               int T_, int H, int K, int G, int GS, int BQ, int dk_arg,
               int dv_arg, int causal, int window, float scale) {
  static_assert(DV <= D, "V's head dim is at most q's and K's");
  using C = typename Path<TQ, TKV>::T;         // the products' type
  using L = Layout<C, D, DV>;
  using SM = Smem<C, D, DV>;
  constexpr bool kF32 = sizeof(C) == 4;
  static_assert(kF32 || !kFresh, "the all-bf16 path has no kFresh form");
  constexpr bool kStats = kFresh || !kF32;     // may write lse and out32
  constexpr int WPR = Geom<DV>::WPR, DO = Geom<DV>::DO;
  constexpr int ROWS = Geom<DV>::ROWS;
  constexpr int NO = DO / 8;                   // output n-tiles
  constexpr int BN = L::BN, kNT = BN / 8;      // keys, n-tiles a tile
  const int dk = kGen ? dk_arg : D, dv = kGen ? dv_arg : DV;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int w_hi[kWarps];
  __shared__ long long w_lo[kWarps];
  __shared__ int n_live_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp / WPR, half = warp % WPR;
  // the last query blocks, which see the most keys, start first
  const int gs = kGen ? GS : G;
  const int nhs = kGen ? (G + gs - 1) / gs : 1;
  const int xb = gridDim.x - 1 - blockIdx.x;
  const int qb = kGen ? xb / nhs : xb;
  const int h0 = kGen ? xb % nhs * gs : 0;      // the slice's first head
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T_ + BN - 1) / BN;
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
    const int s = qb * BQ + r / gs, gh = h0 + r % gs;
    row_ok[i] = r < BQ * gs && s < S && (!kGen || gh < G);
    row_s[i] = s;
    row_h[i] = kvh * G + gh;
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
  // memory in the products' type (f32; bf16 above D = 128), or as bf16
  // fragments into registers; zero past dk
  uint32_t qa[kF32 || L::QS > 0 ? 1 : D / 16][4];
  if constexpr (L::QS > 0) {
    constexpr int EPC = 16 / sizeof(C);        // elements a 16-byte chunk
    for (int idx = tid; idx < ROWS * (D / EPC); idx += kThreads) {
      const int r = idx / (D / EPC), c = idx % (D / EPC);
      const int s = qb * BQ + r / gs, gh = h0 + r % gs;
      alignas(16) C x[EPC];
      const bool ok = r < BQ * gs && s < S &&
                      (!kGen || (gh < G && EPC * c < dk));
      // an address for every row, read only where ok: the loads of
      // successive chunks then issue together
      const TQ* src = q + ((static_cast<long long>(b) * S + (ok ? s : 0)) *
                           H + kvh * G + (!kGen || ok ? gh : 0)) * dk +
                      EPC * c;
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
        if (row_ok[i] && (!kGen || d < dk)) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              q + ((static_cast<long long>(b) * S + row_s[i]) * H +
                   row_h[i]) * dk + d);
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
      for (int h2 = 0; h2 < BN / 32; ++h2) {
        const int col = i * BN + lane + 32 * h2;
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

  // one tile's K, V and kv_pos into ring stage st, zero-filled past T and
  // past the true head dims (chunks ck.. of a K row, cv.. of a V row):
  // cp.async when K/V are already in the products' type; bf16 K/V on the
  // f32 path are widened on the way (plain loads: the copy engine cannot
  // convert), each 16-byte chunk of 8 values into two f32 chunks
  const int ck = dk * static_cast<int>(sizeof(TKV)) / 16;
  const int cv = dv * static_cast<int>(sizeof(TKV)) / 16;
  auto load_tile = [&](int tile, int st) {
    unsigned char* base = smem + st * SM::stage_bytes;
    C* Ks = reinterpret_cast<C*>(base);
    C* Vs = Ks + SM::k_elems;
    int* Ps = reinterpret_cast<int*>(Vs + SM::v_elems);
    constexpr int CPR = D * sizeof(TKV) / 16;  // 16-byte chunks a K row
    constexpr int CPV = DV * sizeof(TKV) / 16;  // and a V row (<= CPR)
    constexpr int EPC = 16 / sizeof(TKV);      // elements a chunk
    const int t0 = tile * BN;
    for (int idx = tid; idx < BN * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const int key = t0 + r;
      const long long row = (static_cast<long long>(b) * T_ + key) * K + kvh;
      const bool ok = key < T_ && (!kGen || c < ck);
      const bool vok = key < T_ && (!kGen || c < cv);
      const long long off = ok ? row * dk + c * EPC : 0;
      const long long voff = vok ? row * dv + c * EPC : 0;
      const bool has_v = CPV == CPR || c < CPV;  // chunk c of a V row
      if constexpr (std::is_same<C, TKV>::value) {
        cp_async16(Ks + r * L::KS + c * EPC, k + off, ok);
        int vc = c;
        if constexpr (kF32) vc = c ^ vswz<DV>(r);
        if (has_v) cp_async16(Vs + r * L::VS + vc * EPC, v + voff, vok);
      } else {
        uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
        if (ok) kr = __ldg(reinterpret_cast<const uint4*>(k + off));
        if (has_v && vok) vr = __ldg(reinterpret_cast<const uint4*>(v + voff));
        alignas(16) float kf[8];
        alignas(16) float vf[8];
        Vec16<__nv_bfloat16>::widen(kr, kf);
        Vec16<__nv_bfloat16>::widen(vr, vf);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          *reinterpret_cast<float4*>(Ks + r * L::KS + 8 * c + 4 * hh) =
              *reinterpret_cast<const float4*>(kf + 4 * hh);
          if (has_v)
            *reinterpret_cast<float4*>(
                Vs + r * L::VS + 4 * ((2 * c + hh) ^ vswz<DV>(r))) =
                *reinterpret_cast<const float4*>(vf + 4 * hh);
        }
      }
    }
    if (tid < BN) {
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

    const int t0 = tiles[it] * BN;
    const unsigned char* base = smem + st * SM::stage_bytes;
    const C* Ks = reinterpret_cast<const C*>(base);
    const C* Vs = Ks + SM::k_elems;
    const int* Ps = reinterpret_cast<const int*>(Vs + SM::v_elems);
    // bit c of `live`: some row of this warp sees key c; the products skip
    // the 8-key n-tiles no row sees (all of them when live is 0), and the
    // masks are skipped when every row sees every key (`full`)
    bool seen[2] = {false, false}, all = true;
#pragma unroll
    for (int h2 = 0; h2 < BN / 32; ++h2) {
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
        qk_tile<L, kFresh>(s, reinterpret_cast<const float*>(Qs) +
                                  rb * 16 * L::QS,
                   reinterpret_cast<const float*>(Ks), g, t, live);
      else
        qk_tile_bf16<L>(s, qa,
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
        pv_tile<L, DO>(o, s, reinterpret_cast<const float*>(Vs), g, t, live,
                       half);
      else
        pv_tile_bf16<L, DO>(o, s,
                            reinterpret_cast<const __nv_bfloat16*>(Vs), lane,
                            live, half);
    }
    if constexpr (L::STAGES == 1) {
      __syncthreads();                  // every warp is done with the stage
      if (it + 1 < n_live) load_tile(tiles[it + 1], 0);
      cp_commit();
    }
  }

  // out = acc / max(l, 1e-30), l summed over the quad, in q's dtype; the
  // columns past dv (zero V columns) are not stored.  Where `lse` is not
  // null, the row's m + log(l) into it for the backward
  // (flash_backward.cu), +inf where the row has no valid key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (!row_ok[i]) continue;
    if (kStats && lse != nullptr && half == 0 && t == 0)
      lse[(static_cast<long long>(b) * H + row_h[i]) * S + row_s[i]] =
          l[i] > 0.f ? m[i] + logf(l[i])
                     : __int_as_float(0x7f800000);
    const float den = fmaxf(l[i], 1e-30f);
    TQ* orow = out + ((static_cast<long long>(b) * S + row_s[i]) * H +
                      row_h[i]) * dv;
    if constexpr (kF32) {
      // lane t holds columns c0.. : o[n][2i] at (DO/8)*2t + n, then
      // o[n][2i + 1] at (DO/8)*(2t + 1) + n
      const int c0 = half * DO + (DO / 4) * t;
      float* o32 = kStats && out32 != nullptr
                       ? out32 + ((static_cast<long long>(b) * S + row_s[i]) *
                                      H + row_h[i]) * dv
                       : nullptr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float x0 = o[n][2 * i] / den, x1 = o[n][2 * i + 1] / den;
        if (!kGen || c0 + n < dv) {
          orow[c0 + n] = from_f<TQ>(x0);
          if (kStats && o32 != nullptr) o32[c0 + n] = x0;
        }
        if (!kGen || c0 + NO + n < dv) {
          orow[c0 + NO + n] = from_f<TQ>(x1);
          if (kStats && o32 != nullptr) o32[c0 + NO + n] = x1;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = half * DO + 8 * n + 2 * t;
        if (!kGen || c < dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[n][2 * i] / den, o[n][2 * i + 1] / den);
      }
    }
  }
}

// A launch laid out by prefill_plan: -1 when its rows, keys or stages are
// not this instantiation's, its head dims (dk, dv) exceed its widths, or,
// unpadded, they are not its widths or a CTA holds a slice of a group.
template <typename TQ, typename TKV, int D, int DV, bool kGen, bool kFresh>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, float* lse, float* out32, int B,
           int S, int T_, int H, int K, int dk, int dv, int causal,
           int window, float scale, int rows, int keys, int stages, int BQ,
           int GS, int n_blocks,
           cudaStream_t stream) {
  using C = typename Path<TQ, TKV>::T;
  using L = Layout<C, D, DV>;
  const int G = H / K;
  if (rows != Geom<DV>::ROWS || keys != L::BN || stages != L::STAGES ||
      GS < 1 || GS > G || BQ * GS > rows || dk > D || dv > DV ||
      (!kGen && (dk != D || dv != DV || GS != G)) ||
      static_cast<long long>(n_blocks) * BQ < static_cast<long long>(S) *
          ((G + GS - 1) / GS))
    return -1;
  const size_t smem = Smem<C, D, DV>::bytes((T_ + L::BN - 1) / L::BN);
  dim3 grid(n_blocks, K, B);
  prefill_kernel<TQ, TKV, D, DV, kGen, kFresh>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), q_pos, kv_pos, static_cast<TQ*>(out), lse,
      out32, S, T_, H, K, G, GS, BQ, dk, dv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the short form: f32 prefill of short buckets ----------------------
//
// Four warps a CTA.  RB row blocks of 16 (query, head) rows, a CTA holding
// ROWS = 16 RB rows of one kv head's whole group; each row block is scored
// by KSPLIT = 4 / RB warps, warp kp taking n-tiles KW kp..KW kp + KW - 1
// (KW = 8 / KSPLIT) of every 64-key tile, with its own running max, sum and
// accumulator; at the end the KSPLIT parts of a row are rescaled to their
// common max and summed in shared memory, in warp order.  At DV = 256 the
// two output halves of a row go to two CTAs (NH = 2, the grid's x is query
// block x half), each scoring the row once and loading only its DO = 128
// columns of V.  Q (copied raw, scaled at its fragment loads) goes in the
// cp.async group of the first tiles, and where every tile fits the ring
// (n_tiles <= STAGES) those are all loaded at once, with no scan: one
// memory latency before the first product.
constexpr int kShortWarps = 4;
constexpr int kShortThreads = 32 * kShortWarps;

template <int D, int DV, int RB> struct Short {
  static constexpr int ROWS = 16 * RB;
  static constexpr int KSPLIT = kShortWarps / RB;
  static constexpr int KW = 8 / KSPLIT;           // n-tiles a warp, a tile
  static constexpr int NH = DV > 128 ? 2 : 1;     // CTAs a row's output
  static constexpr int DO = DV / NH;              // a CTA's output columns
  static constexpr int BN = 64;
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int KS = D + 4, QS = D + 4, OS = DO + 4;
  static constexpr int k_elems = BN * KS, v_elems = BN * DO;
  static constexpr size_t stage_bytes =
      sizeof(float) * (k_elems + v_elems) + sizeof(int) * BN;
  static constexpr size_t q_bytes = sizeof(float) * ROWS * QS;
  // the combine's parts (16 rows of OS floats a warp) reuse the ring
  static_assert(sizeof(float) * kShortWarps * 16 * OS <=
                    STAGES * stage_bytes, "the combine fits the ring");
  static size_t bytes(int n_tiles) {
    return STAGES * stage_bytes + q_bytes + sizeof(int) * n_tiles;
  }
};

// A warp's slice of a tile as the products see it: its BN keys (rows of
// K at stride DK + 4), V's DV columns it loads (row stride DV).  The
// slices start on multiples of 8 keys, where vswz repeats.
template <int DK_, int DV_, int BN_> struct Slice {
  static constexpr int DK = DK_, DV = DV_, BN = BN_;
  static constexpr int KS = DK + 4, VS = DV, QS = DK + 4;
  static constexpr int KPB = 4;
};

// qk_tile for a slice of KW n-tiles, Q (f32, staged raw) scaled at its
// fragment loads: q * scale, the product the reference takes
template <class L, int KW>
__device__ __forceinline__ void qk_short(float (*s)[4], const float* Qw,
                                         const float* Ks, int g, int t,
                                         unsigned long long live,
                                         float scale) {
  constexpr int KPB = L::KPB, RL = 2 * KPB, NB = L::DK / (8 * KPB);
  constexpr int JG = KW < kJG ? KW : kJG;
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
#pragma unroll
    for (int e = 0; e < RL; ++e) {
      a0[e] *= scale;
      a1[e] *= scale;
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
    for (int j0 = 0; j0 < KW; j0 += JG) {
      if (!((live >> (8 * j0)) & ((1ull << (8 * JG)) - 1))) continue;
      alignas(16) float b[JG][RL];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < RL; e += 4)
          *reinterpret_cast<float4*>(b[jj] + e) =
              *reinterpret_cast<const float4*>(
                  Ks + (8 * (j0 + jj) + g) * L::KS + col + e);
#pragma unroll
      for (int kk = 0; kk < KPB; ++kk) {
        float bk[JG][2];
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          bk[jj][0] = b[jj][2 * kk];
          bk[jj][1] = b[jj][2 * kk + 1];
        }
        mma_3xtf32<JG>(s + j0, ahi[kk], alo[kk], bk);
      }
    }
  }
}

// One CTA: batch row b = blockIdx.z, kv head kvh = blockIdx.y, and x =
// gridDim.x - 1 - blockIdx.x = qb * NH + half: query block qb, output half
// `half`.  Row r < BQ*G of the CTA is query s = qb*BQ + r / G of head kvh*G
// + r % G (kernels/flash_attention.py::prefill_plan's "short" form and
// prefill_row, prefill_cols); the CTA writes output columns half*DO..
// of its rows.  Warp w scores row block rb = w / KSPLIT over its part kp =
// w % KSPLIT of each tile; its lane (g, t) holds rows 16rb + g and 16rb + g
// + 8 of every fragment.  q, K and V are f32; D is q's and K's head
// dim, DV V's (both whole: no masked columns, no head slices).
template <int D, int DV, int RB>
__global__ void __launch_bounds__(kShortThreads, 1)
prefill_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, float* __restrict__ out,
                     int S, int T_, int H, int K, int G, int BQ, int causal,
                     int window, float scale) {
  static_assert(DV <= D, "V's head dim is at most q's and K's");
  using SH = Short<D, DV, RB>;
  constexpr int ROWS = SH::ROWS, KSPLIT = SH::KSPLIT, KW = SH::KW;
  constexpr int NH = SH::NH, DO = SH::DO, NO = DO / 8;
  constexpr int BN = SH::BN, STAGES = SH::STAGES;
  constexpr int NK = 8 * KW;                   // keys a warp, a tile
  constexpr int KL = (NK + 31) / 32;           // of them a lane
  using LS = Slice<D, DO, NK>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int w_hi[kShortWarps];
  __shared__ long long w_lo[kShortWarps];
  __shared__ int n_live_s;
  __shared__ float m_s[kShortWarps][16], l_s[kShortWarps][16], den_s[ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp / KSPLIT, kp = warp % KSPLIT;
  const int xb = gridDim.x - 1 - blockIdx.x;   // the last blocks first
  const int qb = xb / NH, half = xb % NH;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T_ + BN - 1) / BN;
  const bool all_in = n_tiles <= STAGES;       // every tile in the ring
  float* Qs = reinterpret_cast<float*>(smem + STAGES * SH::stage_bytes);
  int* tiles = reinterpret_cast<int*>(smem + STAGES * SH::stage_bytes +
                                      SH::q_bytes);

  // one tile's K, its DO columns of V (chunks XOR-swizzled by vswz) and
  // kv_pos into stage st, zero-filled past T
  auto load_tile = [&](int tile, int st) {
    unsigned char* base = smem + st * SH::stage_bytes;
    float* Ks = reinterpret_cast<float*>(base);
    float* Vs = Ks + SH::k_elems;
    int* Ps = reinterpret_cast<int*>(Vs + SH::v_elems);
    constexpr int CPR = D / 4, CPV = DO / 4;   // 16-byte chunks a row
    const int t0 = tile * BN;
    for (int idx = tid; idx < BN * CPR; idx += kShortThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const int key = t0 + r;
      const bool ok = key < T_;
      const long long row =
          ok ? (static_cast<long long>(b) * T_ + key) * K + kvh : 0;
      cp_async16(Ks + r * SH::KS + 4 * c, k + row * D + 4 * c, ok);
      if (c < CPV)
        cp_async16(Vs + r * DO + 4 * (c ^ vswz<DO>(r)),
                   v + row * DV + half * DO + 4 * c, ok);
    }
    if (tid < BN) {
      const int key = t0 + tid;
      const bool ok = key < T_;
      cp_async4(Ps + tid,
                kv_pos + (ok ? static_cast<long long>(b) * T_ + key : 0), ok);
    }
  };

  // Q (copied raw) and, where they all fit the ring, every tile: one
  // cp.async group; rows past the block are zero
  constexpr int CPQ = D / 4;
  for (int idx = tid; idx < ROWS * CPQ; idx += kShortThreads) {
    const int r = idx / CPQ, c = idx % CPQ;
    const int s = qb * BQ + r / G;
    const bool ok = r < BQ * G && s < S;
    const long long row =
        ok ? (static_cast<long long>(b) * S + s) * H + kvh * G + r % G : 0;
    cp_async16(Qs + r * SH::QS + 4 * c, q + row * D + 4 * c, ok);
  }
  if (all_in)
    for (int i = 0; i < n_tiles; ++i) load_tile(i, i);
  cp_commit();

  // the lane's two rows' key bounds: key p is valid iff p <= hi and p > lo
  int hi[2];
  long long lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rb * 16 + g + 8 * i;
    const int s = qb * BQ + r / G;
    const bool ok = r < BQ * G && s < S;
    const int qp = ok ? q_pos[static_cast<long long>(b) * S + s] : 0;
    hi[i] = !ok ? INT_MIN : (causal ? qp : INT_MAX);
    lo[i] = !ok ? LLONG_MAX
                : (window > 0 ? static_cast<long long>(qp) - window
                              : LLONG_MIN);
  }
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
  __syncthreads();

  // past the ring: the live tiles, as the full form lists them
  int n_live = n_tiles;
  if (!all_in) {
    int chi = INT_MIN;
    long long clo = LLONG_MAX;
#pragma unroll
    for (int w = 0; w < kShortWarps; ++w) {
      chi = max(chi, w_hi[w]);
      clo = min(clo, w_lo[w]);
    }
    const long long kv_base = static_cast<long long>(b) * T_;
    for (int i = warp; i < n_tiles; i += kShortWarps) {
      bool live = false;
#pragma unroll
      for (int h2 = 0; h2 < BN / 32; ++h2) {
        const int col = i * BN + lane + 32 * h2;
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
    n_live = n_live_s;
    if (n_live > 0) load_tile(tiles[0], 0);
    cp_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: lane's part

  for (int it = 0; it < n_live; ++it) {
    const int tile = all_in ? it : tiles[it];
    const int st = all_in ? it : it % STAGES;
    cp_wait_all();                              // tile it has landed
    __syncthreads();
    if constexpr (STAGES > 1) {
      if (!all_in) {
        if (it + 1 < n_live) load_tile(tiles[it + 1], (it + 1) % STAGES);
        cp_commit();
      }
    }
    // the warp's part of the tile: keys t0.. of K, V and kv_pos
    const int t0 = tile * BN + NK * kp;
    const float* base =
        reinterpret_cast<const float*>(smem + st * SH::stage_bytes);
    const float* Ks = base + NK * kp * SH::KS;
    const float* Vs = base + SH::k_elems + NK * kp * DO;
    const int* Ps =
        reinterpret_cast<const int*>(base + SH::k_elems + SH::v_elems) +
        NK * kp;
    bool seen[KL], all = true;
#pragma unroll
    for (int h2 = 0; h2 < KL; ++h2) {
      const int c = lane + 32 * h2;
      seen[h2] = false;
      if (c < NK) {
        const int p = Ps[c];
        const bool in = t0 + c < T_;
        seen[h2] = in && p <= whi && static_cast<long long>(p) > wlo;
        all &= in && p <= whi_min && static_cast<long long>(p) > wlo_max;
      }
    }
    const bool full = __all_sync(0xffffffffu, all);
    unsigned long long live = __ballot_sync(0xffffffffu, seen[0]);
    if constexpr (KL > 1)
      live |= static_cast<unsigned long long>(
                  __ballot_sync(0xffffffffu, seen[KL - 1])) << 32;
    if (live) {
      float s[KW][4];
#pragma unroll
      for (int j = 0; j < KW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      qk_short<LS, KW>(s, Qs + rb * 16 * SH::QS, Ks, g, t, live, scale);
      unsigned valid = 0xffffffffu;
      if (!full) {
        valid = 0;
#pragma unroll
        for (int j = 0; j < KW; ++j)
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
      for (int j = 0; j < KW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
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
        for (int j = 0; j < KW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
            ls[e >> 1] += s[j][e];
          }
      } else {
#pragma unroll
        for (int j = 0; j < KW; ++j)
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
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= corr[0]; o[n][1] *= corr[0];
          o[n][2] *= corr[1]; o[n][3] *= corr[1];
        }
      }
      pv_tile<LS, DO>(o, s, Vs, g, t, live, 0);
    }
    if constexpr (STAGES == 1) {
      if (!all_in) {
        __syncthreads();                // every warp is done with the stage
        if (it + 1 < n_live) load_tile(tiles[it + 1], 0);
        cp_commit();
      }
    }
  }

  // The combine: each part's accumulator rescaled to the row's largest max
  // M over the KSPLIT parts, into shared memory (over the ring, 16 rows of
  // OS floats a warp); the row's sum L = sum of e^(m - M) l; then out =
  // (parts summed in warp order) / max(L, 1e-30), in q's dtype, each
  // thread storing 16 bytes of a row at a time.  One part (KSPLIT = 1)
  // scales by exactly 1.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  cp_wait_all();                        // no copy is left in flight
  __syncthreads();                      // every warp is done with the ring
  if (t == 0) {
    m_s[warp][g] = m[0];
    m_s[warp][g + 8] = m[1];
    l_s[warp][g] = l[0];
    l_s[warp][g + 8] = l[1];
  }
  __syncthreads();
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = g + 8 * i, w0 = rb * KSPLIT;
    float M = m_s[w0][rr];
#pragma unroll
    for (int j = 1; j < KSPLIT; ++j) M = fmaxf(M, m_s[w0 + j][rr]);
    const float f = exp2f((m[i] - M) * kLog2e);
    if (kp == 0 && t == 0) {
      float L = 0.f;
#pragma unroll
      for (int j = 0; j < KSPLIT; ++j)
        L += exp2f((m_s[w0 + j][rr] - M) * kLog2e) * l_s[w0 + j][rr];
      den_s[rb * 16 + rr] = fmaxf(L, 1e-30f);
    }
    // lane t holds columns (DO/4) t + n (o[n][2i]) and (DO/4) t + NO + n
    // (o[n][2i + 1])
    float* orow = Os + (warp * 16 + rr) * SH::OS + (DO / 4) * t;
#pragma unroll
    for (int n = 0; n < NO; n += 4) {
      *reinterpret_cast<float4*>(orow + n) =
          make_float4(o[n][2 * i] * f, o[n + 1][2 * i] * f,
                      o[n + 2][2 * i] * f, o[n + 3][2 * i] * f);
      *reinterpret_cast<float4*>(orow + NO + n) =
          make_float4(o[n][2 * i + 1] * f, o[n + 1][2 * i + 1] * f,
                      o[n + 2][2 * i + 1] * f, o[n + 3][2 * i + 1] * f);
    }
  }
  __syncthreads();
  constexpr int CPO = DO / 4;
  for (int idx = tid; idx < ROWS * CPO; idx += kShortThreads) {
    const int r = idx / CPO, c = idx % CPO;
    const int s = qb * BQ + r / G;
    if (r >= BQ * G || s >= S) continue;
    const float* part = Os + ((r / 16) * KSPLIT * 16 + r % 16) * SH::OS +
                        4 * c;
    float4 acc = *reinterpret_cast<const float4*>(part);
#pragma unroll
    for (int j = 1; j < KSPLIT; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + j * 16 * SH::OS);
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    const float den = den_s[r];
    float* dst = out + ((static_cast<long long>(b) * S + s) * H + kvh * G +
                        r % G) * DV + half * DO + 4 * c;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
  }
}

// A launch of the short form laid out by prefill_plan: -1 when its keys,
// stages or halves are not this instantiation's, the group does not fit
// its rows, or n_blocks is not ceil(S / BQ) x halves.
template <int D, int DV, int RB>
int launch_short(const void* q, const void* k, const void* v,
                 const int* q_pos, const int* kv_pos, void* out, int B,
                 int S, int T_, int H, int K, int causal, int window,
                 float scale, int keys, int stages, int halves, int BQ,
                 int n_blocks, cudaStream_t stream) {
  using SH = Short<D, DV, RB>;
  const int G = H / K;
  if (keys != SH::BN || stages != SH::STAGES || halves != SH::NH ||
      G > SH::ROWS || BQ < 1 || BQ * G > SH::ROWS ||
      static_cast<long long>(n_blocks) !=
          static_cast<long long>((S + BQ - 1) / BQ) * SH::NH)
    return -1;
  const size_t smem = SH::bytes((T_ + SH::BN - 1) / SH::BN);
  dim3 grid(n_blocks, K, B);
  prefill_short_kernel<D, DV, RB><<<grid, kShortThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, kv_pos, static_cast<float*>(out),
      S, T_, H, K, G, BQ, causal, window, scale);
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
#define OPT_IN(TQ, TKV, DD, DV, P, F)                                       \
  if (cudaError_t err = cudaFuncGetAttributes(                              \
          &attr, pf::prefill_kernel<TQ, TKV, DD, DV, P, F>))                \
    return static_cast<int>(err);                                           \
  if (cudaError_t err = cudaFuncSetAttribute(                               \
          pf::prefill_kernel<TQ, TKV, DD, DV, P, F>,                        \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          max_smem - static_cast<int>(attr.sharedSizeBytes)))               \
    return static_cast<int>(err);
#define OPT_IN_D(DD, P, F)                                                  \
  OPT_IN(float, float, DD, DD, P, F)                                        \
  OPT_IN(__nv_bfloat16, float, DD, DD, P, F)                                \
  OPT_IN(float, __nv_bfloat16, DD, DD, P, F)
#define OPT_IN_BF16(DD, P)                                                  \
  OPT_IN(__nv_bfloat16, __nv_bfloat16, DD, DD, P, false)
  OPT_IN_D(16, false, false) OPT_IN_D(32, false, false)
  OPT_IN_D(64, false, false) OPT_IN_D(128, false, false)
  OPT_IN_D(256, false, false) OPT_IN_D(512, false, false)
  OPT_IN_D(64, true, false) OPT_IN_D(96, true, false)
  OPT_IN_D(128, true, false) OPT_IN_D(256, true, false)
  OPT_IN_D(512, true, false)
  OPT_IN_D(16, false, true) OPT_IN_D(32, false, true)
  OPT_IN_D(64, false, true) OPT_IN_D(128, false, true)
  OPT_IN_D(256, false, true) OPT_IN_D(64, true, true)
  OPT_IN_D(96, true, true) OPT_IN_D(128, true, true)
  OPT_IN_D(256, true, true)
  OPT_IN_BF16(16, false) OPT_IN_BF16(32, false) OPT_IN_BF16(512, false)
  OPT_IN_BF16(96, true) OPT_IN_BF16(512, true)
  OPT_IN(float, float, 192, 128, false, false)
  OPT_IN(float, float, 192, 128, true, false)
#define OPT_IN_FN(...)                                                      \
  if (cudaError_t err = cudaFuncGetAttributes(&attr, __VA_ARGS__))          \
    return static_cast<int>(err);                                           \
  if (cudaError_t err = cudaFuncSetAttribute(                               \
          __VA_ARGS__, cudaFuncAttributeMaxDynamicSharedMemorySize,         \
          max_smem - static_cast<int>(attr.sharedSizeBytes)))               \
    return static_cast<int>(err);
#define OPT_IN_SHORT(DD, DV)                                                \
  OPT_IN_FN(pf::prefill_short_kernel<DD, DV, 1>)                            \
  OPT_IN_FN(pf::prefill_short_kernel<DD, DV, 2>)                            \
  OPT_IN_FN(pf::prefill_short_kernel<DD, DV, 4>)
  OPT_IN_SHORT(64, 64) OPT_IN_SHORT(128, 128) OPT_IN_SHORT(256, 256)
  OPT_IN_SHORT(192, 128)
#undef OPT_IN_SHORT
#undef OPT_IN_FN
#undef OPT_IN_BF16
#undef OPT_IN_D
#undef OPT_IN
  return 0;
}

// S > 1, laid out by prefill_plan: `width` is the tile width of the
// instantiation: D itself where D = Dv is one of 16, 32, 64, 96, 128, 256,
// 512 (or Dk 192 / Dv 128, q and k/v both f32: width 192), else, for D =
// Dv another multiple of 8 below 512, the smallest of the padded widths
// 64, 96, 128, 256, 512 above D; q and k/v both bf16 only at widths 16,
// 32, 96 and 512 (the others are flash_prefill_wgmma.cu's).  A head dim
// at its width whose group fits a CTA (heads = G) runs the unpadded
// instantiation, where there is one (not at 96); any other call the
// general one, which
// masks its loads and stores past D and takes head slices.  `rows`
// (query, head) rows a CTA, `keys` keys a tile and `stages` tiles in
// flight must be the instantiation's (128 rows up to width 128, 64 at
// 256, 32 at 512; 64 keys, 32 at 512; one stage on the f32 path above
// width 128, else 2); `heads` (GS) heads of one kv head a CTA, BQ queries
// a CTA with BQ*GS <= rows, n_blocks = ceil(S/BQ) * ceil(G/GS).  q/k/v
// start on 16-byte boundaries.  dtype_q, dtype_kv: 0 = float32, 1 =
// bfloat16.  `lse`, where not null, (B,H,S) f32 at widths up to 256 (not
// MLA): each row's log-sum-exp in the scaled-score units, for K3e's
// backward (flash_backward.cu); `out32`, where not null (with `lse`, on
// the f32 path), (B,S,H,Dv) f32: the output before its rounding to q's
// dtype.  With `lse` the f32 path runs its kFresh instantiations.
// Returns a cudaError_t (0 = launched; an invalid-value error when T
// needs more shared memory than the device has); -1 for a shape or plan
// this kernel does not take.
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         float* lse, float* out32, int B, int S, int T_,
                         int H, int K, int D, int Dv, int causal, int window,
                         float scale, int dtype_q, int dtype_kv, int width,
                         int rows, int keys, int stages, int BQ, int heads,
                         int n_blocks, void* stream) {
  if (B == 0 || S == 0) return 0;
  const bool mla = width == 192 && D == 192 && Dv == 128;
  if (K <= 0 || H % K != 0 || BQ < 1 || T_ < 1 || D < 8 || D % 8 != 0 ||
      (Dv != D && !mla))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((lse != nullptr && (width > 256 || mla)) ||
      (out32 != nullptr &&
       (lse == nullptr || (dtype_q == 1 && dtype_kv == 1))))
    return -1;
#define PREFILL(TQ, TKV, CQ, CKV, DD, DV, P, F)                             \
  if (width == DD && dtype_q == CQ && dtype_kv == CKV)                      \
    return pf::launch<TQ, TKV, DD, DV, P, F>(                               \
        q, k, v, q_pos, kv_pos, out, lse, out32, B, S, T_, H, K, D, Dv,     \
        causal, window, scale, rows, keys, stages, BQ, heads, n_blocks, s);
#define PREFILL_D(DD, P, F)                                                 \
  PREFILL(float, float, 0, 0, DD, DD, P, F)                                 \
  PREFILL(__nv_bfloat16, float, 1, 0, DD, DD, P, F)                         \
  PREFILL(float, __nv_bfloat16, 0, 1, DD, DD, P, F)
#define PREFILL_BF16(DD, P)                                                 \
  PREFILL(__nv_bfloat16, __nv_bfloat16, 1, 1, DD, DD, P, false)
  // an unpadded instantiation returns where one matches; the general
  // ones take the rest.  All-bf16 inputs at widths 64, 128, 256 and 192
  // run csrc/flash_prefill_wgmma.cu instead (prefill_route).
  const bool whole = D == width && heads == H / K;
  if (mla) {
    if (whole) PREFILL(float, float, 0, 0, 192, 128, false, false)
    PREFILL(float, float, 0, 0, 192, 128, true, false)
    return -1;
  }
  if (lse != nullptr && (dtype_q == 0 || dtype_kv == 0)) {
    if (whole) {
      PREFILL_D(16, false, true)
      PREFILL_D(32, false, true)
      PREFILL_D(64, false, true)
      PREFILL_D(128, false, true)
      PREFILL_D(256, false, true)
    }
    PREFILL_D(64, true, true)
    PREFILL_D(96, true, true)
    PREFILL_D(128, true, true)
    PREFILL_D(256, true, true)
    return -1;
  }
  if (whole) {
    PREFILL_D(16, false, false)
    PREFILL_D(32, false, false)
    PREFILL_D(64, false, false)
    PREFILL_D(128, false, false)
    PREFILL_D(256, false, false)
    PREFILL_D(512, false, false)
    PREFILL_BF16(16, false)
    PREFILL_BF16(32, false)
    PREFILL_BF16(512, false)
  }
  PREFILL_D(64, true, false)
  PREFILL_D(96, true, false)
  PREFILL_D(128, true, false)
  PREFILL_D(256, true, false)
  PREFILL_D(512, true, false)
  PREFILL_BF16(96, true)
  PREFILL_BF16(512, true)
#undef PREFILL_BF16
#undef PREFILL_D
#undef PREFILL
  return -1;
}

// S > 1 in the short form (prefill_plan's form "short"; the kernel
// pf::prefill_short_kernel above): q, K and V f32, (D, Dv) one of (64, 64),
// (128, 128), (256, 256) and (192, 128), the group whole in a CTA of
// `rows` = 16, 32 or 64 rows; `keys` (64) and `stages` (1 above D = 128,
// else 2) the instantiation's, `halves` the CTAs a row's output columns
// are cut over (2 at Dv = 256, else 1), BQ queries a CTA, n_blocks =
// ceil(S / BQ) x halves.  q/k/v start on 16-byte boundaries.  Returns a
// cudaError_t (0 = launched), or -1 for a shape or plan it does not take.
int flash_prefill_short_launch(const void* q, const void* k, const void* v,
                               const int* q_pos, const int* kv_pos,
                               void* out, int B, int S, int T_, int H,
                               int K, int D, int Dv, int causal, int window,
                               float scale, int rows, int keys, int stages,
                               int halves, int BQ, int n_blocks,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || T_ < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PREFILL_SHORT(DD, DV, RB)                                           \
  if (D == DD && Dv == DV && rows == 16 * RB)                               \
    return pf::launch_short<DD, DV, RB>(                                    \
        q, k, v, q_pos, kv_pos, out, B, S, T_, H, K, causal, window, scale, \
        keys, stages, halves, BQ, n_blocks, s);
#define SHORT_ROWS(DD, DV)                                                  \
  PREFILL_SHORT(DD, DV, 1) PREFILL_SHORT(DD, DV, 2) PREFILL_SHORT(DD, DV, 4)
  SHORT_ROWS(64, 64) SHORT_ROWS(128, 128) SHORT_ROWS(256, 256)
  SHORT_ROWS(192, 128)
#undef SHORT_ROWS
#undef PREFILL_SHORT
  return -1;
}

// The CTAs of the short form an SM of the current device holds at once
// (its registers and shared memory at T keys) at (D, Dv) and `rows` rows a
// CTA: what prefill_plan fits a wave to.  After flash_attention_prepare.
// -1 for an instantiation there is not, or a negative cudaError_t.
int flash_prefill_short_per_sm(int D, int Dv, int rows, int T_) {
  int n = 0;
#define PER_SM(DD, DV, RB)                                                  \
  if (D == DD && Dv == DV && rows == 16 * RB) {                             \
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        &n, pf::prefill_short_kernel<DD, DV, RB>, pf::kShortThreads,        \
        pf::Short<DD, DV, RB>::bytes((T_ + 63) / 64));                      \
    return e == cudaSuccess ? n : -static_cast<int>(e);                     \
  }
#define PER_SM_ROWS(DD, DV) PER_SM(DD, DV, 1) PER_SM(DD, DV, 2) PER_SM(DD, DV, 4)
  PER_SM_ROWS(64, 64) PER_SM_ROWS(128, 128) PER_SM_ROWS(256, 256)
  PER_SM_ROWS(192, 128)
#undef PER_SM_ROWS
#undef PER_SM
  return -1;
}

}  // extern "C"

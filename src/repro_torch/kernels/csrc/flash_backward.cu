// The backward of K3's prefill under autograd (K3e): dQ, dK and dV of
// blockwise softmax attention from the forward's output O and its row
// log-sum-exp, in the contract of src/repro/models/attention.py::
// chunked_attention: q (B,S,H,D), k and v (B,T,K,D) with H = K*G, per-row
// positions q_pos (B,S) and kv_pos (B,T) (empty cache slots carry 2**30),
// key t valid for query s iff kv_pos[t] <= q_pos[s] when causal and, with a
// sliding window W > 0, also kv_pos[t] > q_pos[s] - W; S may differ from T.
// The reference differentiates its oracle at this point
// (src/repro/kernels/ops.py:31, _flash_bwd: "on TPU this is where a
// dedicated bwd kernel slots in"); this is that kernel for Hopper.
//
// The forward (flash_attention.cu, flash_prefill_wgmma.cu) writes, for each
// (query, head) row, lse = m + log(l) in its scaled-score units (scores
// s = (q * scale, rounded in q's dtype) . k), +inf for a row with no valid
// key.  Then, with dO the upstream gradient:
//   P = exp(s - lse) on the valid keys, 0 elsewhere (and on a row with no
//       valid key, whose lse is +inf)
//   Delta = rowsum(dO o O)                       (f32, from O as stored)
//   dV = sum over the group's heads of P^T dO
//   dP = dO V^T,  dS = P o (dP - Delta)
//   dK = sum over the group's heads of dS^T (q * scale)
//   dQ = scale * dS K
// Two launches (four for f32 q over bf16 K/V), none with a float atomic,
// so two calls give bit-equal gradients:
//   prep   one warp a (query, head) row: Delta, q scaled in its own dtype
//          then widened to the products' type (qs), and dO widened where
//          q is bf16 and the products f32; `widen` makes f32 copies of
//          bf16 K and V where q is f32.
//   grads  one launch of two kinds of CTA, the dK/dV blocks first, then
//          the dQ blocks, which fill the SMs that the dK/dV blocks' causal
//          tail leaves idle (two launches left them waiting on it):
//   dkdv   one CTA per (block of BK keys, kv head, batch row).  Its K and V
//          stay in shared memory; it walks the G query heads of its kv head
//          and, for each, the blocks of BQ queries that can see one of its
//          keys (listed at the start from its keys' smallest and largest
//          kv_pos, never from indices), streaming qs, dO, lse, Delta and
//          q_pos of each through a two-stage cp.async ring.  Each warp owns
//          16 keys: S^T = K qs^T and dP^T = V dO^T on the tensor cores, P^T
//          and dS^T in registers, then dV += P^T dO and dK += dS^T qs.  dK
//          and dV stay in f32 registers (the group's sum inside the CTA)
//          and are written once, in K/V's dtype.
//   dq     one CTA per (block of BK queries, head, batch row), the last
//          blocks first; qs, dO, lse and Delta of its queries stay in shared
//          memory while the key tiles its queries can see stream through a
//          two-stage ring: S = qs K^T, dP = dO V^T, then dQ += dS K.  dQ is
//          written once, times the scale, in q's dtype.
// Each warp skips the 8-column n-tiles that none of its 16 rows can see and
// the per-element masks where every row sees every column.
//
// Products.  f32, and the mixed pairs (bf16 q over f32 K/V, f32 q over bf16
// K/V), run every product in 3xTF32 on mma.sync m16n8k8 (a.b = a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi, hi the TF32 rounding to nearest, lo the rest; the
// forward's split, flash_attention.cu): the gradients stay at f32 accuracy,
// where one TF32 pass would leave 2**-11 of each product.  All-bf16 runs
// bf16 m16n8k16 MMAs with f32 accumulators, operands from ldmatrix (.trans
// for the second product's B); P^T and dS^T enter their products as a bf16
// pair hi + lo (two MMAs), so that only q, k, v and dO, which are bf16
// already, are read at bf16 precision.
//
// Layout.  Tiles sit in shared memory as rows of the tile width D padded to
// D + 4 floats (f32) or D + 8 bf16: every fragment read is a 4-byte load
// whose 32 lanes fall on 32 distinct banks, or an ldmatrix whose 8 rows
// fall on 8 distinct 16-byte bank groups.  Head dims below the tile width
// (72 in 96, 224 in 256) are zero-filled past their length by cp.async's
// src-size; the gradients' columns past it are not stored.  Four warps a
// CTA; above width 128 two warps share each 16-row block, both computing
// its scores, each keeping half of the output columns (the accumulators of
// 256 columns do not fit a warp's registers).
//
// Bounds on the H100 (the training shape: B 8 x S 512, 32 / 4 heads, D 64,
// causal, f32): 10 H D FLOP a valid pair (S again, dP, dV, dK, dQ; the dq
// kernel computes S and dP a second time, 14 H D in all), 10 x 64 x 32 x
// 8 x 131,328 = 21.5 GFLOP, 0.32 ms at the 67 TFLOP/s of f32; on the
// tensor cores, three TF32 products each, 0.13 ms at 495 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {
namespace bw {

constexpr int kWarps = 4;
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

// x = hi + lo: hi its TF32 rounding (to nearest, ties away), lo the rest,
// passed whole (the MMA reads its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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
// (x, y) as a bf16 pair hi and the pair of what rounding left, lo
__device__ __forceinline__ void pack_split(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The layout of one products' type C and tile width D.  WPR warps share a
// 16-row block (two above width 128), each keeping DO output columns; a
// CTA holds BK rows (the dkdv kernel's keys, the dq kernel's queries); the
// dkdv kernel streams BQ queries a tile, the dq kernel BN keys a tile.
template <typename C, int D> struct Cfg {
  static constexpr int WPR = D > 128 ? 2 : 1;
  static constexpr int DO = D / WPR;
  static constexpr int BK = 16 * kWarps / WPR;
  static constexpr int BQ = D > 64 ? 32 : 64;
  static constexpr int BN = D > 128 ? 32 : 64;
  static constexpr int RS = D + (sizeof(C) == 4 ? 4 : 8);   // row stride
  static constexpr size_t tile(int rows) { return sizeof(C) * rows * RS; }
  // dkdv: K, V and kv_pos; two stages of {qs, dO, lse, Delta, q_pos}; the
  // list of live query blocks
  static constexpr size_t kv_bytes = 2 * tile(BK) + 4 * BK;
  static constexpr size_t q_stage = 2 * tile(BQ) + 3 * 4 * BQ;
  static size_t dkdv_bytes(int n_blocks) {
    return kv_bytes + 2 * q_stage + 4 * n_blocks;
  }
  // dq: qs, dO, lse and Delta of the CTA's queries; two stages of {K, V,
  // kv_pos}; the list of live key tiles
  static constexpr size_t rows_bytes = 2 * tile(BK) + 2 * 4 * BK;
  static constexpr size_t k_stage = 2 * tile(BN) + 4 * BN;
  static size_t dq_bytes(int n_tiles) {
    return rows_bytes + 2 * k_stage + 4 * n_tiles;
  }
};

// ---- the warp's products ---------------------------------------------------

// c[j] (16 x 8 n-tile j) += A B^T over the first KD columns: A the warp's
// 16 rows at stride RS, B 8*NT rows at stride RS.  n-tiles whose bit of
// `live` is clear are skipped.  f32: 3xTF32, the small products first,
// each k-step's into a zeroed accumulator then added to c in f32: the MMA
// aligns its terms to the largest and truncates, so a chain of MMAs into
// one accumulator drifts by a few ulps a step, and dK and dV, sums over
// every query of the group, drift past f32 accuracy (chip_smoke holds
// them to 2x the f32 twin's gap to an f64 one).
template <int NT, int KD, int RS>
__device__ __forceinline__ void rows_dot(float (*c)[4], const float* A,
                                         const float* B, int lane,
                                         unsigned live) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    uint32_t ah[4], al[4];
    split(A[g * RS + 8 * kk + t], ah[0], al[0]);
    split(A[(g + 8) * RS + 8 * kk + t], ah[1], al[1]);
    split(A[g * RS + 8 * kk + t + 4], ah[2], al[2]);
    split(A[(g + 8) * RS + 8 * kk + t + 4], ah[3], al[3]);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* row = B + (8 * j + g) * RS + 8 * kk + t;
      split(row[0], bh[j][0], bl[j][0]);
      split(row[4], bh[j][1], bl[j][1]);
    }
    float f[NT][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if ((live >> j) & 1u) mma_tf32(f[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if ((live >> j) & 1u) mma_tf32(f[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if ((live >> j) & 1u) mma_tf32(f[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += f[j][e];
  }
}

// bf16: A's fragments by ldmatrix (16 rows x 16 columns), B's likewise
// (8 rows x 32 columns: two k-steps), c[j] in f32.
template <int NT, int KD, int RS>
__device__ __forceinline__ void rows_dot(float (*c)[4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, int lane,
                                         unsigned live) {
  const __nv_bfloat16* arow = A + (lane & 15) * RS + 8 * (lane >> 4);
  const __nv_bfloat16* brow = B + (lane & 7) * RS;
  if constexpr (KD >= 32) {
#pragma unroll
    for (int kk = 0; kk < KD / 16; kk += 2) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, arow + 16 * kk);
      ldsm_x4(a1, arow + 16 * (kk + 1));
      uint32_t r[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!((live >> j) & 1u)) continue;
        ldsm_x4(r[j], brow + 8 * j * RS + 16 * kk + 8 * (lane >> 3));
        mma_bf16(c[j], a0, r[j][0], r[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if ((live >> j) & 1u) mma_bf16(c[j], a1, r[j][2], r[j][3]);
    }
  } else {
    uint32_t a[4];
    ldsm_x4(a, arow);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!((live >> j) & 1u)) continue;
      uint32_t r[2];
      ldsm_x2(r, brow + 8 * j * RS + 8 * ((lane >> 3) & 1));
      mma_bf16(c[j], a, r[0], r[1]);
    }
  }
}

// c[n] (16 x 8 output n-tile n, NO of them) += P B: P the warp's 16 x KN
// accumulator fragments p[j] (j < KN/8), B KN rows at stride RS from its
// first output column.  f32: k-step jj reads P's fragment as it stands, slot
// t being key 8jj + 2t and slot t + 4 key 8jj + 2t + 1, and B's rows in that
// order; k-steps whose bit of `live` is clear (P is 0 there) are skipped.
template <int KN, int NO, int RS>
__device__ __forceinline__ void acc_dot(float (*c)[4], const float (*p)[4],
                                        const float* B, int lane,
                                        unsigned live) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int NG = NO < 4 ? NO : 4;
#pragma unroll
  for (int jj = 0; jj < KN / 8; ++jj) {
    if (!((live >> jj) & 1u)) continue;
    uint32_t ah[4], al[4];
    split(p[jj][0], ah[0], al[0]);         // (g, 2t)
    split(p[jj][2], ah[1], al[1]);         // (g + 8, 2t)
    split(p[jj][1], ah[2], al[2]);         // (g, 2t + 1)
    split(p[jj][3], ah[3], al[3]);         // (g + 8, 2t + 1)
    const float* r0 = B + (8 * jj + 2 * t) * RS + g;
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        split(r0[8 * (n0 + n)], bh[n][0], bl[n][0]);
        split(r0[RS + 8 * (n0 + n)], bh[n][1], bl[n][1]);
      }
      float f[NG][4] = {};
#pragma unroll
      for (int n = 0; n < NG; ++n) mma_tf32(f[n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma_tf32(f[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma_tf32(f[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n0 + n][e] += f[n][e];
    }
  }
}

// bf16: the fragments of n-tiles 2kk and 2kk + 1 are the A fragment of
// k-step kk, as a hi + lo pair; B's from ldmatrix.trans (two n-tiles an
// ldmatrix).  Bits 2kk and 2kk + 1 of `live` guard k-step kk.
template <int KN, int NO, int RS>
__device__ __forceinline__ void acc_dot(float (*c)[4], const float (*p)[4],
                                        const __nv_bfloat16* B, int lane,
                                        unsigned live) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    if (!((live >> (2 * kk)) & 3u)) continue;
    uint32_t ah[4], al[4];
    pack_split(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
    pack_split(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
    pack_split(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
    pack_split(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
    const __nv_bfloat16* row =
        B + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * RS;
#pragma unroll
    for (int nt = 0; nt < NO; nt += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, row + 8 * (nt + (lane >> 4)));
      mma_bf16(c[nt], al, r[0], r[1]);
      mma_bf16(c[nt + 1], al, r[2], r[3]);
      mma_bf16(c[nt], ah, r[0], r[1]);
      mma_bf16(c[nt + 1], ah, r[2], r[3]);
    }
  }
}

// ---- staging ------------------------------------------------------------

// `rows` rows of a tile into shared memory (stride Cfg::RS) from `src`,
// whose row r lies at src + r * stride (dk elements): rows from n_valid
// on and columns from dk on zero-filled.  One cp.async commit group is the
// caller's.
template <typename C, int D>
__device__ __forceinline__ void stage_rows(C* dst, const C* src,
                                           long long stride, int n_valid,
                                           int dk, int rows, int tid) {
  constexpr int EPC = 16 / sizeof(C), CPR = D / EPC;
  constexpr int RS = Cfg<C, D>::RS;
  for (int idx = tid; idx < rows * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < n_valid && c * EPC < dk;
    cp_async16(dst + r * RS + c * EPC, ok ? src + r * stride + c * EPC : src,
               ok);
  }
}

// n 4-byte words from src into dst, zero from n_valid on
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int n_valid, int n, int tid) {
  for (int i = tid; i < n; i += kThreads)
    cp_async4(static_cast<int*>(dst) + i,
              static_cast<const int*>(src) + (i < n_valid ? i : 0),
              i < n_valid);
}

// (a, b) as two consecutive elements of a gradient row, in bf16 or f32
__device__ __forceinline__ void store2(void* base, long long at, float a,
                                       float b, bool bf16) {
  if (bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                       at) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(base) + at) =
        make_float2(a, b);
}

// the smallest and largest of (lo, hi) over the warp
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// can a key at kv_pos in [klo, khi] be valid for a query at q_pos in
// [qlo, qhi]?  (some pair of the two ranges passes the masks)
__device__ __forceinline__ bool may_see(int klo, int khi, int qlo, int qhi,
                                        int causal, int window) {
  if (klo > khi || qlo > qhi) return false;
  if (causal && klo > qhi) return false;
  if (window > 0 && static_cast<long long>(khi) <=
                        static_cast<long long>(qlo) - window)
    return false;
  return true;
}
// is every key in [klo, khi] valid for every query in [qlo, qhi]?
__device__ __forceinline__ bool sees_all(int klo, int khi, int qlo, int qhi,
                                         int causal, int window) {
  if (causal && khi > qlo) return false;
  if (window > 0 && static_cast<long long>(klo) <=
                        static_cast<long long>(qhi) - window)
    return false;
  return true;
}
__device__ __forceinline__ bool valid_pair(int kp, int qp, int causal,
                                           int window) {
  return (!causal || kp <= qp) &&
         (window <= 0 ||
          static_cast<long long>(kp) > static_cast<long long>(qp) - window);
}

// Compacts the flags list[0..n) (1 where an entry is live) into the live
// entries' indices, in order; returns their count.  Warp 0 only.
__device__ __forceinline__ int compact(int* list, int n, int lane) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const bool f = base + lane < n && list[base + lane];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    __syncwarp();
    if (f) list[count + __popc(bal & ((1u << lane) - 1))] = base + lane;
    count += __popc(bal);
    __syncwarp();
  }
  return count;
}

// ---- prep: Delta, qs and widened dO ----------------------------------------

// One warp a (b, s, h) row of dk elements: delta[(b*H + h)*S + s] =
// sum dO * O in f32 (O in TO: q's dtype, or f32 where the forward wrote
// the output before its rounding to bf16); qs = q * scale rounded in q's
// dtype, in C; do_c = dO in C where given (bf16 q on the f32 path).
template <typename TQ, typename TO, typename C>
__global__ void __launch_bounds__(256)
prep_kernel(const TQ* __restrict__ q, const TO* __restrict__ out,
            const TQ* __restrict__ dout, float* __restrict__ delta,
            C* __restrict__ qs, float* __restrict__ do_c, long long rows,
            int S, int H, int dk, float scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = row * dk;
  float sum = 0.f;
  for (int d = lane; d < dk; d += 32) {
    const float g = to_f(dout[base + d]);
    sum = fmaf(g, to_f(out[base + d]), sum);
    qs[base + d] = from_f<C>(scaled(q[base + d], scale));
    if (do_c != nullptr) do_c[base + d] = g;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    const long long h = row % H, s = row / H % S, b = row / H / S;
    delta[(b * H + h) * S + s] = sum;
  }
}

__global__ void __launch_bounds__(256)
widen_kernel(const __nv_bfloat16* __restrict__ src, float* __restrict__ dst,
             long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * 256)
    dst[i] = __bfloat162float(src[i]);
}

// ---- dK and dV -------------------------------------------------------------

// One CTA: keys t0 = kb * BK.. of kv head kvh, batch row b, in shared
// memory `smem`.  Warp w owns keys 16*(w / WPR).. and output columns
// (w % WPR) * DO..; lane (g = lane / 4, t = lane % 4) holds its rows g and
// g + 8 of every fragment.  qs, dO and K/V are in C; dk <= D the true head
// dim (the rows' length in memory).  kv_bf16: dK and dV are stored as bf16.
template <typename C, int D>
__device__ __forceinline__ void dkdv_block(
    const C* __restrict__ qs, const C* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const C* __restrict__ k, const C* __restrict__ v,
    void* __restrict__ dk_out, void* __restrict__ dv_out, int kv_bf16,
    int S, int T_, int H, int K, int dk, int causal, int window, int kb,
    int kvh, int b, unsigned char* smem, int& n_live_s) {
  using F = Cfg<C, D>;
  constexpr int RS = F::RS, BK = F::BK, BQ = F::BQ, DO = F::DO;
  constexpr int NT = BQ / 8, NO = DO / 8;
  C* Ks = reinterpret_cast<C*>(smem);
  C* Vs = Ks + BK * RS;
  int* kpos = reinterpret_cast<int*>(Vs + BK * RS);
  unsigned char* ring = smem + F::kv_bytes;
  int* list = reinterpret_cast<int*>(ring + 2 * F::q_stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp / F::WPR, half = warp % F::WPR;
  const int G = H / K;
  const int t0 = kb * BK, n_keys = min(BK, T_ - t0);
  const int n_qb = (S + BQ - 1) / BQ;
  const long long kv_row = static_cast<long long>(K) * dk;

  stage_rows<C, D>(Ks, k + (static_cast<long long>(b) * T_ + t0) * kv_row +
                           static_cast<long long>(kvh) * dk,
                   kv_row, n_keys, dk, BK, tid);
  stage_rows<C, D>(Vs, v + (static_cast<long long>(b) * T_ + t0) * kv_row +
                           static_cast<long long>(kvh) * dk,
                   kv_row, n_keys, dk, BK, tid);
  stage_words(kpos, kv_pos + static_cast<long long>(b) * T_ + t0, n_keys, BK,
              tid);

  // the CTA's key range and the warp's (valid keys only), read from global
  int clo = INT_MAX, chi = INT_MIN;
  for (int i = lane; i < n_keys; i += 32) {
    const int p = __ldg(kv_pos + static_cast<long long>(b) * T_ + t0 + i);
    clo = min(clo, p);
    chi = max(chi, p);
  }
  warp_range(clo, chi);
  int wlo = INT_MAX, whi = INT_MIN;
  const int wk = 16 * rb + (lane & 15);
  if (wk < n_keys) {
    wlo = whi = __ldg(kv_pos + static_cast<long long>(b) * T_ + t0 + wk);
  }
  warp_range(wlo, whi);
  const bool w_all = 16 * rb + 16 <= n_keys;   // every key of the warp < T
  // the lane's two key rows
  int kp[2];
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * rb + g + 8 * i;
    kok[i] = r < n_keys;
    kp[i] = kok[i] ? __ldg(kv_pos + static_cast<long long>(b) * T_ + t0 + r)
                   : 0;
  }

  // the live query blocks: those holding a query that one of the CTA's
  // keys can be valid for
  for (int i = warp; i < n_qb; i += kWarps) {
    bool live = false;
#pragma unroll
    for (int h2 = 0; h2 < BQ / 32; ++h2) {
      const int s = i * BQ + lane + 32 * h2;
      if (s < S) {
        const int p = __ldg(q_pos + static_cast<long long>(b) * S + s);
        live |= may_see(clo, chi, p, p, causal, window);
      }
    }
    live = __any_sync(0xffffffffu, live);
    if (lane == 0) list[i] = live;
  }
  __syncthreads();
  if (warp == 0) {
    const int n = compact(list, n_qb, lane);
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int n_items = G * n_live;

  // item i: head kvh*G + i / n_live, query block list[i % n_live]
  auto load_item = [&](int i, int st) {
    unsigned char* base = ring + st * F::q_stage;
    C* Qt = reinterpret_cast<C*>(base);
    C* Dt = Qt + BQ * RS;
    float* ls = reinterpret_cast<float*>(Dt + BQ * RS);
    const int h = kvh * G + i / n_live, s0 = list[i % n_live] * BQ;
    const int nq = min(BQ, S - s0);
    const long long q_row = static_cast<long long>(H) * dk;
    const long long off = (static_cast<long long>(b) * S + s0) * q_row +
                          static_cast<long long>(h) * dk;
    stage_rows<C, D>(Qt, qs + off, q_row, nq, dk, BQ, tid);
    stage_rows<C, D>(Dt, dO + off, q_row, nq, dk, BQ, tid);
    const long long r0 = (static_cast<long long>(b) * H + h) * S + s0;
    stage_words(ls, lse + r0, nq, BQ, tid);
    stage_words(ls + BQ, delta + r0, nq, BQ, tid);
    stage_words(ls + 2 * BQ, q_pos + static_cast<long long>(b) * S + s0, nq,
                BQ, tid);
  };

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (n_items > 0) load_item(0, 0);
  cp_commit();
  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    cp_wait_all();
    __syncthreads();            // item it landed; every warp is done with it - 1
    if (it + 1 < n_items) load_item(it + 1, st ^ 1);
    cp_commit();

    const unsigned char* base = ring + st * F::q_stage;
    const C* Qt = reinterpret_cast<const C*>(base);
    const C* Dt = Qt + BQ * RS;
    const float* ls = reinterpret_cast<const float*>(Dt + BQ * RS);
    const float* dl = ls + BQ;
    const int* qp = reinterpret_cast<const int*>(ls + 2 * BQ);
    const int s0 = list[it % n_live] * BQ;
    const int nq = min(BQ, S - s0);

    // bit j of `live`: some (key, query) pair of n-tile j may be valid;
    // `full`: every pair of the warp's keys and the tile's queries is
    bool seen[BQ / 32], all = w_all;
#pragma unroll
    for (int h2 = 0; h2 < BQ / 32; ++h2) {
      const int c = lane + 32 * h2;
      const int p = qp[c];
      seen[h2] = c < nq && may_see(wlo, whi, p, p, causal, window);
      all &= c < nq && sees_all(wlo, whi, p, p, causal, window);
    }
    const bool full = __all_sync(0xffffffffu, all);
    unsigned long long cols = __ballot_sync(0xffffffffu, seen[0]);
    if constexpr (BQ > 32)
      cols |= static_cast<unsigned long long>(
                  __ballot_sync(0xffffffffu, seen[BQ / 32 - 1])) << 32;
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) live |= ((cols >> (8 * j)) & 0xffull) ? 1u << j : 0u;
    if (!live) continue;

    // P^T = exp(S^T - lse) on the valid pairs
    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    rows_dot<NT, D, RS>(p, Ks + 16 * rb * RS, Qt, lane, live);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), i = e >> 1;
        const bool ok = full || (kok[i] && c < nq &&
                                 valid_pair(kp[i], qp[c], causal, window));
        p[j][e] = ok ? exp2f(fmaf(p[j][e], kLog2e, -ls[c] * kLog2e)) : 0.f;
      }
    // dP^T = V dO^T
    float ds[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    rows_dot<NT, D, RS>(ds, Vs + 16 * rb * RS, Dt, lane, live);
    // dV += P^T dO
    acc_dot<BQ, NO, RS>(dv_acc, p, Dt + half * DO, lane, live);
    // dS^T = P^T o (dP^T - Delta); dK += dS^T qs
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        ds[j][e] = p[j][e] * (ds[j][e] - dl[c]);
      }
    acc_dot<BQ, NO, RS>(dk_acc, ds, Qt + half * DO, lane, live);
  }
  cp_wait_all();                // nothing in flight at exit

  // dK, dV once, in K/V's dtype; columns from dk on are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kok[i]) continue;
    const int key = t0 + 16 * rb + g + 8 * i;
    const long long row = (static_cast<long long>(b) * T_ + key) * kv_row +
                          static_cast<long long>(kvh) * dk;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = half * DO + 8 * n + 2 * t;
      if (col >= dk) continue;
      store2(dk_out, row + col, dk_acc[n][2 * i], dk_acc[n][2 * i + 1],
             kv_bf16);
      store2(dv_out, row + col, dv_acc[n][2 * i], dv_acc[n][2 * i + 1],
             kv_bf16);
    }
  }
}

// ---- dQ ------------------------------------------------------------------

// One CTA: queries s0 = qb * BK.. of head h, batch row b, in shared memory
// `smem`.  Warp w owns queries 16*(w / WPR).. and output columns
// (w % WPR) * DO...  q_bf16: dQ is stored as bf16.
template <typename C, int D>
__device__ __forceinline__ void dq_block(
    const C* __restrict__ qs, const C* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const C* __restrict__ k, const C* __restrict__ v,
    void* __restrict__ dq_out, int q_bf16, int S, int T_, int H, int K,
    int dk, int causal, int window, float scale, int qb, int h, int b,
    unsigned char* smem, int& n_live_s) {
  using F = Cfg<C, D>;
  constexpr int RS = F::RS, BK = F::BK, BN = F::BN, DO = F::DO;
  constexpr int NT = BN / 8, NO = DO / 8;
  C* Qt = reinterpret_cast<C*>(smem);
  C* Dt = Qt + BK * RS;
  float* ls = reinterpret_cast<float*>(Dt + BK * RS);
  float* dl = ls + BK;
  unsigned char* ring = smem + F::rows_bytes;
  int* list = reinterpret_cast<int*>(ring + 2 * F::k_stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp / F::WPR, half = warp % F::WPR;
  const int kvh = h / (H / K);
  const int s0 = qb * BK, nq = min(BK, S - s0);
  const int n_kt = (T_ + BN - 1) / BN;
  const long long q_row = static_cast<long long>(H) * dk;
  const long long kv_row = static_cast<long long>(K) * dk;
  const long long qoff = (static_cast<long long>(b) * S + s0) * q_row +
                         static_cast<long long>(h) * dk;
  const long long r0 = (static_cast<long long>(b) * H + h) * S + s0;

  stage_rows<C, D>(Qt, qs + qoff, q_row, nq, dk, BK, tid);
  stage_rows<C, D>(Dt, dO + qoff, q_row, nq, dk, BK, tid);
  stage_words(ls, lse + r0, nq, BK, tid);
  stage_words(dl, delta + r0, nq, BK, tid);

  // the CTA's query range and the warp's; the lane's two rows
  const int* qpb = q_pos + static_cast<long long>(b) * S + s0;
  int clo = INT_MAX, chi = INT_MIN;
  for (int i = lane; i < nq; i += 32) {
    const int p = __ldg(qpb + i);
    clo = min(clo, p);
    chi = max(chi, p);
  }
  warp_range(clo, chi);
  int wlo = INT_MAX, whi = INT_MIN;
  const int wq = 16 * rb + (lane & 15);
  if (wq < nq) wlo = whi = __ldg(qpb + wq);
  warp_range(wlo, whi);
  const bool w_all = 16 * rb + 16 <= nq;
  int qp[2];
  bool qok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * rb + g + 8 * i;
    qok[i] = r < nq;
    qp[i] = qok[i] ? __ldg(qpb + r) : 0;
  }

  // the live key tiles: those holding a key valid for one of the queries
  const int* kpb = kv_pos + static_cast<long long>(b) * T_;
  for (int i = warp; i < n_kt; i += kWarps) {
    bool live = false;
#pragma unroll
    for (int h2 = 0; h2 < BN / 32; ++h2) {
      const int c = i * BN + lane + 32 * h2;
      if (c < T_) {
        const int p = __ldg(kpb + c);
        live |= may_see(p, p, clo, chi, causal, window);
      }
    }
    live = __any_sync(0xffffffffu, live);
    if (lane == 0) list[i] = live;
  }
  __syncthreads();
  if (warp == 0) {
    const int n = compact(list, n_kt, lane);
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;

  auto load_tile = [&](int i, int st) {
    unsigned char* base = ring + st * F::k_stage;
    C* Kt = reinterpret_cast<C*>(base);
    C* Vt = Kt + BN * RS;
    int* kp = reinterpret_cast<int*>(Vt + BN * RS);
    const int k0 = list[i] * BN, nk = min(BN, T_ - k0);
    const long long off = (static_cast<long long>(b) * T_ + k0) * kv_row +
                          static_cast<long long>(kvh) * dk;
    stage_rows<C, D>(Kt, k + off, kv_row, nk, dk, BN, tid);
    stage_rows<C, D>(Vt, v + off, kv_row, nk, dk, BN, tid);
    stage_words(kp, kpb + k0, nk, BN, tid);
  };

  float dq_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};

  if (n_live > 0) load_tile(0, 0);
  cp_commit();
  for (int it = 0; it < n_live; ++it) {
    const int st = it & 1;
    cp_wait_all();
    __syncthreads();
    if (it + 1 < n_live) load_tile(it + 1, st ^ 1);
    cp_commit();
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * rb + g + 8 * i;
        lse2[i] = ls[r] * kLog2e;
        dlt[i] = dl[r];
      }
    }

    const unsigned char* base = ring + st * F::k_stage;
    const C* Kt = reinterpret_cast<const C*>(base);
    const C* Vt = Kt + BN * RS;
    const int* kp = reinterpret_cast<const int*>(Vt + BN * RS);
    const int k0 = list[it] * BN, nk = min(BN, T_ - k0);

    bool seen[BN / 32], all = w_all;
#pragma unroll
    for (int h2 = 0; h2 < BN / 32; ++h2) {
      const int c = lane + 32 * h2;
      const int p = kp[c];
      seen[h2] = c < nk && may_see(p, p, wlo, whi, causal, window);
      all &= c < nk && sees_all(p, p, wlo, whi, causal, window);
    }
    const bool full = __all_sync(0xffffffffu, all);
    unsigned long long cols = __ballot_sync(0xffffffffu, seen[0]);
    if constexpr (BN > 32)
      cols |= static_cast<unsigned long long>(
                  __ballot_sync(0xffffffffu, seen[BN / 32 - 1])) << 32;
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) live |= ((cols >> (8 * j)) & 0xffull) ? 1u << j : 0u;
    if (!live) continue;

    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    rows_dot<NT, D, RS>(p, Qt + 16 * rb * RS, Kt, lane, live);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), i = e >> 1;
        const bool ok = full || (qok[i] && c < nk &&
                                 valid_pair(kp[c], qp[i], causal, window));
        p[j][e] = ok ? exp2f(fmaf(p[j][e], kLog2e, -lse2[i])) : 0.f;
      }
    float ds[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    rows_dot<NT, D, RS>(ds, Dt + 16 * rb * RS, Vt, lane, live);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - dlt[e >> 1]);
    acc_dot<BN, NO, RS>(dq_acc, ds, Kt + half * DO, lane, live);
  }
  cp_wait_all();                // nothing in flight at exit

  // dQ = scale * dS K once, in q's dtype
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!qok[i]) continue;
    const long long row =
        qoff + static_cast<long long>(16 * rb + g + 8 * i) * q_row;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = half * DO + 8 * n + 2 * t;
      if (col >= dk) continue;
      store2(dq_out, row + col, scale * dq_acc[n][2 * i],
             scale * dq_acc[n][2 * i + 1], q_bf16);
    }
  }
}

// ---- the gradients' launch ------------------------------------------------

// One launch of both: its first n_kb * K * B CTAs are dK/dV blocks, key
// block by key block from the first (which sees the most queries under a
// causal mask), the rest dQ blocks, query block by query block from the
// last (which sees the most keys).  The dQ blocks fill the SMs that the
// dK/dV blocks' causal tail leaves idle.
template <typename C, int D>
__global__ void __launch_bounds__(kThreads)
grads_kernel(const C* __restrict__ qs, const C* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             const C* __restrict__ k, const C* __restrict__ v,
             void* __restrict__ dq_out, void* __restrict__ dk_out,
             void* __restrict__ dv_out, int q_bf16, int kv_bf16, int B,
             int S, int T_, int H, int K, int dk, int causal, int window,
             float scale, int n_kb, int n_qb) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int n_live_s;
  const int x = blockIdx.x, n_kv = n_kb * K * B;
  if (x < n_kv) {
    const int r = x % (K * B);
    dkdv_block<C, D>(qs, dO, lse, delta, q_pos, kv_pos, k, v, dk_out,
                     dv_out, kv_bf16, S, T_, H, K, dk, causal, window,
                     x / (K * B), r / B, r % B, smem, n_live_s);
  } else {
    const int y = x - n_kv, r = y % (H * B);
    dq_block<C, D>(qs, dO, lse, delta, q_pos, kv_pos, k, v, dq_out, q_bf16,
                   S, T_, H, K, dk, causal, window, scale,
                   n_qb - 1 - y / (H * B), r / B, r % B, smem, n_live_s);
  }
}

// ---- host side ------------------------------------------------------------

template <typename C, int D>
int opt_in(int max_smem) {
  cudaFuncAttributes attr;
  if (cudaError_t e = cudaFuncGetAttributes(&attr, grads_kernel<C, D>))
    return static_cast<int>(e);
  if (cudaError_t e = cudaFuncSetAttribute(
          grads_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          max_smem - static_cast<int>(attr.sharedSizeBytes)))
    return static_cast<int>(e);
  return 0;
}

template <typename C, int D>
int launch_grads(const C* qs, const C* dO, const float* lse,
                 const float* delta, const int* q_pos, const int* kv_pos,
                 const C* k, const C* v, void* dq, void* dk_out, void* dv_out,
                 int q_bf16, int kv_bf16, int B, int S, int T_, int H, int K,
                 int dk, int causal, int window, float scale,
                 cudaStream_t stream) {
  using F = Cfg<C, D>;
  const int n_kb = (T_ + F::BK - 1) / F::BK, n_qb = (S + F::BK - 1) / F::BK;
  const long long ctas = (static_cast<long long>(n_kb) * K +
                          static_cast<long long>(n_qb) * H) * B;
  if (ctas >= (1LL << 31)) return -1;
  const size_t a = F::dkdv_bytes((S + F::BQ - 1) / F::BQ);
  const size_t c = F::dq_bytes((T_ + F::BN - 1) / F::BN);
  grads_kernel<C, D><<<static_cast<unsigned>(ctas), kThreads, a > c ? a : c,
                       stream>>>(
      qs, dO, lse, delta, q_pos, kv_pos, k, v, dq, dk_out, dv_out, q_bf16,
      kv_bf16, B, S, T_, H, K, dk, causal, window, scale, n_kb, n_qb);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(long long n, int per) {
  const long long want = (n + per - 1) / per;
  return static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
}

}  // namespace bw
}  // namespace

extern "C" {

// The shared-memory opt-in of every dK/dV and dQ instantiation on the
// current device; the wrapper calls it once a device.  Returns a
// cudaError_t.
int flash_backward_prepare() {
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define OPT_IN(D)                                                           \
  if (int err = bw::opt_in<float, D>(max_smem)) return err;                 \
  if (int err = bw::opt_in<__nv_bfloat16, D>(max_smem)) return err;
  OPT_IN(16) OPT_IN(32) OPT_IN(64) OPT_IN(96) OPT_IN(128) OPT_IN(256)
#undef OPT_IN
  return 0;
}

// dq (B,S,H,D), dk and dv (B,T,K,D) of the attention whose forward wrote
// `out` (B,S,H,D, q's dtype) and `lse` (B,H,S f32), for the upstream
// gradient dout (B,S,H,D, q's dtype); q, k, v the forward's inputs, all
// contiguous and 16-byte aligned, D = Dv a multiple of 8 at or below
// `width` (16, 32, 64, 96, 128 or 256).  dtype_q, dtype_kv: 0 = float32, 1 =
// bfloat16.  Workspaces, each 16-byte aligned: qs (B,S,H,D) in the
// products' type (bf16 where q and k/v are both bf16, else f32), delta
// (B,H,S) f32, and where q is bf16 over f32 K/V do_f32 (B,S,H,D) f32, where
// q is f32 over bf16 K/V k_f32 and v_f32 (B,T,K,D) f32 (null otherwise).
// Where q is bf16 over f32 K/V, `out32` (B,S,H,D) f32 is the forward's
// output before its rounding to bf16, which Delta reads (null otherwise).
// Launches prep (and widen), then the dK/dV and the dQ kernels on `stream`.
// Returns a cudaError_t (0 = launched); -1 for a shape this kernel does not
// take.
int flash_backward_launch(const void* q, const void* k, const void* v,
                          const void* out, const float* out32,
                          const void* dout, const float* lse,
                          const int* q_pos, const int* kv_pos, void* dq,
                          void* dk, void* dv, void* qs, float* delta,
                          float* do_f32, float* k_f32, float* v_f32, int B,
                          int S, int T_, int H, int K, int D, int causal,
                          int window, float scale, int dtype_q, int dtype_kv,
                          int width, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || T_ < 1 || D < 8 || D % 8 != 0 || D > width ||
      dtype_q < 0 || dtype_q > 1 || dtype_kv < 0 || dtype_kv > 1)
    return -1;
  if (width != 16 && width != 32 && width != 64 && width != 96 &&
      width != 128 && width != 256)
    return -1;
  const bool bf16 = dtype_q == 1 && dtype_kv == 1;
  if ((dtype_q == 1 && !bf16) != (do_f32 != nullptr) ||
      (dtype_kv == 1 && !bf16) != (k_f32 != nullptr && v_f32 != nullptr) ||
      (dtype_q == 1 && !bf16) != (out32 != nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  const int prep_blocks = bw::blocks_for(rows, 8);
  if (static_cast<long long>(prep_blocks) * 8 < rows) return -1;
  const float* dO_c = static_cast<const float*>(dout);
  if (bf16) {
    bw::prep_kernel<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>
        <<<prep_blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(dout), delta,
        static_cast<__nv_bfloat16*>(qs), nullptr, rows, S, H, D, scale);
  } else if (dtype_q == 1) {
    bw::prep_kernel<__nv_bfloat16, float, float><<<prep_blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), out32,
        static_cast<const __nv_bfloat16*>(dout), delta,
        static_cast<float*>(qs), do_f32, rows, S, H, D, scale);
    dO_c = do_f32;
  } else {
    bw::prep_kernel<float, float, float><<<prep_blocks, 256, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(out),
        static_cast<const float*>(dout), delta, static_cast<float*>(qs),
        nullptr, rows, S, H, D, scale);
  }
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const float* k_c = static_cast<const float*>(k);
  const float* v_c = static_cast<const float*>(v);
  if (dtype_kv == 1 && !bf16) {
    const long long n = static_cast<long long>(B) * T_ * K * D;
    const int blocks = bw::blocks_for(n, 256);
    bw::widen_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k), k_f32, n);
    bw::widen_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v), v_f32, n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    k_c = k_f32;
    v_c = v_f32;
  }
#define GRADS(W)                                                            \
  if (width == W) {                                                         \
    if (bf16)                                                               \
      return bw::launch_grads<__nv_bfloat16, W>(                            \
          static_cast<const __nv_bfloat16*>(qs),                            \
          static_cast<const __nv_bfloat16*>(dout), lse, delta, q_pos,       \
          kv_pos, static_cast<const __nv_bfloat16*>(k),                     \
          static_cast<const __nv_bfloat16*>(v), dq, dk, dv, 1, 1, B, S, T_, \
          H, K, D, causal, window, scale, s);                               \
    return bw::launch_grads<float, W>(                                      \
        static_cast<const float*>(qs), dO_c, lse, delta, q_pos, kv_pos,     \
        k_c, v_c, dq, dk, dv, dtype_q, dtype_kv, B, S, T_, H, K, D, causal, \
        window, scale, s);                                                  \
  }
  GRADS(16) GRADS(32) GRADS(64) GRADS(96) GRADS(128) GRADS(256)
#undef GRADS
  return -1;
}

}  // extern "C"

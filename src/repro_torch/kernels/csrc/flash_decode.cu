// The split-KV decode kernel of K3 (S = 1): the contract, its bounds and
// the rounding order are those of flash_attention.cu, which holds the
// prefill kernel; the wrapper kernels/flash_attention.py launches this one
// for every S = 1 call.
//
// Decode design (split-KV, "flash-decoding"): the grid is (split, kv head x
// head group, batch row).  A split is a contiguous range of cache slots;
// kernels/flash_attention.py::decode_plan picks the number of splits from
// B*K, T and the SM count so that the grid holds about four CTAs per SM.  A
// CTA computes only the query heads that exist: a group of GC of the G heads
// of its kv head (GC*F floats of q and of accumulator a lane, F = 4 to 24).
// Its four warps split the keys of the range; within a warp, LPK lanes
// hold one key row in 16-byte vectors, LPK the largest power of two (at
// most 32) that divides the row's D/VEC chunks, CH = D/(VEC*LPK) chunks a
// lane (one row a warp instruction at D = 128 f32, several at smaller D; at
// D = 256 one row a warp in two chunks a lane in f32, one in bf16; at D =
// 96, 8 lanes of 3 chunks in f32, 4 in bf16), and each lane keeps its slice
// of the GC query vectors and accumulators in registers.
// D is the tile width (16, 32, 64, 96, 128, 256, 512).  With kPad (the
// padded widths 64, 96, 128, 256, 512) the true head dim d <= D, a multiple
// of 8, is a runtime argument: the rows of q, k, v and out are d long in
// memory, a lane's chunks past d are neither loaded nor stored (q and K
// read zeros there), and the partials keep D columns; without it d = D and
// nothing is masked.  A warp
// loads U key rows of K and V before it uses any, scores them with a
// shuffle reduction over the lanes of a row, and folds them into its
// running max, sum and accumulator once per chunk.  The CTA stages the
// validity of up to kSeg slots at a time in shared memory, from each
// slot's kv_pos; a stage with no valid key is skipped, and a split with
// none loads no K/V and writes m = -1e30, l = 0.  The warps' states are
// merged in shared memory into the split's partials.
// The last CTA of each (batch row, head group) to finish, found by an
// integer ticket taken after its partials are fenced, combines that group's
// splits in a fixed order: m = max m_i, l = sum l_i exp(m_i - m), the same
// for the accumulator (in split order), out = acc / max(l, 1e-30).  So
// decode is one launch; the partials and the tickets are the wrapper's
// workspace, and the last CTA leaves its ticket at 0 for the next launch.
// No float atomics: whichever CTA combines, it adds in the same order, and
// the result is the same from run to run.
//
// An int8 cache (K3d) comes with one f32 scale a (token, kv head) for K and
// one for V, (B,T,K) each.  A lane loads 4 int8 values (4 bytes) where it
// loads 4 f32 values of an f32 cache, so the lanes, rows and head groups
// are laid out as for f32; each value is widened and multiplied by its
// row's scale as it is loaded (the reference's int8 * scale, then the f32
// product), and no dequantised copy is written.
//
// The cluster form (decode_cluster_kernel, below), which
// kernels/flash_attention.py::decode_layout picks for the shapes it is
// instantiated at (q, K/V, head dim and head group in CLUSTER_DECODE, the
// serving paths' shapes: f32 at D 64 and head group 8 (tinyllama) and its
// int8 twin (K3d), bf16 q over f32 K/V at D 128 and head groups 8 (qwen1.5,
// qwen2-vl) and 4 (jamba), and int8 at D 128 and head group 4), with at
// most 8 splits of at most 1024 slots; every other shape runs the layout
// above.  At
// tinyllama's row (8 rows over 1024 slots, live 17-332) the layout above
// spends most of its time (PERF.md §6) in the combine (fence, ticket and
// the last CTA's reads of 16 splits' partials from L2), then in the live
// splits' compute (every lane of a key row repeats the softmax of all its
// group's heads, behind a chain of shuffles), the K/V loads (U rows a
// lane in flight) and the dead splits.
// The cluster form answers each:
// - The splits of one (batch row, kv head, head group) are one thread
//   block cluster of n_split <= 8 CTAs (cudaLaunchKernelEx with a cluster
//   dimension, one launch), sized so that the grid is one wave.  A
//   cluster's ranks take its splits rotated by the cluster's index, so
//   the first splits of short rows (the live ones of a linear cache) fall
//   on other SMs from cluster to cluster.  Each CTA
//   stores its split's f32 (m, l, acc) into rank 0's shared memory
//   (distributed shared memory); one cluster barrier later rank 0
//   combines them in split order: m = max m_i, weights exp(m_i - m) for
//   the splits with l_i > 0, l and acc summed in split order, out = acc /
//   max(l, 1e-30).  A first phase of the barrier, arrived at on entry and
//   waited on before the stores, makes sure the whole cluster has
//   started.  No global workspace, no fence, no ticket, no atomics: the
//   same bits from run to run.
// - A CTA loads its split's kv_pos once (an int a slot, up to 1024 slots)
//   beside q (16-byte cp.async copies into shared memory), marks each
//   slot's validity and each tile's; a split with no valid key stops there
//   and stores m = -1e30, l = 0.
// - A live split's K/V rows stream through a ring of 3 stages of 16 KB
//   (TK = 16 KB / (2 x row bytes) slots a stage) as 16-byte cp.async
//   copies, only the valid rows read (the others zero-filled by the
//   copy's src-size 0), tiles with no valid key neither copied nor
//   scored; the first 48 KB of a split arrive in one latency, the rest
//   behind the compute.  An int8 cache's scales come in the same copies
//   (4 bytes a row).
// - Four warps score a tile's rows from shared memory.  A lane holds HL =
//   min(GC, 4) of the group's heads (q and accumulator) and 32 / HL of
//   each one's dims, so a head's row lies on L = D * HL / 32 lanes and a
//   warp reads 32 / (L * GC / HL) rows at once: a row's dot product takes
//   log2(L) shuffles, each K/V element reaches GC / HL lanes, and a head's
//   softmax runs on its own lanes only.  (The layout above, every lane
//   holding all GC heads, and one lane group a head, each K/V element
//   read by GC lane groups, both ran slower on an H100: PERF.md §6.)
//   e^x is exp2f(x log2 e) after one FFMA (flash_attention.cu's
//   rounding), and the accumulators are rescaled only where some head's
//   max moved.  The warps' states are merged in shared memory (aliased
//   onto the ring), one weight a (warp, head).
// Scores and the running state stay f32 FMAs; q is scaled in its own
// dtype, int8 K/V widened and scaled as they are read from shared memory;
// the masks come from kv_pos on the device, with no host-side length.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

// A lane's load of one key or value row chunk: 16 bytes of f32 or bf16
// (Vec16), or 4 int8 values, widened to f32
template <typename T> struct KvLoad {
  using Raw = uint4;
  static constexpr int N = Vec16<T>::N;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* f) {
    Vec16<T>::widen(r, f);
  }
};
template <> struct KvLoad<int8_t> {
  using Raw = unsigned int;
  static constexpr int N = 4;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>((r >> (8 * i)) & 0xffu));
  }
};

// ---- split-KV decode ----------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kSeg = 256;      // slots whose validity a CTA stages at once
constexpr int kMaxSplits = 512;  // splits a combine weighs at once

// One CTA: batch row b, kv head kvh, query heads [h0, h0 + ng) of it (a head
// group of at most GC), slots [split * split_len, +split_len) of the cache.
// Writes that range's f32 (max, sum, accumulator) for each of its heads to
// part: m at [row], l at [BH*NS + row], acc at [2*BH*NS + row*D], with row =
// (b*H + h)*NS + split.  q and out are TQ, K and V TKV; an int8 TKV comes
// with k_scale/v_scale (B,T,K) f32, which are null otherwise.
template <typename TQ, typename TKV, int D, int GC, bool kPad>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, TQ* __restrict__ out,
                    float* part, int* counters, int T_, int H, int K, int G,
                    int d_arg, int NS, int split_len, int causal, int window,
                    float scale) {
  const int d = kPad ? d_arg : D;
  using Load = KvLoad<TKV>;
  using Raw = typename Load::Raw;
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int VEC = Load::N;
  constexpr int NCH = D / VEC;               // 16-byte chunks a row
  constexpr int LOW = NCH & -NCH;            // its largest power-of-two factor
  constexpr int LPK = LOW < 32 ? LOW : 32;   // lanes holding a key row
  constexpr int CH = NCH / LPK;              // 16-byte chunks a lane of a row
  constexpr int F = CH * VEC;                // floats of a head a lane holds
  constexpr int KPW = 32 / LPK;              // key rows a warp loads at once
  constexpr int U = (GC >= 8 ? 2 : 4) / CH;  // loads in flight per lane
  constexpr int KPC = KPW * U;               // keys of a warp's chunk
  static_assert(LPK >= 1 && (32 % LPK) == 0 && F * LPK == D && U >= 1,
                "head dim");

  __shared__ unsigned char ok_s[kSeg];
  __shared__ float red_m[kDecWarps][GC], red_l[kDecWarps][GC];
  __shared__ float red_acc[kDecWarps][GC][D];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y % K, hg = blockIdx.y / K;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPK, dl = lane % LPK;
  const int h0 = kvh * G + hg * GC;
  const int ng = min(GC, G - hg * GC);
  const int qp = q_pos[b];
  const long long BH = static_cast<long long>(gridDim.z) * H;

  // the lane's head dims: chunk ch holds dims (ch*LPK + dl)*VEC + e
  float qv[GC][F];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x = 0.f;
        const int dim = (ch * LPK + dl) * VEC + e;
        if (g < ng && (!kPad || dim < d))  // q scaled in its own dtype
          x = scaled(q[(static_cast<long long>(b) * H + h0 + g) * d + dim],
                     scale);
        qv[g][ch * VEC + e] = x;
      }
  float m[GC], l[GC], acc[GC][F];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < F; ++e) acc[g][e] = 0.f;
  }

  const int t_begin = split * split_len;
  const int t_end = min(T_, t_begin + split_len);
  const long long kv_row = static_cast<long long>(b) * T_;
  bool any_live = false;
  for (int s0 = t_begin; s0 < t_end; s0 += kSeg) {
    const int n = min(kSeg, t_end - s0);
    bool live = false;
    for (int i = threadIdx.x; i < n; i += kDecThreads) {
      const int p = kv_pos[kv_row + s0 + i];
      const bool ok = (!causal || p <= qp) &&
                      (window <= 0 || static_cast<long long>(p) >
                                          static_cast<long long>(qp) - window);
      ok_s[i] = ok;
      live |= ok;
    }
    if (!__syncthreads_or(live)) continue;   // no valid key in this stage
    any_live = true;

    for (int c = warp * KPC; c < n; c += kDecWarps * KPC) {
      Raw kr[U][CH], vr[U][CH];
      float ks[U], vs[U];                    // the rows' scales (int8)
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {          // every load before any use
        const int i = c + u * KPW + sub;
        ok[u] = i < n && ok_s[i];
        ks[u] = vs[u] = 0.f;
        if (kInt8 && ok[u]) {
          const long long r = (kv_row + s0 + i) * K + kvh;
          ks[u] = __ldg(k_scale + r);
          vs[u] = __ldg(v_scale + r);
        }
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          kr[u][ch] = vr[u][ch] = Raw{};
          const int dim = (ch * LPK + dl) * VEC;
          if (ok[u] && (!kPad || dim < d)) {
            const long long off = ((kv_row + s0 + i) * K + kvh) * d + dim;
            kr[u][ch] = Load::load(k + off);
            vr[u][ch] = Load::load(v + off);
          }
        }
      }
      float s[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[F];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
          Load::widen(kr[u][ch], kf + ch * VEC);
        if (kInt8) {
#pragma unroll
          for (int e = 0; e < F; ++e) kf[e] *= ks[u];
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < F; ++e) d = fmaf(qv[g][e], kf[e], d);
          s[u][g] = d;
        }
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)  // sum over the lanes of a row
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GC; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
#pragma unroll
      for (int g = 0; g < GC; ++g) {         // the chunk's max, warp-wide
        float cm = kNegInf;
#pragma unroll
        for (int u = 0; u < U; ++u) cm = fmaxf(cm, ok[u] ? s[u][g] : kNegInf);
#pragma unroll
        for (int o = 16; o >= LPK; o >>= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float mn = fmaxf(m[g], cm);
        const float corr = expf(m[g] - mn);
        m[g] = mn;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < F; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[F];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
          Load::widen(vr[u][ch], vf + ch * VEC);
        if (kInt8) {
#pragma unroll
          for (int e = 0; e < F; ++e) vf[e] *= vs[u];
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = ok[u] ? expf(s[u][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < F; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                         // before ok_s is restaged
  }

  const long long row0 = (static_cast<long long>(b) * H + h0) * NS + split;
  if (!any_live) {                           // the split has no valid key
    if (threadIdx.x < ng) {
      part[row0 + threadIdx.x * NS] = kNegInf;
      part[BH * NS + row0 + threadIdx.x * NS] = 0.f;
    }
  } else {
    // a warp's state: sum over the KPW rows of its loads (m is warp-wide)
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int o = 16; o >= LPK; o >>= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < F; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
    if (sub == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            red_acc[warp][g][(ch * LPK + dl) * VEC + e] = acc[g][ch * VEC + e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ng * D; idx += kDecThreads) {
      const int g = idx / D, c = idx % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float cw = expf(red_m[w][g] - mx);
        a = fmaf(red_acc[w][g][c], cw, a);
        ls = fmaf(red_l[w][g], cw, ls);
      }
      const long long row = row0 + static_cast<long long>(g) * NS;
      part[2 * BH * NS + row * D + c] = a;
      if (c == 0) {
        part[row] = mx;
        part[BH * NS + row] = ls;
      }
    }
  }

  // The last CTA of this (batch row, head group) to finish combines its
  // NS splits, in split order; it finds itself by a ticket taken after
  // every thread's partials are fenced, and resets the counter for the
  // next launch.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = counters + static_cast<long long>(b) * gridDim.y + blockIdx.y;
    last = atomicAdd(c, 1) == NS - 1;
    if (last) atomicExch(c, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a warp a head: its max over the splits, then each split's weight
  // exp(m_i - m) (0 for an empty split) into shared memory and the sum;
  // lanes stride over the splits and a butterfly adds them, a fixed order
  __shared__ float w_s[GC][kMaxSplits], l_s[GC];
  for (int g = warp; g < ng; g += kDecWarps) {
    const long long r = static_cast<long long>(b) * H + h0 + g;
    float mx = kNegInf, ls = 0.f;
    for (int i = lane; i < NS; i += 32)
      mx = fmaxf(mx, __ldcg(part + r * NS + i));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    for (int i = lane; i < NS; i += 32) {
      const float li = __ldcg(part + BH * NS + r * NS + i);
      const float w = li > 0.f ? expf(__ldcg(part + r * NS + i) - mx) : 0.f;
      w_s[g][i] = w;
      ls = fmaf(li, w, ls);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, o);
    if (lane == 0) l_s[g] = ls;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += kDecThreads) {
    const int g = idx / D, c = idx % D;
    if (kPad && c >= d) continue;             // a zero column of the tile
    const long long r = static_cast<long long>(b) * H + h0 + g;
    const float* pa = part + 2 * BH * NS + r * NS * D + c;
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < NS; ++i) {   // in split order
      const float x = __ldcg(pa + static_cast<long long>(i) * D);
      const float w = w_s[g][i];
      a = w != 0.f ? fmaf(x, w, a) : a;  // an empty split wrote no x
    }
    out[r * d + c] = from_f<TQ>(a / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, int GC, bool kPad>
int launch_decode(const void* q, const void* k, const void* v,
                  const float* k_scale, const float* v_scale,
                  const int* q_pos, const int* kv_pos, void* out, float* part,
                  int* counters, int B, int T_, int H, int K, int d,
                  int causal, int window, float scale, int NS, int split_len,
                  cudaStream_t stream) {
  const int G = H / K;
  if (d > D || (!kPad && d != D)) return -1;
  dim3 grid(NS, K * ((G + GC - 1) / GC), B);
  decode_split_kernel<TQ, TKV, D, GC, kPad><<<grid, kDecThreads, 0,
                                               stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale, q_pos, kv_pos,
      static_cast<TQ*>(out), part, counters, T_, H, K, G, d, NS, split_len,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the cluster form ---------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClWarps = 4;
constexpr int kClThreads = 32 * kClWarps;
constexpr int kClMax = 8;             // CTAs a cluster (the portable size)
constexpr int kClMaxLen = 1024;       // slots of a split, staged at once
constexpr int kClStageBytes = 16384;  // K and V bytes of a ring stage
constexpr int kClStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a 16-byte (or 4-byte) copy, zero-filled where !ok (nothing is read)
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
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}


// A lane's read of four consecutive elements of a row from a ring stage
// (16 bytes of f32, 4 of int8), widened to f32
template <typename T> struct Piece;
template <> struct Piece<float> {
  using Raw = uint4;
  static __device__ __forceinline__ void widen(const Raw& r, float* f) {
    Vec16<float>::widen(r, f);
  }
};
template <> struct Piece<int8_t> {
  using Raw = unsigned int;
  static __device__ __forceinline__ void widen(const Raw& r, float* f) {
    KvLoad<int8_t>::widen(r, f);
  }
};
template <typename T>
__device__ __forceinline__ typename Piece<T>::Raw lds4(const T* p) {
  return *reinterpret_cast<const typename Piece<T>::Raw*>(p);
}

// A ring stage: TK rows of K, TK rows of V (D elements each), then for an
// int8 cache the rows' K scales and V scales (TK floats each)
template <typename TKV, int D> struct ClRing {
  static constexpr int ROW = D * static_cast<int>(sizeof(TKV));
  static constexpr int TK = kClStageBytes / (2 * ROW);
  static constexpr int CHUNKS = ROW / 16;      // 16-byte copies a row
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int STAGE = kClStageBytes + (kInt8 ? 8 * TK : 0);
  static constexpr int BYTES = kClStages * STAGE;
};
// A CTA's dynamic shared memory: the ring, then where rank 0 receives
// every split's partials (acc [kClMax][GC][D], then m and l [kClMax][GC])
template <typename TKV, int D, int GC> struct ClSmem {
  static constexpr int RING = ClRing<TKV, D>::BYTES;
  static constexpr int ACC = RING;
  static constexpr int M = ACC + kClMax * GC * D * 4;
  static constexpr int L = M + kClMax * GC * 4;
  static constexpr int BYTES = L + kClMax * GC * 4;
};
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One CTA of a cluster: batch row b, kv head kvh, query heads [h0, h0 +
// ng) of it, the split at the CTA's rank (slots [rank * split_len, +
// split_len)); the cluster writes the group's out.  D is the head dim (no
// padded widths).  An int8 TKV comes with k_scale/v_scale (B,T,K) f32.
template <typename TQ, typename TKV, int D, int GC>
__global__ void __launch_bounds__(kClThreads)
decode_cluster_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos, TQ* __restrict__ out,
                      int T_, int H, int K, int G, int split_len,
                      int causal, int window, float scale) {
  using P = Piece<TKV>;
  using Raw = typename P::Raw;
  using RG = ClRing<TKV, D>;
  constexpr bool kInt8 = RG::kInt8;
  // a lane holds HL of the group's heads (q and accumulator) and FL of
  // each head's dims, in PL pieces of 4; L lanes hold a head's row, R
  // lanes a row for every head, so a warp reads KPW rows at once
  constexpr int HL = GC < 4 ? GC : 4;
  constexpr int FL = 32 / HL;
  constexpr int PL = FL / 4;
  constexpr int L = D / FL;
  constexpr int R = (GC / HL) * L;
  constexpr int KPW = 32 / R;
  constexpr int TK = RG::TK;                 // slots a ring stage
  constexpr int UT = TK / (kClWarps * KPW);
  constexpr int U = UT < 4 ? UT : 4;         // rows a lane a step
  constexpr int STEP = kClWarps * KPW * U;   // rows the CTA scores a step
  constexpr int QE = 16 / static_cast<int>(sizeof(TQ));
  constexpr int E16 = 16 / static_cast<int>(sizeof(TKV));
  static_assert(GC % HL == 0 && L * FL == D && R <= 32 && 32 % R == 0 &&
                    U >= 1 && TK % STEP == 0 && kClMaxLen % TK == 0 &&
                    D % QE == 0,
                "cluster decode layout");
  static_assert(kClWarps * GC * D * 4 <= RG::BYTES, "warp merge buffer");

  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) unsigned char q_raw[GC * D * sizeof(TQ)];
  __shared__ float red_m[kClWarps][GC], red_l[kClWarps][GC];
  __shared__ float w_s[GC][kClMax], sum_s[GC];
  __shared__ unsigned char ok_s[kClMaxLen];
  __shared__ unsigned char live_s[kClMaxLen / TK];

  TQ* q_s = reinterpret_cast<TQ*>(q_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = static_cast<int>(cluster.num_blocks());
  using SM = ClSmem<TKV, D, GC>;
  // rank 0's landing area for the splits' partials; the first phase of
  // the cluster barrier (arrived at here, waited on before the first
  // remote store) makes sure every CTA of the cluster has started
  float (*land_acc)[GC][D] = reinterpret_cast<float (*)[GC][D]>(
      cluster.map_shared_rank(ring + SM::ACC, 0));
  float (*land_m)[GC] = reinterpret_cast<float (*)[GC]>(
      cluster.map_shared_rank(ring + SM::M, 0));
  float (*land_l)[GC] = reinterpret_cast<float (*)[GC]>(
      cluster.map_shared_rank(ring + SM::L, 0));
  cluster_arrive_relaxed();
  const int kvh = blockIdx.y % K, hg = blockIdx.y / K;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kp = lane / R, hs = lane % R / L, cl = lane % L;
  const int h0 = kvh * G + hg * GC;
  const int ng = min(GC, G - hg * GC);
  const int qp = q_pos[b];
  // the cluster's split: its rank rotated by the cluster's index, so that
  // the first splits of a linear cache (the live ones of a short row) fall
  // on other ranks, and so on other SMs, from cluster to cluster
  const int split =
      (rank + 3 * static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y)) % ns;
  const int t0 = split * split_len;
  const int n = max(0, min(T_, t0 + split_len) - t0);
  const int n_tiles = (n + TK - 1) / TK;
  const long long kv_row = static_cast<long long>(b) * T_;

  // q's rows of the group (contiguous), and the split's kv_pos: one
  // latency for both
  {
    const TQ* src = q + (static_cast<long long>(b) * H + h0) * D;
    for (int i = tid; i < ng * D / QE; i += kClThreads)
      cp_async16(q_s + i * QE, src + i * QE, true);
    cp_commit();
  }
  constexpr int PER = kClMaxLen / kClThreads;
  int pos[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kClThreads;
    pos[j] = i < n ? __ldg(kv_pos + kv_row + t0 + i) : 0;
  }
  for (int i = tid; i < kClMaxLen / TK; i += kClThreads) live_s[i] = 0;
  __syncthreads();
  bool live = false;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kClThreads;
    if (i < n) {
      const int p = pos[j];
      const bool ok = (!causal || p <= qp) &&
                      (window <= 0 || static_cast<long long>(p) >
                                          static_cast<long long>(qp) - window);
      ok_s[i] = ok;
      if (ok) {
        live_s[i / TK] = 1;
        live = true;
      }
    }
  }
  cp_wait<0>();
  const bool any_live = __syncthreads_or(live);

  // the lane's heads hs*HL + hh: running max and sum, and its dims'
  // accumulator (piece j holds dims (j*L + cl)*4 + e)
  float m[HL], l[HL], acc[HL][FL];
#pragma unroll
  for (int hh = 0; hh < HL; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < FL; ++e) acc[hh][e] = 0.f;
  }

  if (any_live) {
    float qv[HL][FL];
#pragma unroll
    for (int hh = 0; hh < HL; ++hh)
#pragma unroll
      for (int j = 0; j < PL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // q scaled in its own dtype
          const int g = hs * HL + hh;
          qv[hh][4 * j + e] =
              g < ng ? scaled(q_s[g * D + (j * L + cl) * 4 + e], scale)
                     : 0.f;
        }
    // tile t's valid rows into stage t % kClStages (one commit group)
    auto issue = [&](int t) {
      if (t < n_tiles && live_s[t]) {
        unsigned char* st = ring + (t % kClStages) * RG::STAGE;
        TKV* ks = reinterpret_cast<TKV*>(st);
        TKV* vs = ks + TK * D;
        for (int idx = tid; idx < TK * RG::CHUNKS; idx += kClThreads) {
          const int r = idx / RG::CHUNKS, c = idx % RG::CHUNKS;
          const int i = t * TK + r;
          const bool ok = i < n && ok_s[i];
          const long long off =
              ((kv_row + t0 + (ok ? i : 0)) * K + kvh) * D + c * E16;
          cp_async16(ks + r * D + c * E16, k + off, ok);
          cp_async16(vs + r * D + c * E16, v + off, ok);
        }
        if (kInt8) {
          float* sc = reinterpret_cast<float*>(st + kClStageBytes);
          for (int r = tid; r < TK; r += kClThreads) {
            const int i = t * TK + r;
            const bool ok = i < n && ok_s[i];
            const long long off = (kv_row + t0 + (ok ? i : 0)) * K + kvh;
            cp_async4(sc + r, k_scale + off, ok);
            cp_async4(sc + TK + r, v_scale + off, ok);
          }
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int t = 0; t < kClStages - 1; ++t) issue(t);
    for (int t = 0; t < n_tiles; ++t) {
      issue(t + kClStages - 1);
      cp_wait<kClStages - 1>();
      __syncthreads();
      if (live_s[t]) {
        const unsigned char* st = ring + (t % kClStages) * RG::STAGE;
        const TKV* ks = reinterpret_cast<const TKV*>(st);
        const TKV* vs = ks + TK * D;
        const float* sc = reinterpret_cast<const float*>(st + kClStageBytes);
        for (int c = warp * KPW * U; c < TK; c += STEP) {
          // every read of the step's rows first: U rows of K and of V
          Raw kr[U][PL], vr[U][PL];
          bool ok[U];
          float ksc[U], vsc[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = c + u * KPW + kp;
            const int i = t * TK + r;
            ok[u] = i < n && ok_s[i];
            ksc[u] = kInt8 ? sc[r] : 1.f;
            vsc[u] = kInt8 ? sc[TK + r] : 1.f;
#pragma unroll
            for (int j = 0; j < PL; ++j) {
              const int dim = (j * L + cl) * 4;
              kr[u][j] = lds4(ks + r * D + dim);
              vr[u][j] = lds4(vs + r * D + dim);
            }
          }
          float s[U][HL];
#pragma unroll
          for (int u = 0; u < U; ++u) {        // the rows' scores
            float kf[FL];
#pragma unroll
            for (int j = 0; j < PL; ++j) P::widen(kr[u][j], kf + 4 * j);
            if (kInt8) {
#pragma unroll
              for (int e = 0; e < FL; ++e) kf[e] *= ksc[u];
            }
#pragma unroll
            for (int hh = 0; hh < HL; ++hh) {
              float d = 0.f;
#pragma unroll
              for (int e = 0; e < FL; ++e) d = fmaf(qv[hh][e], kf[e], d);
              s[u][hh] = d;
            }
          }
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1)  // sum over a head row's lanes
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int hh = 0; hh < HL; ++hh)
                s[u][hh] += __shfl_xor_sync(0xffffffffu, s[u][hh], o);
          float mn[HL];
          bool moved = false;
#pragma unroll
          for (int hh = 0; hh < HL; ++hh) {    // the step's max, warp-wide
            float cm = kNegInf;
#pragma unroll
            for (int u = 0; u < U; ++u)
              cm = fmaxf(cm, ok[u] ? s[u][hh] : kNegInf);
#pragma unroll
            for (int o = 16; o >= R; o >>= 1)
              cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
            mn[hh] = fmaxf(m[hh], cm);
            moved |= mn[hh] != m[hh];
          }
          // rescale only where some head's max moved (by 1 elsewhere)
          if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
            for (int hh = 0; hh < HL; ++hh) {
              const float corr = exp2f((m[hh] - mn[hh]) * kLog2e);
              l[hh] *= corr;
#pragma unroll
              for (int e = 0; e < FL; ++e) acc[hh][e] *= corr;
              m[hh] = mn[hh];
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float vf[FL];
#pragma unroll
            for (int j = 0; j < PL; ++j) P::widen(vr[u][j], vf + 4 * j);
            if (kInt8) {
#pragma unroll
              for (int e = 0; e < FL; ++e) vf[e] *= vsc[u];
            }
#pragma unroll
            for (int hh = 0; hh < HL; ++hh) {
              const float p =
                  ok[u] ? exp2f(fmaf(s[u][hh], kLog2e, -m[hh] * kLog2e))
                        : 0.f;
              l[hh] += p;
#pragma unroll
              for (int e = 0; e < FL; ++e)
                acc[hh][e] = fmaf(p, vf[e], acc[hh][e]);
            }
          }
        }
      }
      __syncthreads();                        // before the stage refills
    }
  }

  // the split's state: the warps' merged (the ring is free: every copy
  // has landed and been read) and stored into rank 0's shared memory
  cluster_wait();
  if (!any_live) {
    if (tid < GC) {
      land_m[split][tid] = kNegInf;
      land_l[split][tid] = 0.f;
    }
  } else {
    float (*red_acc)[GC][D] = reinterpret_cast<float (*)[GC][D]>(ring);
    // a warp's state: summed over the KPW rows of its reads (m is
    // warp-wide)
#pragma unroll
    for (int hh = 0; hh < HL; ++hh)
#pragma unroll
      for (int o = 16; o >= R; o >>= 1) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], o);
#pragma unroll
        for (int e = 0; e < FL; ++e)
          acc[hh][e] += __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
      }
    if (kp == 0) {
#pragma unroll
      for (int hh = 0; hh < HL; ++hh) {
        const int g = hs * HL + hh;
        if (cl == 0) {
          red_m[warp][g] = m[hh];
          red_l[warp][g] = l[hh];
        }
#pragma unroll
        for (int j = 0; j < PL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red_acc[warp][g][(j * L + cl) * 4 + e] = acc[hh][4 * j + e];
      }
    }
    __syncthreads();
    if (tid < ng) {                 // a head's weights of the warps' states
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kClWarps; ++w) mx = fmaxf(mx, red_m[w][tid]);
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < kClWarps; ++w) {
        const float cw = exp2f((red_m[w][tid] - mx) * kLog2e);
        red_m[w][tid] = cw;
        ls = fmaf(red_l[w][tid], cw, ls);
      }
      land_m[split][tid] = mx;
      land_l[split][tid] = ls;
    }
    __syncthreads();
    for (int idx = tid; idx < ng * D; idx += kClThreads) {
      const int g = idx / D, c = idx % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kClWarps; ++w)
        a = fmaf(red_acc[w][g][c], red_m[w][g], a);
      land_acc[split][g][c] = a;
    }
  }
  // the second phase: every split's partials are in rank 0, which alone
  // goes on
  cluster_arrive_release();
  cluster_wait();
  if (rank != 0) return;
  land_acc = reinterpret_cast<float (*)[GC][D]>(ring + SM::ACC);
  land_m = reinterpret_cast<float (*)[GC]>(ring + SM::M);
  land_l = reinterpret_cast<float (*)[GC]>(ring + SM::L);

  // the combine, in split order: a thread a head weighs the splits, then
  // each thread writes columns of the group's output
  for (int g = tid; g < ng; g += kClThreads) {
    float mx = kNegInf;
    for (int j = 0; j < ns; ++j) mx = fmaxf(mx, land_m[j][g]);
    float ls = 0.f;
    for (int j = 0; j < ns; ++j) {
      const float lj = land_l[j][g];
      const float w = lj > 0.f ? exp2f((land_m[j][g] - mx) * kLog2e) : 0.f;
      w_s[g][j] = w;
      ls = fmaf(lj, w, ls);
    }
    sum_s[g] = ls;
  }
  __syncthreads();
  for (int idx = tid; idx < ng * D; idx += kClThreads) {
    const int g = idx / D, c = idx % D;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kClMax; ++j) {        // in split order
      const float w = j < ns ? w_s[g][j] : 0.f;
      a = w != 0.f ? fmaf(land_acc[j][g][c], w, a) : a;  // a dead split
    }                                                    // stored no acc
    out[(static_cast<long long>(b) * H + h0 + g) * D + c] =
        from_f<TQ>(a / fmaxf(sum_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, int GC>
int launch_cluster(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int T_, int H, int K, int causal, int window, float scale,
                   int NS, int split_len, cudaStream_t stream) {
  const int G = H / K;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NS, K * ((G + GC - 1) / GC), B);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = ClSmem<TKV, D, GC>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_cluster_kernel<TQ, TKV, D, GC>, static_cast<const TQ*>(q),
      static_cast<const TKV*>(k), static_cast<const TKV*>(v), k_scale,
      v_scale, q_pos, kv_pos, static_cast<TQ*>(out), T_, H, K, G, split_len,
      causal, window, scale);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// the cluster form's instantiations: (TQ, TKV, D, head group), the
// shapes the serving paths decode at
#define CLUSTER_INSTANCES(X)                                                \
  X(float, float, 64, 8) X(float, int8_t, 64, 8)                            \
  X(__nv_bfloat16, float, 128, 8) X(__nv_bfloat16, float, 128, 4)           \
  X(float, int8_t, 128, 4)

template <typename T> constexpr int dtype_code() {
  return std::is_same<T, float>::value           ? 0
         : std::is_same<T, __nv_bfloat16>::value ? 1
                                                 : 2;
}

}  // namespace


extern "C" {

// S = 1.  D is the head dim of q, k, v and out (a multiple of 8 from 8 to
// 512) and `width` the tile width of the instantiation: D where D is one of
// 16, 32, 64, 96, 128, 256, 512, else the smallest of the padded widths
// 64, 96, 128, 256, 512 above D; D = width runs the unpadded
// instantiation where there is one (not at 96), any other D the padded
// one.  part:
// B*H*n_split*(width + 2) floats of scratch; counters:
// B*K*ceil(G/head_group) int32, zero before the launch and zero after it;
// head_group GC is 2, 4 or 8, with GC times the floats a lane holds of a
// head (F = 4 to 24: decode_plan) at most 32, or 2 where F is larger;
// n_split <= 512 and n_split*split_len >= T, as decode_plan chooses them.
// K and V start on 16-byte boundaries.  dtype_q: 0 = float32, 1 =
// bfloat16; dtype_kv: those, or 2 = int8, which takes k_scale and v_scale
// ((B,T,K) f32; null for a float cache) and is instantiated for the (q
// dtype, D, head group) triples the int8 decode paths launch only.
// Returns a cudaError_t (0 = launched); -1 for a shape this kernel does not
// take.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const float* k_scale, const float* v_scale,
                        const int* q_pos, const int* kv_pos, void* out,
                        float* part, int* counters, int B, int T_, int H,
                        int K, int D, int width,
                        int causal, int window, float scale, int dtype_q,
                        int dtype_kv, int head_group, int n_split,
                        int split_len, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || n_split < 1 || n_split > kMaxSplits ||
      split_len < 1 || D < 8 || D % 8 != 0 ||
      static_cast<long long>(n_split) * split_len < T_)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE(TQ, TKV, DD, GG, P)                                          \
  if (width == DD && head_group == GG)                                      \
    return launch_decode<TQ, TKV, DD, GG, P>(q, k, v, k_scale, v_scale,   \
                                             q_pos, kv_pos, out, part,      \
                                             counters, B, T_, H, K, D,      \
                                             causal, window, scale,         \
                                             n_split, split_len, s);
  // an f32 cache: 4 floats a lane a head up to D = 128 (12 at 96), 8 at
  // 256, 16 at 512; a bf16 cache: 8 (24 at 96), 16 at 512
#define DECODE_F32_AT(TQ, P)                                                \
  DECODE(TQ, float, 64, 2, P) DECODE(TQ, float, 64, 4, P)                   \
  DECODE(TQ, float, 64, 8, P) DECODE(TQ, float, 128, 2, P)                  \
  DECODE(TQ, float, 128, 4, P) DECODE(TQ, float, 128, 8, P)                 \
  DECODE(TQ, float, 256, 2, P) DECODE(TQ, float, 256, 4, P)                 \
  DECODE(TQ, float, 512, 2, P)
#define DECODE_F32(TQ)                                                      \
  DECODE(TQ, float, 16, 2, false) DECODE(TQ, float, 16, 4, false)           \
  DECODE(TQ, float, 16, 8, false) DECODE(TQ, float, 32, 2, false)           \
  DECODE(TQ, float, 32, 4, false) DECODE(TQ, float, 32, 8, false)           \
  DECODE_F32_AT(TQ, false)
#define DECODE_F32_PAD(TQ)                                                  \
  DECODE_F32_AT(TQ, true) DECODE(TQ, float, 96, 2, true)
#define DECODE_BF16_AT(TQ, P)                                               \
  DECODE(TQ, __nv_bfloat16, 64, 2, P) DECODE(TQ, __nv_bfloat16, 64, 4, P)   \
  DECODE(TQ, __nv_bfloat16, 128, 2, P)                                      \
  DECODE(TQ, __nv_bfloat16, 128, 4, P) DECODE(TQ, __nv_bfloat16, 256, 2, P) \
  DECODE(TQ, __nv_bfloat16, 256, 4, P) DECODE(TQ, __nv_bfloat16, 512, 2, P)
#define DECODE_BF16(TQ)                                                     \
  DECODE(TQ, __nv_bfloat16, 16, 2, false)                                   \
  DECODE(TQ, __nv_bfloat16, 16, 4, false)                                   \
  DECODE(TQ, __nv_bfloat16, 32, 2, false)                                   \
  DECODE(TQ, __nv_bfloat16, 32, 4, false)                                   \
  DECODE_BF16_AT(TQ, false)
#define DECODE_BF16_PAD(TQ)                                                 \
  DECODE_BF16_AT(TQ, true) DECODE(TQ, __nv_bfloat16, 96, 2, true)
  // an int8 cache (4 values a lane, laid out as f32): tinyllama (D 64,
  // group 8), gemma3's ring and global layers (D 128, group 2) and jamba's
  // attention layers (D 128, group 4), f32 q
  if (dtype_kv == 2 && (k_scale == nullptr || v_scale == nullptr ||
                        D != width)) return -1;
  // an unpadded instantiation returns where one matches; the padded ones
  // take the rest
  const bool whole = D == width;
  if (dtype_kv == 0) {
    if (dtype_q == 0) {
      if (whole) { DECODE_F32(float) }
      DECODE_F32_PAD(float)
    } else {
      if (whole) { DECODE_F32(__nv_bfloat16) }
      DECODE_F32_PAD(__nv_bfloat16)
    }
  } else if (dtype_kv == 1) {
    if (dtype_q == 0) {
      if (whole) { DECODE_BF16(float) }
      DECODE_BF16_PAD(float)
    } else {
      if (whole) { DECODE_BF16(__nv_bfloat16) }
      DECODE_BF16_PAD(__nv_bfloat16)
    }
  } else if (dtype_kv == 2 && dtype_q == 0) {
    DECODE(float, int8_t, 64, 8, false) DECODE(float, int8_t, 128, 2, false)
    DECODE(float, int8_t, 128, 4, false)
  }
#undef DECODE_BF16_PAD
#undef DECODE_BF16
#undef DECODE_BF16_AT
#undef DECODE_F32_PAD
#undef DECODE_F32
#undef DECODE_F32_AT
#undef DECODE
  return -1;
}

// The cluster form's shared-memory opt-in (its ring is dynamic shared
// memory past 48 KB), once a device before its first launch.  Returns a
// cudaError_t.
int flash_decode_prepare() {
#define OPT_IN(TQ, TKV, DD, GG)                                             \
  if (cudaError_t e = cudaFuncSetAttribute(                                 \
          decode_cluster_kernel<TQ, TKV, DD, GG>,                           \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          ClSmem<TKV, DD, GG>::BYTES))                                      \
    return static_cast<int>(e);
  CLUSTER_INSTANCES(OPT_IN)
#undef OPT_IN
  return 0;
}

// The shared memory a CTA of the cluster form's instantiation (dtype_q,
// dtype_kv, D, head_group) takes, static and dynamic, in bytes; -1 for a
// shape the form does not take, else -(a cudaError_t).
int flash_decode_cluster_smem(int dtype_q, int dtype_kv, int D,
                              int head_group) {
#define SMEM(TQ, TKV, DD, GG)                                               \
  if (dtype_q == dtype_code<TQ>() && dtype_kv == dtype_code<TKV>() &&      \
      D == DD && head_group == GG) {                                        \
    cudaFuncAttributes a;                                                   \
    if (cudaError_t e = cudaFuncGetAttributes(                              \
            &a, decode_cluster_kernel<TQ, TKV, DD, GG>))                    \
      return -static_cast<int>(e);                                          \
    return static_cast<int>(a.sharedSizeBytes) +                           \
           ClSmem<TKV, DD, GG>::BYTES;                                      \
  }
  CLUSTER_INSTANCES(SMEM)
#undef SMEM
  return -1;
}

// S = 1 in the cluster form, laid out by decode_layout: D the head dim
// (64 or 128, unpadded), head_group GC, n_split CTAs a cluster (1 to
// 8, each split nonempty) of split_len slots (at most 1024).  dtype_q /
// dtype_kv as flash_decode_launch's; an int8 cache takes k_scale and
// v_scale.  q, K and V start on 16-byte boundaries.  No workspace.
// Returns a cudaError_t (0 = launched); -1 for a shape the form does not
// take.
int flash_decode_cluster_launch(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                const int* q_pos, const int* kv_pos,
                                void* out, int B, int T_, int H, int K,
                                int D, int causal, int window, float scale,
                                int dtype_q, int dtype_kv, int head_group,
                                int n_split, int split_len, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || n_split < 1 || n_split > kClMax ||
      split_len < 1 || split_len > kClMaxLen ||
      static_cast<long long>(n_split) * split_len < T_ ||
      static_cast<long long>(n_split - 1) * split_len >= T_)
    return -1;
  if (dtype_kv == 2 && (k_scale == nullptr || v_scale == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TQ, TKV, DD, GG)                                             \
  if (dtype_q == dtype_code<TQ>() && dtype_kv == dtype_code<TKV>() &&      \
      D == DD && head_group == GG)                                          \
    return launch_cluster<TQ, TKV, DD, GG>(q, k, v, k_scale, v_scale,      \
                                           q_pos, kv_pos, out, B, T_, H,   \
                                           K, causal, window, scale,        \
                                           n_split, split_len, s);
  CLUSTER_INSTANCES(LAUNCH)
#undef LAUNCH
  return -1;
}

}  // extern "C"

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
// of its kv head (GC*F floats of q and of accumulator a lane, F = 4 or 8).
// Its four warps split the keys of the range; within a warp, D/VEC lanes
// (at most 32) hold one key row in 16-byte vectors (one row a warp
// instruction at D = 128 f32, several at smaller D, and at D = 256 one row
// a warp in two chunks a lane in f32, one in bf16), and each lane keeps its
// slice of the GC query vectors and accumulators in registers.  A warp
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
// Later work: cp.async double buffering of the K/V rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// ---- split-KV decode ----------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kSeg = 256;      // slots whose validity a CTA stages at once
constexpr int kMaxSplits = 512;  // splits a combine weighs at once

// One CTA: batch row b, kv head kvh, query heads [h0, h0 + ng) of it (a head
// group of at most GC), slots [split * split_len, +split_len) of the cache.
// Writes that range's f32 (max, sum, accumulator) for each of its heads to
// part: m at [row], l at [BH*NS + row], acc at [2*BH*NS + row*D], with row =
// (b*H + h)*NS + split.  q and out are TQ, K and V TKV.
template <typename TQ, typename TKV, int D, int GC>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, TQ* __restrict__ out,
                    float* part, int* counters, int T_, int H, int K, int G,
                    int NS, int split_len, int causal, int window,
                    float scale) {
  constexpr int VEC = Vec16<TKV>::N;
  constexpr int LPK = D / VEC < 32 ? D / VEC : 32;  // lanes holding a key row
  constexpr int CH = D / (VEC * LPK);        // 16-byte chunks a lane of a row
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
        if (g < ng)    // the reference scales q in its own dtype, then widens
          x = scaled(q[(static_cast<long long>(b) * H + h0 + g) * D +
                       (ch * LPK + dl) * VEC + e], scale);
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
      uint4 kr[U][CH], vr[U][CH];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {          // every load before any use
        const int i = c + u * KPW + sub;
        ok[u] = i < n && ok_s[i];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          kr[u][ch] = vr[u][ch] = make_uint4(0u, 0u, 0u, 0u);
          if (ok[u]) {
            const long long off = ((kv_row + s0 + i) * K + kvh) * D +
                                  (ch * LPK + dl) * VEC;
            kr[u][ch] = __ldg(reinterpret_cast<const uint4*>(k + off));
            vr[u][ch] = __ldg(reinterpret_cast<const uint4*>(v + off));
          }
        }
      }
      float s[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[F];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
          Vec16<TKV>::widen(kr[u][ch], kf + ch * VEC);
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
          Vec16<TKV>::widen(vr[u][ch], vf + ch * VEC);
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
      const int g = idx / D, d = idx % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float c = expf(red_m[w][g] - mx);
        a = fmaf(red_acc[w][g][d], c, a);
        ls = fmaf(red_l[w][g], c, ls);
      }
      const long long row = row0 + static_cast<long long>(g) * NS;
      part[2 * BH * NS + row * D + d] = a;
      if (d == 0) {
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
    const int g = idx / D, d = idx % D;
    const long long r = static_cast<long long>(b) * H + h0 + g;
    const float* pa = part + 2 * BH * NS + r * NS * D + d;
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < NS; ++i) {   // in split order
      const float x = __ldcg(pa + static_cast<long long>(i) * D);
      const float w = w_s[g][i];
      a = w != 0.f ? fmaf(x, w, a) : a;  // an empty split wrote no x
    }
    out[r * D + d] = from_f<TQ>(a / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, int GC>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* kv_pos, void* out, float* part,
                  int* counters, int B, int T_, int H, int K, int causal,
                  int window, float scale, int NS, int split_len,
                  cudaStream_t stream) {
  const int G = H / K;
  dim3 grid(NS, K * ((G + GC - 1) / GC), B);
  decode_split_kernel<TQ, TKV, D, GC><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), q_pos, kv_pos, static_cast<TQ*>(out), part,
      counters, T_, H, K, G, NS, split_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


extern "C" {

// S = 1.  part: B*H*n_split*(D + 2) floats of scratch; counters:
// B*K*ceil(G/head_group) int32, zero before the launch and zero after it;
// head_group GC is 2, 4 or 8, with GC times the floats a lane holds of a
// head (4 for an f32 cache up to head dim 128, else 8) at most 32;
// n_split <= 512 and n_split*split_len >= T, as decode_plan chooses them.
// K and V start on 16-byte boundaries.  dtype_q, dtype_kv: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = launched); -1 for a shape this
// kernel does not take.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out,
                        float* part, int* counters, int B, int T_, int H,
                        int K, int D,
                        int causal, int window, float scale, int dtype_q,
                        int dtype_kv, int head_group, int n_split,
                        int split_len, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || n_split < 1 || n_split > kMaxSplits ||
      split_len < 1 ||
      static_cast<long long>(n_split) * split_len < T_)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE(TQ, TKV, DD, GG)                                             \
  if (D == DD && head_group == GG)                                          \
    return launch_decode<TQ, TKV, DD, GG>(q, k, v, q_pos, kv_pos, out,      \
                                          part, counters, B, T_, H, K,      \
                                          causal, window, scale, n_split,   \
                                          split_len, s);
  // an f32 cache: 4 floats a lane a head up to D = 128, 8 at 256; a bf16
  // cache: 8
#define DECODE_F32(TQ)                                                      \
  DECODE(TQ, float, 16, 2) DECODE(TQ, float, 16, 4) DECODE(TQ, float, 16, 8)\
  DECODE(TQ, float, 32, 2) DECODE(TQ, float, 32, 4) DECODE(TQ, float, 32, 8)\
  DECODE(TQ, float, 64, 2) DECODE(TQ, float, 64, 4) DECODE(TQ, float, 64, 8)\
  DECODE(TQ, float, 128, 2) DECODE(TQ, float, 128, 4)                       \
  DECODE(TQ, float, 128, 8)                                                 \
  DECODE(TQ, float, 256, 2) DECODE(TQ, float, 256, 4)
#define DECODE_BF16(TQ)                                                     \
  DECODE(TQ, __nv_bfloat16, 16, 2) DECODE(TQ, __nv_bfloat16, 16, 4)         \
  DECODE(TQ, __nv_bfloat16, 32, 2) DECODE(TQ, __nv_bfloat16, 32, 4)         \
  DECODE(TQ, __nv_bfloat16, 64, 2) DECODE(TQ, __nv_bfloat16, 64, 4)         \
  DECODE(TQ, __nv_bfloat16, 128, 2) DECODE(TQ, __nv_bfloat16, 128, 4)       \
  DECODE(TQ, __nv_bfloat16, 256, 2) DECODE(TQ, __nv_bfloat16, 256, 4)
  if (dtype_kv == 0) {
    if (dtype_q == 0) { DECODE_F32(float) }
    else { DECODE_F32(__nv_bfloat16) }
  } else {
    if (dtype_q == 0) { DECODE_BF16(float) }
    else { DECODE_BF16(__nv_bfloat16) }
  }
#undef DECODE_BF16
#undef DECODE_F32
#undef DECODE
  return -1;
}

}  // extern "C"

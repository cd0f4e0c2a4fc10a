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
// in the wrapper, Dv != Dk (MLA) and head_dim outside 16/32/64/128
// (gemma-7b's 256); ROADMAP Queue 2 lists them under K3.
//
// Two kernels share that contract.  The wrapper launches the split-KV
// decode kernel when S = 1 (copying K/V that do not start on a 16-byte
// boundary), the tiled kernel otherwise (prefill).
//
// Bound on the H100: at the serving shapes, bytes.  Decode (S = 1) reads
// each valid K/V row once for 2*G*D FMAs per key and head group: 8 FLOP per
// 4-byte element at G = 8 (tinyllama; 2 at gemma3's G = 2), far below the
// 67 TFLOP/s f32 / 3.35 TB/s = 20 FLOP/byte ridge: gemma3's ring decode
// (4 rows, 16 kv heads, D 128, 1024 slots, f32) reads 48 MB, 14.4 us.  Long
// prefills cross the ridge and become bound by f32 FMA throughput, since
// these kernels keep IEEE f32 arithmetic (no TF32: the reference's bar is
// 3e-5).
//
// Decode design (split-KV, "flash-decoding"): the grid is (split, kv head x
// head group, batch row).  A split is a contiguous range of cache slots;
// kernels/flash_attention.py::decode_plan picks the number of splits from
// B*K, T and the SM count so that the grid holds about four CTAs per SM.  A
// CTA computes only the query heads that exist: a group of GC of the G heads
// of its kv head (GC*16 bytes of q and of accumulator a lane).  Its four
// warps split the keys of the range; within a warp, D/VEC lanes hold one key
// row in 16-byte vectors (one row a warp instruction at D = 128 f32,
// several at smaller D), and each lane keeps its slice of the GC query
// vectors and accumulators in registers.  A warp loads U key rows of K and
// V before it uses any, scores them with a shuffle reduction over the lanes
// of a row, and folds them into its running max, sum and accumulator once
// per chunk.  The CTA stages the validity of up to kSeg slots at a time in
// shared memory, from each slot's kv_pos, never from the slot index (a ring
// cache holds token t in slot t % W, so positions do not grow with the
// slot); a stage with no valid key is skipped, and a split with none loads
// no K/V and writes m = -1e30, l = 0.  The warps' states are merged in
// shared memory into the split's partials.  The last CTA of each (batch
// row, head group) to finish, found by an integer ticket taken after its
// partials are fenced, combines that group's splits in a fixed order: m =
// max m_i, l = sum l_i exp(m_i - m), the same for the accumulator (in
// split order), out = acc / max(l, 1e-30).  So decode is one launch; the
// partials and the tickets are the wrapper's workspace, and the last CTA
// leaves its ticket at 0 for the next launch.  No float atomics: whichever
// CTA combines, it adds in the same order, and the result is the same
// from run to run.
//
// Prefill design (FA2-style, CUDA cores): one CTA per (batch, kv head, block
// of query positions) holds all G query heads of that kv head, so the GQA
// routing is index math and each K/V tile is read once per group.  The CTA
// owns kRows = 64 (query, head) rows and loops over KV tiles of kBK = 32 keys
// staged in shared memory; each warp owns 16 rows and keeps their running
// max and sum in registers, one lane per key of the tile.  A tile is skipped
// only when every key in it is masked for every row of the CTA: no key has
// kv_pos <= qmax, the largest q_pos of the CTA's rows, or (window W > 0) no
// key has kv_pos > qmin - W, with qmin the smallest.  The masks come from the
// staged kv_pos of each key, as in decode.  Window comparisons run in 64 bits
// (q_pos - W may not fit in int).  A row with no valid key still gives 0.
// expf is the accurate one (no fast math).
//
// Later work: wgmma for bf16 prefill, TMA loads of the tiles, cp.async
// double buffering of the decode kernel's K/V rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kBK = 32;        // keys per tile (one per lane)
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, T* __restrict__ out, int S, int T_,
            int H, int K, int G, int BQ, int causal, int window, float scale) {
  constexpr int QS = D + 1;                 // padded row strides
  constexpr int PS = kBK + 1;
  constexpr int DG = D / 8;                 // 8 dims per thread in PV
  constexpr int RG = kThreads / DG;         // row groups in PV
  constexpr int RPT = kRows / RG;           // rows per thread in PV

  extern __shared__ float smem[];
  float* Qs = smem;                         // [kRows][QS], pre-scaled
  float* Ks = Qs + kRows * QS;              // [kBK][QS]
  float* Vs = Ks + kBK * QS;                // [kBK][D]
  float* Ps = Vs + kBK * D;                 // [kRows][PS] scores, then p
  float* corr_s = Ps + kRows * PS;          // [kRows]
  float* l_s = corr_s + kRows;              // [kRows]
  int* qpos_s = reinterpret_cast<int*>(l_s + kRows);   // [kRows]
  int* kvpos_s = qpos_s + kRows;                      // [kBK]
  __shared__ int qmax, qmin;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int qb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = BQ * G;                  // rows this CTA uses (<= kRows)

  if (tid == 0) { qmax = INT_MIN; qmin = INT_MAX; }
  __syncthreads();
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = qb * BQ + r / G;
    float val = 0.f;
    if (r < rows && s < S) {
      const int h = kvh * G + r % G;
      // The reference scales q in its own dtype before the f32 cast.
      val = to_f(from_f<T>(to_f(q[((static_cast<long long>(b) * S + s) * H + h) * D + d]) * scale));
    }
    Qs[r * QS + d] = val;
  }
  if (tid < kRows) {
    const int s = qb * BQ + tid / G;
    const bool ok = tid < rows && s < S;
    const int p = ok ? q_pos[static_cast<long long>(b) * S + s] : INT_MIN;
    qpos_s[tid] = p;
    if (ok) { atomicMax(&qmax, p); atomicMin(&qmin, p); }
  }
  __syncthreads();

  float m_r[16], l_r[16];                   // warp `warp` owns rows warp*16+i
#pragma unroll
  for (int i = 0; i < 16; ++i) { m_r[i] = kNegInf; l_r[i] = 0.f; }
  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int arg = tid / DG, adg = tid % DG;   // PV ownership
  const int srg = tid / 8, scg = tid % 8;     // QK^T ownership: 4 rows x 4 keys
  const int n_tiles = (T_ + kBK - 1) / kBK;
  const long long kv_base = static_cast<long long>(b) * T_;

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kBK;
    bool live = false;
    if (tid < kBK) {
      const int col = t0 + tid;
      const int p = col < T_ ? kv_pos[kv_base + col] : INT_MAX;
      kvpos_s[tid] = p;
      live = col < T_ && (!causal || p <= qmax) &&
             (window <= 0 ||
              static_cast<long long>(p) >
                  static_cast<long long>(qmin) - window);
    }
    if (!__syncthreads_or(live)) continue;  // every key masked for every row

    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int col = t0 + c;
      float kk = 0.f, vv = 0.f;
      if (col < T_) {
        const long long off = ((kv_base + col) * K + kvh) * D + d;
        kk = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[c * QS + d] = kk;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    // scores: rows srg*4..+3, keys scg*4..+3
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(srg * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(scg * 4 + j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(srg * 4 + i) * PS + scg * 4 + j] = sc[i][j];
    __syncthreads();

    // online softmax: warp owns 16 rows, lane = key of the tile
    {
      const int col = t0 + lane;
      const int kp = kvpos_s[lane];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = warp * 16 + i;
        const int qp = qpos_s[r];
        const bool valid = col < T_ && r < rows && qp != INT_MIN &&
                           (!causal || kp <= qp) &&
                           (window <= 0 ||
                            static_cast<long long>(kp) >
                                static_cast<long long>(qp) - window);
        const float s = valid ? Ps[r * PS + lane] : kNegInf;
        const float m_new = fmaxf(m_r[i], warp_max(s));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float c = expf(m_r[i] - m_new);
        l_r[i] = l_r[i] * c + warp_sum(p);
        m_r[i] = m_new;
        Ps[r * PS + lane] = p;
        if (lane == 0) corr_s[r] = c;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows arg*RPT..+RPT-1, dims adg*8..+7
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = corr_s[arg * RPT + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= c;
    }
    for (int c = 0; c < kBK; ++c) {
      float vv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = Vs[c * D + adg * 8 + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(arg * RPT + i) * PS + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) l_s[warp * 16 + i] = l_r[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = arg * RPT + i;
    const int s = qb * BQ + r / G;
    if (r >= rows || s >= S) continue;
    const int h = kvh * G + r % G;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * S + s) * H + h) * D + adg * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = from_f<T>(acc[i][j] * inv);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * (D + 1) + kBK * (D + 1) + kBK * D +
                          kRows * (kBK + 1) + 2 * kRows) +
         sizeof(int) * (kRows + kBK);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, int B, int S, int T_, int H, int K,
           int causal, int window, float scale, cudaStream_t stream) {
  const int G = H / K;
  const int BQ = kRows / G;
  const size_t smem = smem_bytes<D>();
  dim3 grid((S + BQ - 1) / BQ, K, B);
  attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), S, T_, H,
      K, G, BQ, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---- split-KV decode ----------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kSeg = 256;      // slots whose validity a CTA stages at once
constexpr int kMaxSplits = 512;  // splits a combine weighs at once

// 16 bytes of T: VEC elements, loaded raw and widened to f32 when used
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // bf16 -> f32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// One CTA: batch row b, kv head kvh, query heads [h0, h0 + ng) of it (a head
// group of at most GC), slots [split * split_len, +split_len) of the cache.
// Writes that range's f32 (max, sum, accumulator) for each of its heads to
// part: m at [row], l at [BH*NS + row], acc at [2*BH*NS + row*D], with row =
// (b*H + h)*NS + split.
template <typename T, int D, int GC>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ out,
                    float* part, int* counters, int T_, int H, int K, int G,
                    int NS, int split_len, int causal, int window,
                    float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LPK = D / VEC;               // lanes holding one key row
  constexpr int KPW = 32 / LPK;              // key rows a warp loads at once
  constexpr int U = GC >= 8 ? 2 : 4;         // loads in flight per lane
  constexpr int KPC = KPW * U;               // keys of a warp's chunk
  static_assert(LPK >= 1 && LPK <= 32 && (32 % LPK) == 0, "head dim");

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

  float qv[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float x = 0.f;
      if (g < ng) {
        // the reference scales q in its own dtype before the f32 cast
        const T raw = q[(static_cast<long long>(b) * H + h0 + g) * D +
                        dl * VEC + e];
        x = to_f(from_f<T>(to_f(raw) * scale));
      }
      qv[g][e] = x;
    }
  float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
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
      uint4 kr[U], vr[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {          // every load before any use
        const int i = c + u * KPW + sub;
        ok[u] = i < n && ok_s[i];
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u]) {
          const long long off = ((kv_row + s0 + i) * K + kvh) * D + dl * VEC;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
        }
      }
      float s[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        Vec16<T>::widen(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[g][e], kf[e], d);
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
        for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[VEC];
        Vec16<T>::widen(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = ok[u] ? expf(s[u][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
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
        for (int e = 0; e < VEC; ++e)
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
        for (int e = 0; e < VEC; ++e)
          red_acc[warp][g][dl * VEC + e] = acc[g][e];
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
    out[r * D + d] = from_f<T>(a / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int D, int GC>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* kv_pos, void* out, float* part,
                  int* counters, int B, int T_, int H, int K, int causal,
                  int window, float scale, int NS, int split_len,
                  cudaStream_t stream) {
  const int G = H / K;
  dim3 grid(NS, K * ((G + GC - 1) / GC), B);
  decode_split_kernel<T, D, GC><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), part,
      counters, T_, H, K, G, NS, split_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tiled kernel's shared-memory opt-in on the current device; the
// wrapper calls it once a device, before that device's first launch.
// Returns a cudaError_t.
int flash_attention_prepare() {
#define OPT_IN(TT, DD)                                                      \
  if (cudaError_t e = cudaFuncSetAttribute(                                 \
          attn_kernel<TT, DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          static_cast<int>(smem_bytes<DD>())))                              \
    return static_cast<int>(e);
  OPT_IN(float, 16) OPT_IN(float, 32) OPT_IN(float, 64) OPT_IN(float, 128)
  OPT_IN(__nv_bfloat16, 16) OPT_IN(__nv_bfloat16, 32)
  OPT_IN(__nv_bfloat16, 64) OPT_IN(__nv_bfloat16, 128)
#undef OPT_IN
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched);
// -1 for a head_dim or group size this kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* out,
                           int B, int S, int T_, int H, int K, int D,
                           int causal, int window, float scale, int dtype,
                           void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kRows) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DISPATCH(DD)                                                        \
  if (D == DD) {                                                            \
    return dtype == 0                                                       \
               ? launch<float, DD>(q, k, v, q_pos, kv_pos, out, B, S, T_, H, \
                                   K, causal, window, scale, s)             \
               : launch<__nv_bfloat16, DD>(q, k, v, q_pos, kv_pos, out, B, S, \
                                           T_, H, K, causal, window, scale, \
                                           s);                              \
  }
  DISPATCH(16)
  DISPATCH(32)
  DISPATCH(64)
  DISPATCH(128)
#undef DISPATCH
  return -1;
}

// S = 1.  part: B*H*n_split*(D + 2) floats of scratch; counters:
// B*K*ceil(G/head_group) int32, zero before the launch and zero after it;
// head_group GC is 2, 4 or 8 (at most 4 in bf16), n_split <= 512 and
// n_split*split_len >= T, as decode_plan chooses them.  K and V start on 16-byte boundaries.
// Returns a cudaError_t (0 = launched); -1 for a shape this kernel does
// not take.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out,
                        float* part, int* counters, int B, int T_, int H,
                        int K, int D,
                        int causal, int window, float scale, int dtype,
                        int head_group, int n_split, int split_len,
                        void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || n_split < 1 || n_split > kMaxSplits ||
      split_len < 1 ||
      static_cast<long long>(n_split) * split_len < T_)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE(TT, DD, GG)                                                  \
  if (D == DD && head_group == GG)                                          \
    return launch_decode<TT, DD, GG>(q, k, v, q_pos, kv_pos, out, part,     \
                                     counters, B, T_, H, K, causal, window, \
                                     scale, n_split, split_len, s);
#define DECODE_D(DD)                                                        \
  if (dtype == 0) {                                                         \
    DECODE(float, DD, 2) DECODE(float, DD, 4) DECODE(float, DD, 8)          \
  } else {                                                                  \
    DECODE(__nv_bfloat16, DD, 2) DECODE(__nv_bfloat16, DD, 4)               \
  }
  DECODE_D(16)
  DECODE_D(32)
  DECODE_D(64)
  DECODE_D(128)
#undef DECODE_D
#undef DECODE
  return -1;
}

}  // extern "C"

// Blockwise online-softmax attention forward with GQA and position masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _kernel) in the contract of src/repro/models/attention.py::
// chunked_attention, which is what the serving model runs: q (B,S,H,D),
// k/v (B,T,K,D) with H = K*G, per-row positions q_pos (B,S) and
// kv_pos (B,T) (empty cache slots carry 2**30), key t valid for query s iff
// kv_pos[t] <= q_pos[s] when causal.  Running max, sum and accumulator are
// f32; a masked score is -1e30 and the sum is floored at 1e-30, so a row
// with no valid key gives 0.  Sliding windows, int8 scales and Dv != Dk are
// later slices' work (the wrapper raises on them).
//
// Bound on the H100: at the serving shapes, bytes.  Decode (S = 1) reads
// each valid K/V row once for 2*G*D FMAs per key and head group: 8 FLOP per
// 4-byte element at G = 8, far below the 67 TFLOP/s f32 / 3.35 TB/s = 20
// FLOP/byte ridge.  Long prefill buckets cross the ridge and become bound by
// f32 FMA throughput, since this kernel keeps IEEE f32 arithmetic (no TF32:
// the reference's bar is 3e-5).
//
// Design (FA2-style, CUDA cores): one CTA per (batch, kv head, block of
// query positions) holds all G query heads of that kv head, so the GQA
// routing is index math and each K/V tile is read once per group.  The CTA
// owns kRows = 64 (query, head) rows and loops over KV tiles of kBK = 32 keys
// staged in shared memory; each warp owns 16 rows and keeps their running
// max and sum in registers, one lane per key of the tile.  A tile is skipped
// only when every key in it is masked for every row of the CTA (no key has
// kv_pos <= the largest q_pos of the CTA), so a row with no valid key still
// gives 0.  expf is the accurate one (no fast math).
//
// Later work: split-KV for decode (B*K CTAs under-fill 132 SMs), wgmma for
// bf16, TMA loads of the tiles.
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
            int H, int K, int G, int BQ, int causal, float scale) {
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
  __shared__ int qmax;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int qb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = BQ * G;                  // rows this CTA uses (<= kRows)

  if (tid == 0) qmax = INT_MIN;
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
    if (ok) atomicMax(&qmax, p);
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
      live = col < T_ && (!causal || p <= qmax);
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
                           (!causal || kp <= qp);
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
           int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const int BQ = kRows / G;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, K, B);
  attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), S, T_, H,
      K, G, BQ, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched);
// -1 for a head_dim or group size this kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* out,
                           int B, int S, int T_, int H, int K, int D,
                           int causal, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kRows) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DISPATCH(DD)                                                        \
  if (D == DD) {                                                            \
    return dtype == 0                                                       \
               ? launch<float, DD>(q, k, v, q_pos, kv_pos, out, B, S, T_, H, \
                                   K, causal, scale, s)                     \
               : launch<__nv_bfloat16, DD>(q, k, v, q_pos, kv_pos, out, B, S, \
                                           T_, H, K, causal, scale, s);     \
  }
  DISPATCH(16)
  DISPATCH(32)
  DISPATCH(64)
  DISPATCH(128)
#undef DISPATCH
  return -1;
}

}  // extern "C"

// Page gather (K2) and page scatter (K1) for the VILLA tiered store.
//
// Replaces src/repro/kernels/rbm_copy.py::villa_gather (body _gather_kernel)
// and ::villa_scatter (body _scatter_kernel): out[j] = pages[table[j]], and
// pages[table[j]] = updates[j] in place.
//
// Bound on the H100: bytes.  Each page moved is read once and written once;
// a 1 KiB page costs 2 KiB of HBM traffic, so one session's snapshot at
// tinyllama-1.1b full width (45,144 pages) is 92 MB and takes at least
// 27.6 us at 3.35 TB/s (gemma3-27b's 268.5 MB snapshot, 262k pages, 160
// us).  There is no arithmetic to speak of.
//
// Pages are raw bytes whatever their dtype; the wrapper passes the page
// size in bytes (a multiple of 16, 16-byte aligned).  Entries outside
// [0, N) are skipped on the device: -1 is the skip sentinel of the port's
// masked reads and writes, and any other out-of-range entry is never
// dereferenced (the wrapper raises on those when the table is known on the
// host).  A skipped gather entry leaves out[j] as it was.
//
// Gather design (redesigned in the 18th slice): a persistent grid of
// CTAs of 6 warps, as many as the SMs hold (one: each warp has two 16 KiB
// halves of shared memory).  A page is copied in units of at most 8 KiB
// (a hop's rows are up to 64 KiB: launch/mesh.py::hop_rows); warp w walks
// batches of 32 units w, w + warps, ... (warps numbered CTA-fastest, so
// that a run of live batches spreads over the SMs).  Each lane loads one
// unit's table entry, coalesced, 8 batches ahead; a ballot keeps the live
// ones, so a dead entry costs a bit of a load, not a round trip; the live
// units move by 1-d bulk copies (cp.async.bulk) global -> shared -> global
// through the two halves, one filling while the other drains, every lane
// issuing its own unit's copies.  So an SM keeps up to 192 KiB in flight
// without holding it in registers.  Measured on an H100 against a
// register-pipelined version (the next round's loads issued before this
// round's stores, 8 KiB a warp in flight at 103 registers): the bulk copy
// tied the old kernel on 1 KiB pages and on the shift hop and led on the
// one-pair hop, where the register version lost on 1 KiB pages.
//
// Scatter design: one CTA per page of the table, each thread moving 16-byte
// vectors (uint4).  CTAs run in no order, so the TPU kernel's
// last-write-wins over duplicate table entries is kept by a first pass
// that deduplicates on the device.  It inserts every index into an
// open-addressing hash table (capacity >= 2n, scratch from the wrapper)
// with atomicCAS and keeps the largest j per index with atomicMax; the copy
// pass writes page j only when j is the winner of its index.  Both passes
// cost O(touched pages).
//
// Later work: the scatter as a persistent kernel with bulk copies too, and
// fusing the checksum of each page into the gather.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned slot_of(int key, int mask) {
  return (static_cast<unsigned>(key) * 2654435761u) & static_cast<unsigned>(mask);
}

// A gather unit: the most of a page one copy moves (a table's rows may be
// larger: a hop's rows are up to 64 KiB), as 16-byte vectors.  On an H100,
// 8 KiB units did a little better than 4 KiB ones on the one-pair hop and
// tied elsewhere; other half sizes and warp counts did no better.
constexpr int kUnitVecs = 512;             // 8 KiB
constexpr int kGatherWarps = 6;
constexpr int kGatherThreads = 32 * kGatherWarps;
constexpr int kHalf = 16384;               // bytes of a warp's half-buffer
constexpr int kAhead = 8;                  // batches' entries in flight

// The live units of a warp's batch, in lane order: source and destination
// (in 16-byte vectors) and length.
struct Batch {
  long long src[32], dst[32];
  int len[32];
};

// Lane `lane` of a batch holds unit u, part u % spp of row j = u / spp
// (spp = ceil(page_vecs / unit_vecs) units a row; a row of at most
// kUnitVecs vectors is one unit), and its row's entry e.  A ballot keeps
// the entries in [0, n_pool); returns their count, their units in `bt`.
__device__ __forceinline__ int live_units(Batch& bt, int e, long long u,
                                          long long n_units, int spp,
                                          long long n_pool, int page_vecs,
                                          int unit_vecs, int lane) {
  const bool live = u < n_units && e >= 0 && e < n_pool;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (live) {
    const int k = __popc(mask & ((1u << lane) - 1));
    const long long j = spp == 1 ? u : u / spp;
    const int off = static_cast<int>(u - j * spp) * unit_vecs;
    bt.src[k] = static_cast<long long>(e) * page_vecs + off;
    bt.dst[k] = j * page_vecs + off;
    bt.len[k] = min(unit_vecs, page_vecs - off);
  }
  __syncwarp();
  return __popc(mask);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Persistent: warp w (numbered CTA-fastest, so that consecutive batches
// land on different SMs) takes the batches of 32 units w, w + warps, ...,
// each lane loading one unit's table entry, kAhead batches ahead.  The
// live units go through two halves of kHalf bytes of shared memory with
// 1-d bulk copies (cp.async.bulk): lane i loads unit g0 + i of the half it
// fills (its expect_tx on the half's mbarrier, lane 0's arrive), and once
// the half has landed lane i stores that unit; a half is refilled once its
// stores have read it, so one half's loads land while the other's drain.
// The halves stream across batches: each lane keeps its unit's
// destination and length beside the half, not in the batch list.
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const uint4* __restrict__ pages, uint4* __restrict__ out,
              const int* __restrict__ table, long long n_units, int spp,
              long long n_pool, int page_vecs, int unit_vecs) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ Batch batches[kGatherWarps];
  __shared__ long long pdst[kGatherWarps][2][32];
  __shared__ int pbytes[kGatherWarps][2][32];
  __shared__ __align__(8) unsigned long long bars[kGatherWarps][2];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  Batch& bt = batches[wi];
  const uint32_t half0 = smem_u32(buf + wi * 2 * kHalf);
  const uint32_t bar0 = smem_u32(&bars[wi][0]);
  const int ub = 16 * unit_vecs;                 // bytes a unit slot
  const int per_half = min(32, kHalf / ub);
  if (lane == 0) {
    for (int h = 0; h < 2; ++h)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(bar0 + 8 * h) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  const long long n_batches = (n_units + 31) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * kGatherWarps;
  const long long w0 = static_cast<long long>(wi) * gridDim.x + blockIdx.x;
  auto entry = [&](long long b) {
    const long long u = b * 32 + lane;
    return b < n_batches && u < n_units
               ? __ldg(table + (spp == 1 ? u : u / spp)) : -1;
  };
  unsigned parity = 0;                     // bit h: half h's next phase
  bool pend[2] = {false, false};           // half h holds loads to store
  auto drain = [&](int h) {                // wait its loads, store them
    const uint32_t bar = bar0 + 8 * h;
    const unsigned ph = (parity >> h) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(ph) : "memory");
    parity ^= 1u << h;
    const int bytes = pbytes[wi][h][lane];
    if (bytes > 0)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(out + pdst[wi][h][lane]), "r"(half0 + h * kHalf + lane * ub),
             "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    pend[h] = false;
  };
  int h = 0;
  auto batch = [&](long long b, int e) {
    const int n_live = live_units(bt, e, b * 32 + lane, n_units, spp, n_pool,
                                  page_vecs, unit_vecs, lane);
    for (int g0 = 0; g0 < n_live; g0 += per_half, h ^= 1) {
      if (pend[h]) drain(h);
      // every lane's stores out of this half have read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      const uint32_t bar = bar0 + 8 * h;
      const int k = g0 + lane;
      const bool mine = lane < per_half && k < n_live;
      const int bytes = mine ? 16 * bt.len[k] : 0;
      pbytes[wi][h][lane] = bytes;
      if (mine) {
        pdst[wi][h][lane] = bt.dst[k];
        asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
                     :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];\n"
            :: "r"(half0 + h * kHalf + lane * ub), "l"(pages + bt.src[k]),
               "r"(bytes), "r"(bar) : "memory");
      }
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                     :: "r"(bar) : "memory");
      pend[h] = true;
    }
    __syncwarp();                          // bt is the next batch's
  };
  int ent[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) ent[j] = entry(w0 + j * warps);
  for (long long b0 = w0; b0 < n_batches; b0 += kAhead * warps) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long b = b0 + j * warps;
      const int e = ent[j];
      ent[j] = entry(b + kAhead * warps);
      if (b < n_batches) batch(b, e);
    }
  }
  if (pend[h]) drain(h);                   // the older half first
  if (pend[h ^ 1]) drain(h ^ 1);
  // the CTA's shared memory outlives every store's read of it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncwarp();
}

__global__ void dedupe_kernel(const int* __restrict__ table, int n,
                              long long n_pool, int* keys, int* vals,
                              int mask) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int key = table[j];
  if (key < 0 || key >= n_pool) return;
  unsigned h = slot_of(key, mask);
  while (true) {
    const int prev = atomicCAS(&keys[h], -1, key);
    if (prev == -1 || prev == key) {
      atomicMax(&vals[h], j);
      return;
    }
    h = (h + 1) & static_cast<unsigned>(mask);
  }
}

__global__ void scatter_kernel(uint4* __restrict__ pages,
                               const uint4* __restrict__ updates,
                               const int* __restrict__ table,
                               long long n_pool, int vec_per_page,
                               const int* __restrict__ keys,
                               const int* __restrict__ vals, int mask) {
  const int j = blockIdx.x;
  const int dst = table[j];
  if (dst < 0 || dst >= n_pool) return;
  __shared__ int winner;
  if (threadIdx.x == 0) {
    unsigned h = slot_of(dst, mask);
    while (keys[h] != dst) h = (h + 1) & static_cast<unsigned>(mask);
    winner = vals[h];
  }
  __syncthreads();
  if (winner != j) return;                 // a later duplicate wins
  uint4* d = pages + static_cast<long long>(dst) * vec_per_page;
  const uint4* s = updates + static_cast<long long>(j) * vec_per_page;
  for (int i = threadIdx.x; i < vec_per_page; i += blockDim.x) d[i] = s[i];
}

constexpr int kScatterThreads = 64;        // 64 x 16 B = one 1 KiB page

}  // namespace

extern "C" {

// The persistent grid's size on the current device: as many CTAs of the
// gather as its SMs hold at once, after the gather's shared-memory opt-in.
// The wrapper reads it once a device.  Returns a cudaError_t.
int villa_gather_grid(int* blocks) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * kHalf * kGatherWarps);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_kernel, kGatherThreads, 2 * kHalf * kGatherWarps);
  *blocks = n_sm * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(e);
}

// out[j] = pages[table[j]] for j < n; entries outside [0, n_pool) skipped.
// grid: at most this many CTAs (villa_gather_grid).
int villa_gather_launch(const void* pages, void* out, const int* table,
                        int n, long long n_pool, int page_bytes, int grid,
                        void* stream) {
  if (n == 0) return 0;
  const int page_vecs = page_bytes / 16;
  const int unit_vecs = page_vecs < kUnitVecs ? page_vecs : kUnitVecs;
  const int spp = (page_vecs + unit_vecs - 1) / unit_vecs;
  const long long n_units = static_cast<long long>(n) * spp;
  const long long n_batches = (n_units + 31) / 32;
  const long long blocks = (n_batches + kGatherWarps - 1) / kGatherWarps;
  gather_kernel<<<static_cast<int>(blocks < grid ? blocks : grid),
                  kGatherThreads, 2 * kHalf * kGatherWarps,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pages), static_cast<uint4*>(out), table,
      n_units, spp, n_pool, page_vecs, unit_vecs);
  return static_cast<int>(cudaGetLastError());
}

// pages[table[j]] = updates[j] in place, last duplicate wins, entries
// outside [0, n_pool) skipped.  keys/vals: hash scratch of hash_cap (a power
// of two >= 2n) int32 each, filled with -1 by the caller.
int villa_scatter_launch(void* pages, const void* updates, const int* table,
                         int n, long long n_pool, int page_bytes, int* keys,
                         int* vals, int hash_cap, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dedupe_kernel<<<(n + 255) / 256, 256, 0, s>>>(table, n, n_pool, keys, vals,
                                                 hash_cap - 1);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scatter_kernel<<<n, kScatterThreads, 0, s>>>(
      static_cast<uint4*>(pages), static_cast<const uint4*>(updates), table,
      n_pool, page_bytes / 16, keys, vals, hash_cap - 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

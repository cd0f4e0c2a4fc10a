// Page gather (K2) and page scatter (K1) for the VILLA tiered store.
//
// Replaces src/repro/kernels/rbm_copy.py::villa_gather (body _gather_kernel)
// and ::villa_scatter (body _scatter_kernel): out[j] = pages[table[j]], and
// pages[table[j]] = updates[j] in place.
//
// Bound on the H100: bytes.  Each page moved is read once and written once;
// a 1 KiB page costs 2 KiB of HBM traffic, so one session's snapshot at
// tinyllama-1.1b full width (45,144 pages) is 92 MB and takes at least
// 27.6 us at 3.35 TB/s.  There is no arithmetic to speak of.
//
// Design: one CTA per page of the table, each thread moving 16-byte vectors
// (uint4) so a warp issues 512-byte coalesced transactions.  Pages are raw
// bytes whatever their dtype; the wrapper passes the page size in bytes
// (a multiple of 16).  The block reads its own table entry, which takes the
// place of the TPU kernel's scalar prefetch.  Entries outside [0, N) are
// skipped on the device: -1 is the skip sentinel of the port's masked
// writes, and any other out-of-range entry is never dereferenced (the
// wrapper raises on those when the table is known on the host).
//
// Scatter order: CTAs run in no order, so the TPU kernel's last-write-wins
// over duplicate table entries is kept by a first pass that deduplicates on
// the device.  It inserts every index into an open-addressing hash table
// (capacity >= 2n, scratch from the wrapper) with atomicCAS and keeps the
// largest j per index with atomicMax; the copy pass writes page j only when
// j is the winner of its index.  Both passes cost O(touched pages).
//
// Later work: a persistent kernel with TMA bulk copies, and fusing the
// checksum of each page into the gather.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned slot_of(int key, int mask) {
  return (static_cast<unsigned>(key) * 2654435761u) & static_cast<unsigned>(mask);
}

__global__ void gather_kernel(const uint4* __restrict__ pages,
                              uint4* __restrict__ out,
                              const int* __restrict__ table,
                              long long n_pool, int vec_per_page) {
  const long long j = blockIdx.x;
  const int src = table[j];
  if (src < 0 || src >= n_pool) return;
  const uint4* s = pages + static_cast<long long>(src) * vec_per_page;
  uint4* d = out + j * vec_per_page;
  for (int i = threadIdx.x; i < vec_per_page; i += blockDim.x) d[i] = s[i];
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

constexpr int kThreads = 64;               // 64 x 16 B = one 1 KiB page

}  // namespace

extern "C" {

// out[j] = pages[table[j]] for j < n; entries outside [0, n_pool) skipped.
int villa_gather_launch(const void* pages, void* out, const int* table,
                        int n, long long n_pool, int page_bytes,
                        void* stream) {
  if (n == 0) return 0;
  gather_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pages), static_cast<uint4*>(out), table,
      n_pool, page_bytes / 16);
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
  scatter_kernel<<<n, kThreads, 0, s>>>(
      static_cast<uint4*>(pages), static_cast<const uint4*>(updates), table,
      n_pool, page_bytes / 16, keys, vals, hash_cap - 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

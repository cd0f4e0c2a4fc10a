// Bulk tile copy (K4) for the movement substrate's tile_copy leg.
//
// Replaces src/repro/kernels/rbm_copy.py::rbm_copy (body _copy_kernel): an
// identity copy of any array through (tile_rows x lanes) tiles.  The TPU
// kernel flattens, pads to whole tiles, streams each tile HBM -> VMEM -> HBM
// and unpads; here the bytes stream global -> shared -> global through the
// Tensor Memory Accelerator's 1-D bulk copies, and the ragged end is cut
// short, so no padding is ever written or read.
//
// Bound on the H100: bytes.  Every byte is read once and written once, so a
// copy of B bytes takes at least 2 B / 3.35 TB/s (one 184.5 MB K leaf of the
// full-width tinyllama-1.1b serving cache: 110 us).  No arithmetic.
//
// Design: a persistent grid, as many CTAs as the SMs hold at once (the
// occupancy API, read once a device by rbm_copy_grid).  The 16-byte-aligned
// body is cut into chunks of kChunk bytes; CTA i takes
// chunks i, i + grid, i + 2 grid, ..., so the grid streams one contiguous
// front of memory (measured 1-2% faster than a contiguous range a CTA).  One elected thread of each CTA runs a ring of
// kStages shared-memory stages: cp.async.bulk global -> shared completes on
// the stage's mbarrier (complete_tx), cp.async.bulk shared -> global
// (bulk_group) writes the stage back out, and a stage is refilled only after
// wait_group.read says the store that used it has read it.  The copy engine
// computes the addresses, so the threads issue a few instructions a chunk
// and spend no registers on the data.  The byte head before the first
// 16-byte boundary and the tail after the last one (under 16 bytes each)
// are copied by CTA 0's threads; a source/destination pair that differs
// mod 16 (a view with an odd storage offset) has no bulk body and is copied
// byte by byte over the whole grid.  Any dtype is raw bytes.
//
// Later work: a 4- or 8-byte path for pairs that agree only mod 4 or 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kChunk = 16384;        // bytes a stage: 64 KiB a CTA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kThreads)
bulk_copy_kernel(const unsigned char* __restrict__ src,
                 unsigned char* __restrict__ dst, long long nbytes) {
  constexpr int chunk = kChunk;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kStages];

  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  if ((sa ^ da) & 15) {                      // no common 16-byte alignment
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < nbytes; i += step)
      dst[i] = src[i];
    return;
  }
  const long long to_edge = static_cast<long long>((16 - (sa & 15)) & 15);
  const long long head = to_edge < nbytes ? to_edge : nbytes;
  const long long body = (nbytes - head) & ~15ll;
  if (blockIdx.x == 0) {
    for (long long i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
    for (long long i = head + body + threadIdx.x; i < nbytes; i += kThreads)
      dst[i] = src[i];
  }
  const long long n_chunks = (body + chunk - 1) / chunk;
  if (threadIdx.x != 0 || blockIdx.x >= n_chunks) return;

  // One thread from here on: it owns the barriers and the ring.
  // chunks blockIdx.x, blockIdx.x + gridDim.x, ...: at any moment the grid
  // reads and writes one contiguous front of memory
  const int n = static_cast<int>((n_chunks - 1 - blockIdx.x) / gridDim.x + 1);
  auto at = [&](int i) {                            // chunk i's byte offset
    return head + (blockIdx.x + static_cast<long long>(i) * gridDim.x) * chunk;
  };
  auto bytes_of = [&](int i) -> uint32_t {
    const long long rest = head + body - at(i);
    return static_cast<uint32_t>(rest < chunk ? rest : chunk);
  };
  const uint32_t ring0 = smem_addr(ring);
  for (int i = 0; i < kStages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&full[i])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto load = [&](int i) {
    const int s = i % kStages;
    bulk_load(ring0 + s * chunk, src + at(i), bytes_of(i),
              smem_addr(&full[s]));
  };
  for (int i = 0; i < n && i < kStages; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    wait_parity(smem_addr(&full[s]), (i / kStages) & 1);
    // the stage was written by the async proxy; order the async read after
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(dst + at(i), ring0 + s * chunk, bytes_of(i));
    // refill the stage of chunk i - 1 once its store has read it, so one
    // store stays in flight beside the kStages - 1 loads
    if (i >= 1 && i - 1 + kStages < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// The persistent grid on the current device: as many CTAs as its SMs hold
// at once.  Also opts the kernel in to its dynamic shared memory.  The
// wrapper calls it once a device.  Returns a cudaError_t.
int rbm_copy_grid(int* blocks) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bulk_copy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStages * kChunk);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bulk_copy_kernel, kThreads, kStages * kChunk);
  *blocks = n_sm * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(e);
}

// The bytes of a stage, for the tests' sizes.
int rbm_copy_chunk() { return kChunk; }

// dst[0:nbytes] = src[0:nbytes] on at most `grid` CTAs (rbm_copy_grid's).
// Returns a cudaError_t (0 = launched).
int rbm_copy_launch(const void* src, void* dst, long long nbytes, int grid,
                    void* stream) {
  if (nbytes <= 0) return 0;
  const long long n_chunks = (nbytes + kChunk - 1) / kChunk;
  const int blocks = static_cast<int>(n_chunks < grid ? n_chunks : grid);
  bulk_copy_kernel<<<blocks, kThreads, kStages * kChunk,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Bulk tile copy (K4) for the movement substrate's tile_copy leg.
//
// Replaces src/repro/kernels/rbm_copy.py::rbm_copy (body _copy_kernel): an
// identity copy of any array through (tile_rows x lanes) tiles.  The TPU
// kernel flattens, pads to whole tiles, streams each tile HBM -> VMEM -> HBM
// and unpads; here each CTA copies one tile's bytes straight from source to
// destination and the ragged last tile is cut short, so no padding is ever
// written or read.
//
// Bound on the H100: bytes.  Every byte is read once and written once, so a
// copy of B bytes takes at least 2 B / 3.35 TB/s (one 184.5 MB K leaf of the
// full-width tinyllama-1.1b serving cache: 110 us).  No arithmetic.
//
// Design: one CTA per tile of tile_bytes = tile_rows * lanes * itemsize
// bytes (the wrapper's tile; 256 x 128 f32 is 128 KiB), 256 threads moving
// 16-byte vectors (uint4) so a warp issues 512-byte coalesced transactions.
// Any dtype is raw bytes.  The vector path needs source and destination
// at the same address mod 16: then each tile copies a byte head up to the
// first 16-byte boundary, the vectors, and a byte tail.  A pair that differs
// mod 16 (a view with an odd storage offset) copies byte by byte, still
// coalesced, inside the same kernel.
//
// Later work: TMA bulk copies (cp.async.bulk) with a persistent grid, and a
// 4- or 8-byte path for pairs that agree only mod 4 or 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void tile_copy_kernel(const unsigned char* __restrict__ src,
                                 unsigned char* __restrict__ dst,
                                 long long nbytes, long long tile_bytes) {
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_bytes;
  const long long left = nbytes - b0;
  const long long n = left < tile_bytes ? left : tile_bytes;
  const unsigned char* s = src + b0;
  unsigned char* d = dst + b0;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  const uintptr_t da = reinterpret_cast<uintptr_t>(d);
  long long head = n;          // bytes copied one by one before the vectors
  long long nvec = 0;
  if (((sa ^ da) & 15) == 0) {
    const long long to_edge = static_cast<long long>((16 - (sa & 15)) & 15);
    head = to_edge < n ? to_edge : n;
    nvec = (n - head) / 16;
  }
  for (long long i = threadIdx.x; i < head; i += kThreads) d[i] = s[i];
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* dv = reinterpret_cast<uint4*>(d + head);
#pragma unroll 4
  for (long long i = threadIdx.x; i < nvec; i += kThreads) dv[i] = sv[i];
  for (long long i = head + nvec * 16 + threadIdx.x; i < n; i += kThreads) {
    d[i] = s[i];
  }
}

}  // namespace

extern "C" {

// dst[0:nbytes] = src[0:nbytes], one CTA per tile of tile_bytes bytes.  The
// caller keeps the tile count within the grid's 2**31 - 1 blocks.
int rbm_copy_launch(const void* src, void* dst, long long nbytes,
                    long long tile_bytes, void* stream) {
  if (tile_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes <= 0) return 0;
  const long long n_tiles = (nbytes + tile_bytes - 1) / tile_bytes;
  tile_copy_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      nbytes, tile_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

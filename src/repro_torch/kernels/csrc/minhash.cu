// Min-hash of ragged version lists for Hopper (sm_90a): for every CSR row r
// (the versions col[indptr[r] .. indptr[r+1]) that record r belongs to) and
// every hash l of the multiply-shift family h_l(v) = a_l * v + b_l mod 2^32,
// out[l, r] = the unsigned minimum of h_l over the row; an empty row gives
// 0xFFFFFFFF.  Entries equal to -1 are skipped, as the padding of the TPU
// kernel's tiles is.
//
// Replaces the TPU kernel repro/kernels/minhash.py:minhash (_minhash_kernel
// at :29, its pallas_call at :59).  The TPU version needs the CSR scattered
// into (128, D) tiles padded with -1 to a power-of-two degree
// (repro/kernels/ops.py:83-101), which at 4 M rows would move gigabytes of
// padding.  Here the kernel reads the CSR itself as a segmented min.
//
// Bound: memory.  The function reads indptr and col once and writes the
// output once: 8*(R+1) + 4*nnz + 4*L*R bytes at 3.35 TB/s, against
// 3*L*nnz integer operations (multiply, add, min); at the SHINGLE build's
// shape (L = 8, mean degree about 16) the bytes take about 5 times as long.
//
// The first design gave every row a warp and reached 8% of that bound at the
// SHINGLE build's shape (4.19 M rows, mean degree 16): 1.600 ms on an H100
// SXM at 700 W.  Load latency held it there, not its stores.  Each warp
// made two dependent indptr loads, then one col load with about 16 useful
// lanes, and retired: one row per warp, a grid that never looped, too few
// bytes in flight to cover device memory's latency.  Coalescing its
// scattered stores alone (8 words a row, R words apart) gained 3%
// (1.551 ms); several rows per warp alone, 3.3x (0.479 ms).  This design:
//  - gives each row one thread, so a warp takes 32 consecutive rows: its
//    indptr loads are one coalesced request, and so is each of its stores
//    (hash l of its 32 rows is 32 consecutive words of out);
//  - unrolls the col loop by kUnroll, so each thread keeps that many loads
//    in flight, and loads the next row's indptr before the current row's
//    col loop, so the next pointers arrive while this row is hashed;
//  - runs a grid that just fills the card (minhash_launch sizes it from the
//    kernel's occupancy, asked once a device) with a grid-stride loop over
//    the rows, so every thread walks many rows.
// A group of g lanes a row, folded by a __shfl_xor_sync butterfly, was
// measured too and lost at the build's mean degree of 16 (g = 4: 0.334 ms);
// it would pay only on CSRs whose mean degree is in the hundreds, which no
// path of the port builds.
// At the build's shape this takes 0.245 ms, 53% of the bound.  What is left
// is, as far as timing can tell, lanes waiting inside a warp: a warp runs as
// long as its longest row, and with row degrees from 1 to 64 only about 39%
// of the lane steps hash an entry.
// Hashes are kept G = 8 at a time in registers (the store's shingle_hashes);
// gridDim.y walks the hash groups, so L is bounded only by the grid's
// 65,535 rows of 8.  A hash slot past L gets a = 0, b = 0xFFFFFFFF, whose
// value never lowers a min, so the inner loop has no branch on L.  All
// arithmetic is in uint32, which wraps mod 2^32 exactly as the reference
// hash does, and the min is unsigned.  A long row is walked by its thread
// alone: right at any degree, slow for a row far above its neighbours (its
// warp waits for it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int G = 8;        // hashes per grid row (gridDim.y)
constexpr int kUnroll = 8;  // col loads in flight per thread
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void fold(uint32_t (&m)[G], const uint32_t (&ha)[G],
                                     const uint32_t (&hb)[G], int32_t c) {
  if (c == -1) return;
  const uint32_t v = static_cast<uint32_t>(c);
#pragma unroll
  for (int l = 0; l < G; ++l) m[l] = min(m[l], ha[l] * v + hb[l]);
}

// (kThreads, 1): registers up to 255 a thread, the setting measured best
__global__ void __launch_bounds__(kThreads, 1)
    minhash_kernel(const int64_t* __restrict__ indptr,
                   const int32_t* __restrict__ col,
                   const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   long long R, int L) {
  const int l0 = blockIdx.y * G;
  const int nl = min(G, L - l0);
  uint32_t ha[G], hb[G];
#pragma unroll
  for (int l = 0; l < G; ++l) {
    ha[l] = l < nl ? a[l0 + l] : 0u;
    hb[l] = l < nl ? b[l0 + l] : 0xFFFFFFFFu;
  }
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long beg = 0, end = 0;
  if (row < R) {
    beg = indptr[row];
    end = indptr[row + 1];
  }
  for (; row < R; row += step) {
    long long nbeg = 0, nend = 0;  // the next row's pointers
    if (row + step < R) {
      nbeg = indptr[row + step];
      nend = indptr[row + step + 1];
    }
    uint32_t m[G];
#pragma unroll
    for (int l = 0; l < G; ++l) m[l] = 0xFFFFFFFFu;
    long long i = beg;
    for (; i + kUnroll <= end; i += kUnroll) {
      int32_t c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) c[u] = col[i + u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold(m, ha, hb, c[u]);
    }
    for (; i < end; ++i) fold(m, ha, hb, col[i]);
#pragma unroll
    for (int l = 0; l < G; ++l) {
      if (l < nl) out[static_cast<size_t>(l0 + l) * R + row] = m[l];
    }
    beg = nbeg;
    end = nend;
  }
}

// Blocks the current device holds at once: its SMs times the kernel's
// resident blocks a SM, asked once a device.
cudaError_t card_blocks(int* n) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *n = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minhash_kernel,
                                                      kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  *n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *n;
  return cudaSuccess;
}

}  // namespace

// One thread a row, in a grid of at most the blocks the card holds at once.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int minhash_launch(const void* indptr, const void* col,
                              const void* a, const void* b, void* out,
                              long long R, int L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  int cap = 0;
  const cudaError_t e = card_blocks(&cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (R + kThreads - 1) / kThreads;
  const auto gx = static_cast<unsigned>(need < cap ? need : cap);
  minhash_kernel<<<dim3(gx, (L + G - 1) / G), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(col),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), R, L);
  return static_cast<int>(cudaGetLastError());
}

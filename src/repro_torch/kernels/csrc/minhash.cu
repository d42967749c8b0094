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
// padding.  Here the kernel reads the CSR itself as a segmented min: one
// warp owns one row, its lanes stride over the row's entries and keep G
// running minima in registers (the hash loop is unrolled, so the arrays
// never reach local memory), then __reduce_min_sync (an unsigned reduction)
// folds the 32 lanes and lane l stores hash l.  gridDim.y walks the hashes
// in groups of G = 8 (the store's shingle_hashes), so L is not bounded.
// Rows are walked by a grid-stride loop with 64-bit indices.  All
// arithmetic is in uint32, which wraps mod 2^32 exactly as the reference
// hash does.
//
// Bound: memory.  The function reads indptr and col once and writes the
// output once: 8*(R+1) + 4*nnz + 4*L*R bytes at 3.35 TB/s, against
// 3*L*nnz integer operations (multiply, add, min); at the SHINGLE build's
// shape (L = 8, mean degree about 16) the bytes take about 5 times as long.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int G = 8;  // hashes per grid row (gridDim.y), at most 32

__global__ void minhash_kernel(const int64_t* __restrict__ indptr,
                               const int32_t* __restrict__ col,
                               const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, long long R, int L) {
  const int lane = threadIdx.x & 31;
  const int l0 = blockIdx.y * G;
  const int nl = min(G, L - l0);
  uint32_t ha[G], hb[G];
#pragma unroll
  for (int l = 0; l < G; ++l) {
    ha[l] = l < nl ? a[l0 + l] : 0u;
    hb[l] = l < nl ? b[l0 + l] : 0u;
  }
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < R; row += warps) {  // row is uniform across the warp
    uint32_t m[G];
#pragma unroll
    for (int l = 0; l < G; ++l) m[l] = 0xFFFFFFFFu;
    const long long end = indptr[row + 1];
    for (long long i = indptr[row] + lane; i < end; i += 32) {
      const int32_t c = col[i];
      if (c == -1) continue;
      const uint32_t v = static_cast<uint32_t>(c);
#pragma unroll
      for (int l = 0; l < G; ++l) {
        if (l < nl) m[l] = min(m[l], ha[l] * v + hb[l]);
      }
    }
    uint32_t mine = 0xFFFFFFFFu;
#pragma unroll
    for (int l = 0; l < G; ++l) {
      if (l < nl) {  // nl is uniform: every lane takes part in the reduction
        const uint32_t r = __reduce_min_sync(0xffffffffu, m[l]);
        if (lane == l) mine = r;
      }
    }
    if (lane < nl) out[static_cast<size_t>(l0 + lane) * R + row] = mine;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int minhash_launch(const void* indptr, const void* col,
                              const void* a, const void* b, void* out,
                              long long R, int L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  // at most 2^20 blocks of 8 warps; the grid-stride loop takes the rest
  const long long blocks = (R + kWarps - 1) / kWarps;
  const unsigned gx = static_cast<unsigned>(blocks < (1LL << 20) ? blocks
                                                                  : (1LL << 20));
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* ap = static_cast<const uint32_t*>(a);
  const auto* bp = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  minhash_kernel<<<dim3(gx, (L + G - 1) / G), kWarps * 32, 0, s>>>(
      ip, c, ap, bp, o, R, L);
  return static_cast<int>(cudaGetLastError());
}

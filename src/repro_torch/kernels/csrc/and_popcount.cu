// Index-ANDing for Hopper (sm_90a): out = bitmaps & row over (N, W) 32-bit
// words, where row is one (1, W) bitmap shared by every row (row_stride 0)
// or an (N, W) batch ANDed pairwise (row_stride W), plus the popcount of
// every ANDed row.
//
// Replaces the TPU kernel repro/kernels/bitmap.py:and_popcount
// (_and_popcount_kernel at :51, its pallas_call at :78), which streams
// (128, W) tiles through VMEM, holds a broadcast row in VMEM for the whole
// grid and counts bits with a SWAR bit-twiddle.  Here one warp owns one
// row: its lanes stride over the row with 16-byte loads and stores (scalar
// words when W % 4 != 0 or a pointer is not 16-byte aligned), __popc counts
// each word, and a warp-shuffle reduction gives the row's count, which lane
// 0 stores.  A broadcast row is read by every warp and stays in L1/L2.
// Eight rows per block.
//
// Bound: memory.  Each input word is read once and each output word written
// once: (2 or 3)*N*W*4 + 4*N bytes at 3.35 TB/s (two when the row is
// broadcast, three when pairwise); an AND, a popcount and an add per word
// are far below the card's integer rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ int popc4(const int4& x) {
  return __popc(static_cast<unsigned>(x.x)) +
         __popc(static_cast<unsigned>(x.y)) +
         __popc(static_cast<unsigned>(x.z)) +
         __popc(static_cast<unsigned>(x.w));
}

__global__ void and_popcount_kernel(const int32_t* __restrict__ bms,
                                    const int32_t* __restrict__ rows,
                                    int32_t* __restrict__ out,
                                    int32_t* __restrict__ cnt, int N, int W,
                                    int row_stride, int vec) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= N) return;  // r is uniform across the warp
  const size_t off = static_cast<size_t>(r) * W;
  const int32_t* row = rows + static_cast<size_t>(r) * row_stride;
  int c = 0;
  if (vec) {
    const int4* x4 = reinterpret_cast<const int4*>(bms + off);
    const int4* y4 = reinterpret_cast<const int4*>(row);
    int4* o4 = reinterpret_cast<int4*>(out + off);
    for (int i = lane; i < (W >> 2); i += 32) {
      const int4 x = x4[i];
      const int4 y = y4[i];
      const int4 z = make_int4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
      o4[i] = z;
      c += popc4(z);
    }
  } else {
    for (int i = lane; i < W; i += 32) {
      const int32_t z = bms[off + i] & row[i];
      out[off + i] = z;
      c += __popc(static_cast<unsigned>(z));
    }
  }
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) cnt[r] = c;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int and_popcount_launch(const void* bms, const void* row,
                                   void* out, void* cnt, int N, int W,
                                   int row_stride, int vec, void* stream) {
  if (N <= 0) return 0;
  const dim3 grid((N + kWarps - 1) / kWarps);
  and_popcount_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bms), static_cast<const int32_t*>(row),
      static_cast<int32_t*>(out), static_cast<int32_t*>(cnt), N, W, row_stride,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// XOR-delta for Hopper (sm_90a): d = parent ^ child over (N, W) 32-bit
// words, plus the count of nonzero words per row.  XOR is an involution, so
// the same kernel encodes and decodes.
//
// Replaces the TPU kernel repro/kernels/deltaenc.py:xor_delta
// (_xor_delta_kernel at :24, its pallas_call at :47), which streams
// (128, W) tiles through VMEM and lays the counts out along lanes.  Here one
// warp owns one row: its lanes stride over the row with 16-byte loads and
// stores (scalar words when W % 4 != 0 or a pointer is not 16-byte
// aligned), and a warp-shuffle reduction gives the row's count, which lane 0
// stores.  Eight rows per block.
//
// Bound: memory.  Each input word is read once and each output word written
// once: 3*N*W*4 + 4*N bytes at 3.35 TB/s; there is one XOR and one compare
// per word, far below the card's integer rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ int nonzero4(const int4& x) {
  return (x.x != 0) + (x.y != 0) + (x.z != 0) + (x.w != 0);
}

__global__ void xor_delta_kernel(const int32_t* __restrict__ parent,
                                 const int32_t* __restrict__ child,
                                 int32_t* __restrict__ delta,
                                 int32_t* __restrict__ cnt, int N, int W,
                                 int vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // row is uniform across the warp
  const size_t off = static_cast<size_t>(row) * W;
  int nz = 0;
  if (vec) {
    const int4* p4 = reinterpret_cast<const int4*>(parent + off);
    const int4* c4 = reinterpret_cast<const int4*>(child + off);
    int4* d4 = reinterpret_cast<int4*>(delta + off);
    for (int i = lane; i < (W >> 2); i += 32) {
      const int4 a = p4[i];
      const int4 b = c4[i];
      const int4 x = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
      d4[i] = x;
      nz += nonzero4(x);
    }
  } else {
    for (int i = lane; i < W; i += 32) {
      const int32_t x = parent[off + i] ^ child[off + i];
      delta[off + i] = x;
      nz += x != 0;
    }
  }
  for (int o = 16; o > 0; o >>= 1) nz += __shfl_down_sync(0xffffffffu, nz, o);
  if (lane == 0) cnt[row] = nz;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int xor_delta_launch(const void* parent, const void* child,
                                void* delta, void* cnt, int N, int W, int vec,
                                void* stream) {
  if (N <= 0) return 0;
  const dim3 grid((N + kWarps - 1) / kWarps);
  xor_delta_kernel<<<grid, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(child),
      static_cast<int32_t*>(delta), static_cast<int32_t*>(cnt), N, W, vec);
  return static_cast<int>(cudaGetLastError());
}

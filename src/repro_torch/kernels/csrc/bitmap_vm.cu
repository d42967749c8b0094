// Bitmap VM for Hopper (sm_90a): runs a (P, 4) int32 program
// (op, dst, lhs, rhs) in order over an (S, W) register file of 32-bit words,
// regs[dst] = op(regs[lhs], regs[rhs]) with op 0 = AND, 1 = OR, else ANDNOT,
// then takes per-row popcounts.  P == 0 is a copy plus popcount.
//
// Replaces the TPU kernel repro/kernels/bitmap.py:bitmap_vm
// (_bitmap_vm_kernel at :99, its pallas_call at :142).  The TPU version holds
// the whole register file in VMEM and walks the program with SMEM-sourced
// dynamic row offsets on one core.  Here every instruction is independent
// per word column, so one thread owns one column and runs the whole program
// on it; the grid tiles W.  No column ever reads another, so the program
// needs no synchronisation between threads, and a warp's reads and writes of
// out[row, w] are coalesced (neighbouring threads, neighbouring words).
//
// The program is staged through shared memory in tiles of kProgTile
// instructions, loaded once per block, so P is unbounded.  Per-row counts
// are summed per block (warp shuffles, then the warps' sums in shared
// memory) and added into cnt[row] with one atomicAdd per block: integer
// sums, so the order does not matter and the result is exact.  The caller
// zeroes cnt.
//
// Bound: memory.  The function reads regs and writes out and cnt once,
// 2*S*W*4 + 4*S bytes; this kernel also reads two and writes one row word per
// instruction and column, about 3*P*W*4 more bytes, which the 50 MB L2
// absorbs at the planner's sizes (a tile of the register file kept in
// shared memory would remove them from device memory entirely).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kProgTile = 1024;  // 16 KiB of int4 instructions

__global__ void bitmap_vm_kernel(const int32_t* __restrict__ regs,
                                 const int4* __restrict__ prog,
                                 int32_t* out, int32_t* __restrict__ cnt,
                                 int S, int W, int P) {
  __shared__ int4 sprog[kProgTile];
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = w < W;
  const size_t ws = static_cast<size_t>(W);

  if (active) {
    for (int s = 0; s < S; ++s) out[s * ws + w] = regs[s * ws + w];
  }
  for (int base = 0; base < P; base += kProgTile) {
    const int n = min(kProgTile, P - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n; i += blockDim.x) sprog[i] = prog[base + i];
    __syncthreads();
    if (active) {
      for (int i = 0; i < n; ++i) {
        const int4 ins = sprog[i];  // x = op, y = dst, z = lhs, w = rhs
        const int32_t a = out[ins.z * ws + w];
        const int32_t b = out[ins.w * ws + w];
        out[ins.y * ws + w] =
            ins.x == 0 ? (a & b) : (ins.x == 1 ? (a | b) : (a & ~b));
      }
    }
  }

  // per-row popcount: warp shuffles, then the block's warps summed in
  // shared memory, then one atomicAdd per block and row
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31;
  for (int s = 0; s < S; ++s) {
    int c = active ? __popc(static_cast<unsigned>(out[s * ws + w])) : 0;
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if (lane == 0) warp_sum[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      int t = 0;
      for (int i = 0; i < kThreads / 32; ++i) t += warp_sum[i];
      if (t != 0) atomicAdd(&cnt[s], t);
    }
    __syncthreads();  // warp_sum is rewritten for the next row
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bitmap_vm_launch(const void* regs, const void* prog, void* out,
                                void* cnt, int S, int W, int P,
                                void* stream) {
  if (S <= 0 || W <= 0) return 0;
  const dim3 grid((W + kThreads - 1) / kThreads);
  bitmap_vm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(regs), static_cast<const int4*>(prog),
      static_cast<int32_t*>(out), static_cast<int32_t*>(cnt), S, W, P);
  return static_cast<int>(cudaGetLastError());
}

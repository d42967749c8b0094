// Bitmap VM for Hopper (sm_90a): runs a (P, 4) int32 program
// (op, dst, lhs, rhs) in order over an (S, W) register file of 32-bit words,
// regs[dst] = op(regs[lhs], regs[rhs]) with op 0 = AND, 1 = OR, else ANDNOT,
// then takes per-row popcounts.  P == 0 is a copy plus popcount.
//
// Replaces the TPU kernel repro/kernels/bitmap.py:bitmap_vm
// (_bitmap_vm_kernel at :99, its pallas_call at :142).  The TPU version holds
// the whole register file in VMEM and walks the program with SMEM-sourced
// dynamic row offsets on one core.
//
// Bound: memory.  The function reads regs and writes out and cnt once,
// 2*S*W*4 + 16*P + 4*S bytes at 3.35 TB/s; it does one word operation per
// instruction and column.  At the planner's shapes (a k=1 wave: S = 129,
// W = 512, P = 64) that is 0.16 us, far below a launch: what is reachable
// there is the launch floor plus a few dependent shared-memory round trips.
//
// The first design ran one thread per word column over the whole program in
// device memory, in W/128 blocks: 4 blocks on 132 SMs at W = 512, and each
// thread paid about S + P serial round trips to L1/L2 (S row copies, a
// read-read-write per instruction, then per row a popcount with two block
// barriers), 57 us at the wave's shape.  Every instruction is still
// independent per column, so a column's program needs no other column; this
// design:
//  - gives a block a tile of kTile = 32 columns (16 blocks at W = 512) and
//    loads the block's S x 32 slice of the register file into shared memory
//    with all its threads, 16 bytes a thread where W % 4 == 0 and the
//    pointers allow, rows and columns at once;
//  - runs the program there, one thread (of the first warp) per column; the
//    next instruction is read before the current one's store, so the chain
//    per instruction is two operand loads and a store; the program is staged
//    through shared memory in tiles of kProgTile instructions, so P is
//    unbounded;
//  - writes the tile back and popcounts it with a warp per row
//    (__reduce_add_sync), adding one atomicAdd per block and row into the
//    zeroed cnt; integer sums are exact in any order.
// When the S x 32 tile does not fit in the 227 KB a block may hold, the same
// kernel runs the same three steps with the block's columns of `out` in
// device memory as the tile (bitmap_vm_launch picks it, for S > 1,752):
// slower, never a hand-over to the plain version.
// On an H100 SXM at 700 W a k=1 wave's program takes 5.5 us of device time,
// against 57 us before.  What holds it is the program's chain: each
// instruction is a dependent shared-memory read, operation and write, about
// 32 ns, P times over, in one warp a block; at (256, 4096, 128) that leaves
// the kernel at 17% of its bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // columns a block
constexpr int kProgTile = 512;  // 8 KiB of int4 instructions
constexpr int kMaxSmem = 232448;

// dst[s, c] = src[s, c] for s < S, c < wt (row strides ds, ss), all threads;
// each thread loads kBatch words (or 16-byte words) before it stores any,
// so the loads are in flight together
template <typename T>
__device__ __forceinline__ void copy_words(T* __restrict__ dst, int ds,
                                           const T* __restrict__ src, int ss,
                                           int S, int n) {
  constexpr int kBatch = 4;
  for (int i0 = threadIdx.x; i0 < S * n; i0 += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads, s = i / n;
      if (i < S * n) v[k] = src[static_cast<size_t>(s) * ss + (i - s * n)];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads, s = i / n;
      if (i < S * n) dst[static_cast<size_t>(s) * ds + (i - s * n)] = v[k];
    }
  }
}

__device__ __forceinline__ void copy_rows(int32_t* dst, int ds,
                                          const int32_t* src, int ss, int S,
                                          int wt, bool vec) {
  if (vec) {  // wt, ds, ss multiples of 4 and both bases 16-byte aligned
    copy_words(reinterpret_cast<int4*>(dst), ds >> 2,
               reinterpret_cast<const int4*>(src), ss >> 2, S, wt >> 2);
  } else {
    copy_words(dst, ds, src, ss, S, wt);
  }
}

// The three steps on a tile of wt columns with row stride ts: in shared
// memory (kShared) or the block's columns of out itself.
template <bool kShared>
__device__ void run_tile(const int32_t* __restrict__ regs,
                         const int4* __restrict__ prog, int32_t* out,
                         int32_t* __restrict__ cnt, int32_t* tile, int ts,
                         int4* sprog, int S, int W, int P, int c0, int wt,
                         bool vec) {
  copy_rows(tile, ts, regs + c0, W, S, wt, vec);
  const int c = threadIdx.x;
  for (int base = 0; base < P; base += kProgTile) {
    const int n = min(kProgTile, P - base);
    __syncthreads();  // the tile is loaded; the previous program tile is read
    for (int i = threadIdx.x; i < n; i += kThreads) sprog[i] = prog[base + i];
    __syncthreads();
    if (c < wt) {
      int4 next = sprog[0];
      for (int i = 0; i < n; ++i) {
        const int4 ins = next;  // x = op, y = dst, z = lhs, w = rhs
        if (i + 1 < n) next = sprog[i + 1];
        const int32_t x = tile[static_cast<size_t>(ins.z) * ts + c];
        const int32_t y = tile[static_cast<size_t>(ins.w) * ts + c];
        tile[static_cast<size_t>(ins.y) * ts + c] =
            ins.x == 0 ? (x & y) : (ins.x == 1 ? (x | y) : (x & ~y));
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int s = threadIdx.x >> 5; s < S; s += kWarps) {
    unsigned bits = 0;
    for (int k = lane; k < wt; k += 32) {
      const int32_t v = tile[static_cast<size_t>(s) * ts + k];
      if (kShared) out[static_cast<size_t>(s) * W + c0 + k] = v;
      bits += __popc(static_cast<unsigned>(v));
    }
    bits = __reduce_add_sync(0xffffffffu, bits);
    if (lane == 0 && bits != 0) atomicAdd(&cnt[s], static_cast<int>(bits));
  }
}

__global__ void __launch_bounds__(kThreads)
    bitmap_vm_kernel(const int32_t* __restrict__ regs,
                     const int4* __restrict__ prog, int32_t* out,
                     int32_t* __restrict__ cnt, int S, int W, int P,
                     bool shared, bool vec) {
  extern __shared__ int4 smem[];  // kProgTile instructions, then the tile
  int4* sprog = smem;
  const int c0 = blockIdx.x * kTile;
  const int wt = min(kTile, W - c0);
  if (shared) {
    run_tile<true>(regs, prog, out, cnt,
                   reinterpret_cast<int32_t*>(smem + kProgTile), kTile, sprog,
                   S, W, P, c0, wt, vec);
  } else {
    run_tile<false>(regs, prog, out, cnt, out + c0, W, sprog, S, W, P, c0, wt,
                    vec);
  }
}

}  // namespace

// The S x kTile tile goes to shared memory beside the program tile when it
// fits in what a block may hold, else the kernel works in out.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bitmap_vm_launch(const void* regs, const void* prog, void* out,
                                void* cnt, int S, int W, int P, void* stream) {
  if (S <= 0 || W <= 0) return 0;
  const long long tile = 4LL * S * kTile;
  const bool shared = kProgTile * 16LL + tile <= kMaxSmem;
  const long long smem = kProgTile * 16LL + (shared ? tile : 0LL);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(regs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (smem > 48 * 1024) {  // once a device: allow the whole 227 KB
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev >= 64 || !raised[dev])) {
      e = cudaFuncSetAttribute(bitmap_vm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
      if (e == cudaSuccess && dev < 64) raised[dev] = true;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kTile - 1) / kTile);
  bitmap_vm_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(regs), static_cast<const int4*>(prog),
      static_cast<int32_t*>(out), static_cast<int32_t*>(cnt), S, W, P, shared,
      vec);
  return static_cast<int>(cudaGetLastError());
}

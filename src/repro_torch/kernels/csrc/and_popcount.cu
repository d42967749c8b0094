// Index-ANDing for Hopper (sm_90a): out = bitmaps & row over (N, W) 32-bit
// words, where row is one (1, W) bitmap shared by every row (row_stride 0,
// broadcast) or an (N, W) batch ANDed pairwise (row_stride W), plus the
// popcount of every ANDed row.
//
// Replaces the TPU kernel repro/kernels/bitmap.py:and_popcount
// (_and_popcount_kernel at :51, its pallas_call at :78), which streams
// (128, W) tiles through VMEM, holds a broadcast row in VMEM for the whole
// grid and counts bits with a SWAR bit-twiddle.
//
// Design: the row-wise device code of xor_delta.cu (rowwise.cuh), so the
// same 16-byte path at every width and alignment, the same lane teams for
// narrow rows and clusters for long ones; __popc counts each word.  In
// broadcast mode each CTA stages the row into shared memory once, with a
// 1-D bulk async copy completing on an mbarrier when the row is 16-byte
// aligned and a whole number of int4, plain cp.async otherwise; rows above
// 12 K words (and the cluster path) read it from device memory.  The first
// design (one warp a row, int4 only at W % 4 == 0 with aligned pointers)
// had every warp re-read a broadcast row through L1/L2.  One launch per
// call, as the planner's one-launch contract counts.
//
// Bound: memory.  Each input word is read once and each output word written
// once: (2 * N + R) * W * 4 + 4 * N bytes at 3.35 TB/s (R = 1 broadcast,
// N pairwise); an AND, a popcount and an add per word are far below the
// card's integer rate.
#include "rowwise.cuh"

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int and_popcount_launch(const void* bms, const void* row,
                                   void* out, void* cnt, long long N,
                                   long long W, int row_stride,
                                   void* stream) {
  return static_cast<int>(rowwise::launch<true>(
      static_cast<const int32_t*>(bms), static_cast<const int32_t*>(row),
      static_cast<int32_t*>(out), static_cast<int32_t*>(cnt),
      rowwise::Rows{nullptr, W}, N, N * W, row_stride == 0,
      static_cast<cudaStream_t>(stream)));
}

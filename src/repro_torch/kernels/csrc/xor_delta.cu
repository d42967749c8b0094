// XOR-delta for Hopper (sm_90a): d = parent ^ child over rows of 32-bit
// words, plus the count of nonzero words per row.  XOR is an involution, so
// the same kernel encodes and decodes.  Two entries over the same device
// code (rowwise.cuh):
//  - xor_delta_ragged_launch: flat word buffers and an int64 CSR of word
//    offsets, one row per (parent, child) pair, rows of any lengths; the
//    store's build paths hand it every delta pair of a build in one call;
//  - xor_delta_launch: (N, W) rows, the ragged case with uniform offsets.
//
// Replaces the TPU kernel repro/kernels/deltaenc.py:xor_delta
// (_xor_delta_kernel at :24, its pallas_call at :47), which streams
// (128, W) tiles through VMEM, every row padded to one width, and lays the
// counts out along lanes.
//
// Design (rowwise.cuh): every width and alignment takes the 16-byte path
// (at most 3 scalar words at each end of a row; an input that is not
// aligned where the output is comes through two aligned int4 loads); rows
// up to 4,096 words on average take a team of 4 to 32 lanes a row (8 for
// the store's 64-word records); longer rows (the training path's 16,385-word
// rows) are split across a thread-block cluster of up to 8 CTAs, whose
// partial counts are combined through distributed shared memory in the same
// launch.  A cluster was chosen over a last-block-done pass because it
// needs no counter that must be zero before the launch, so neither a memset
// launch nor a workspace kept zeroed between calls.
//
// The first design (one warp a row, eight rows a block, int4 only when
// W % 4 == 0 and every pointer was 16-byte aligned, one launch per chunk
// built) idled half of each warp on 64-word rows and ran odd widths one
// scalar word a lane.
//
// Bound: memory.  Each input word is read once and each output word written
// once: 3 * words * 4 + 4 * rows bytes at 3.35 TB/s, and the ragged entry
// reads its 8 * (rows + 1) bytes of offsets too; there is one XOR and one
// compare per word, far below the card's integer rate.
#include "rowwise.cuh"

// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int xor_delta_launch(const void* parent, const void* child,
                                void* delta, void* cnt, long long N,
                                long long W, void* stream) {
  return static_cast<int>(rowwise::launch<false>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(child),
      static_cast<int32_t*>(delta), static_cast<int32_t*>(cnt),
      rowwise::Rows{nullptr, W}, N, N * W, 0,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int xor_delta_ragged_launch(const void* parent, const void* child,
                                       void* delta, void* cnt,
                                       const void* row_off, long long n_rows,
                                       long long total, void* stream) {
  return static_cast<int>(rowwise::launch<false>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(child),
      static_cast<int32_t*>(delta), static_cast<int32_t*>(cnt),
      rowwise::Rows{static_cast<const long long*>(row_off), 0}, n_rows, total,
      0, static_cast<cudaStream_t>(stream)));
}

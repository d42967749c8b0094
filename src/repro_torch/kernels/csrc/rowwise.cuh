// Row-wise word kernels for Hopper (sm_90a), shared by xor_delta.cu and
// and_popcount.cu: out = op(a, b) over the rows of a flat buffer of 32-bit
// words, plus one count per row (nonzero words after XOR, set bits after
// AND).
//
// Rows.  Row r is words [start(r), start(r) + len(r)) of a, b and out:
// uniform rows of W words (start = r * W), or ragged rows given by an int64
// CSR of word offsets (start = off[r], len = off[r + 1] - off[r]).  In
// broadcast mode b is one row of W words ANDed with every row of a.
//
// One 16-byte path at every width and alignment.  A stretch of a row is
// peeled to the next 16-byte boundary of out (at most 3 scalar words), run
// as int4 vectors, and ends in at most 3 scalar words.  An input whose
// address is not 16-byte aligned where out's is is read with the two
// aligned int4 loads that cover the vector, and the four words are picked
// from them ("funnel" loads: the second load is the neighbouring lane's
// first and comes from L1, so device memory still moves each byte once).
// Each aligned int4 read holds at least one word of the row, so no load
// leaves the buffer.  Every row counts its own words, whatever their
// alignment; no vector is assumed to start a row.
//
// Work sized to the row (the launchers choose from the mean row length):
//  - narrow rows: a team of G = 4, 8, 16 or 32 lanes a row, G the power of
//    two that covers half the row's vectors (8 for 64-word rows: two int4 a
//    lane, both in flight at once, no lane idle), 256/G rows a CTA, one row
//    a team; the team's counts meet in a __shfl_xor_sync butterfly and lane
//    0 stores the row's;
//  - long rows (mean above kSplitWords): a thread-block cluster of C <= 8
//    CTAs a row, each CTA one contiguous stretch of it; each CTA reduces its
//    stretch's count in shared memory, and after a cluster barrier CTA rank
//    0 adds the C partials through distributed shared memory and stores the
//    row's count.  A cluster keeps the combination inside the launch with
//    no workspace: a last-block-done pass would need a counter per row that
//    is zero before the launch, so a memset launch or a zeroed buffer kept
//    between calls, and atomics on the counts would need the counts zeroed.
//
// Tuning, measured on an H100 SXM (700 W) against the bound at the main
// paths' shapes: a team covering all of a 64-word row (one int4 a lane)
// reached 80% of the bound at (80957, 64), half of it (two in flight) 87%;
// a grid that filled the card once and looped lost 5-10 points to one CTA
// per 256/G rows; the split kernel reached 40% at 3 CTAs an SM and 87-89%
// when held to 32 registers (8 CTAs an SM), while the narrow kernel spills
// at 32 and runs best at 64.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowwise {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// Rows of more words than this (on average) are split across a cluster.
constexpr long long kSplitWords = 4096;
// Words one CTA of a cluster takes at most, before a row is given a larger
// cluster; and the largest cluster (the portable limit).
constexpr long long kSliceWords = 8192;
constexpr int kMaxCluster = 8;
// Vectors a lane keeps in flight on the aligned path.
constexpr int kBatch = 2;
// CTAs an SM must hold (__launch_bounds__), which caps the registers: 64 a
// thread for the narrow kernel (it spills below that), 32 for the split
// kernel (its clusters need many CTAs resident).
constexpr int kNarrowMinBlocks = 4;
constexpr int kSplitMinBlocks = 8;

// Row r of a uniform (off == nullptr) or ragged layout.
struct Rows {
  const long long* off;
  long long W;
  __device__ __forceinline__ long long start(long long r) const {
    return off ? off[r] : r * W;
  }
  __device__ __forceinline__ long long len(long long r) const {
    return off ? off[r + 1] - off[r] : W;
  }
};

template <bool kAnd>
__device__ __forceinline__ int32_t op(int32_t x, int32_t y) {
  return kAnd ? (x & y) : (x ^ y);
}

// The count a word adds: its set bits (AND) or whether it changed (XOR).
template <bool kAnd>
__device__ __forceinline__ int count(int32_t z) {
  return kAnd ? __popc(static_cast<unsigned>(z)) : (z != 0);
}

template <bool kAnd>
__device__ __forceinline__ int4 op4(const int4& x, const int4& y) {
  return make_int4(op<kAnd>(x.x, y.x), op<kAnd>(x.y, y.y),
                   op<kAnd>(x.z, y.z), op<kAnd>(x.w, y.w));
}

template <bool kAnd>
__device__ __forceinline__ int count4(const int4& z) {
  return count<kAnd>(z.x) + count<kAnd>(z.y) + count<kAnd>(z.z) +
         count<kAnd>(z.w);
}

// Words 4v .. 4v+3 of a stream that starts s words (0..3) past the 16-byte
// aligned address p4.
__device__ __forceinline__ int4 load4(const int4* p4, long long v, int s) {
  const int4 lo = p4[v];
  if (s == 0) return lo;
  const int4 hi = p4[v + 1];
  if (s == 1) return make_int4(lo.y, lo.z, lo.w, hi.x);
  if (s == 2) return make_int4(lo.z, lo.w, hi.x, hi.y);
  return make_int4(lo.w, hi.x, hi.y, hi.z);
}

__device__ __forceinline__ int words_to_16(const void* p) {
  return static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15)
         >> 2;
}

__device__ __forceinline__ int word_shift(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// out[i] = op(a[i], b[i]) for i in [0, n); returns this lane's count.  The
// team of `team` threads shares the stretch; `lane` is this thread's place
// in it (head and tail words go to lanes 0..2).
template <bool kAnd>
__device__ __forceinline__ int stretch(const int32_t* __restrict__ a,
                                       const int32_t* b,
                                       int32_t* __restrict__ out,
                                       long long n, int lane, int team) {
  int c = 0;
  const long long h = min(n, static_cast<long long>(words_to_16(out)));
  if (lane < h) {
    const int32_t z = op<kAnd>(a[lane], b[lane]);
    out[lane] = z;
    c += count<kAnd>(z);
  }
  const long long nv = (n - h) >> 2;
  const int32_t* a1 = a + h;
  const int32_t* b1 = b + h;
  const int sa = word_shift(a1), sb = word_shift(b1);
  const int4* a4 = reinterpret_cast<const int4*>(a1 - sa);
  const int4* b4 = reinterpret_cast<const int4*>(b1 - sb);
  int4* o4 = reinterpret_cast<int4*>(out + h);
  long long v = lane;
  if ((sa | sb) == 0) {
    // both inputs aligned where out is: kBatch vectors a lane in flight
    for (; v + (kBatch - 1LL) * team < nv; v += kBatch * team) {
      int4 x[kBatch], y[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        x[k] = a4[v + k * team];
        y[k] = b4[v + k * team];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int4 z = op4<kAnd>(x[k], y[k]);
        o4[v + k * team] = z;
        c += count4<kAnd>(z);
      }
    }
  }
  for (; v < nv; v += team) {
    const int4 z = op4<kAnd>(load4(a4, v, sa), load4(b4, v, sb));
    o4[v] = z;
    c += count4<kAnd>(z);
  }
  const long long t = h + (nv << 2);
  if (lane < n - t) {
    const int32_t z = op<kAnd>(a[t + lane], b[t + lane]);
    out[t + lane] = z;
    c += count<kAnd>(z);
  }
  return c;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage the broadcast row b[0 .. W) into shared memory, once for the CTA:
// one 1-D bulk async copy completing on an mbarrier when the row is 16-byte
// aligned and a whole number of int4, plain 4-byte cp.async otherwise.
// Every thread returns after the row has landed.
__device__ __forceinline__ void stage_row(int32_t* srow, const int32_t* b,
                                          long long W, uint64_t* bar) {
  const uint32_t bytes = static_cast<uint32_t>(W * 4);
  if ((reinterpret_cast<uintptr_t>(b) & 15) == 0 && (bytes & 15) == 0) {
    const uint32_t mb = smem_addr(bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(srow)),
          "l"(b), "r"(bytes), "r"(mb)
          : "memory");
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p;\n"
          "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "  selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(mb)
          : "memory");
    }
  } else {
    for (long long i = threadIdx.x; i < W; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(srow + i)),
                   "l"(b + i)
                   : "memory");
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
    __syncthreads();
  }
}

// Narrow rows: a team of G lanes a row, one row a team.  With `stage`, b
// is the broadcast row, staged in dynamic shared memory; with `bcast` and no
// stage it is read from device memory; else row r of b is at start(r), as
// for a.
template <bool kAnd, int G>
__global__ void __launch_bounds__(kThreads, kNarrowMinBlocks)
    narrow_kernel(const int32_t* __restrict__ a, const int32_t* b,
                  int32_t* __restrict__ out, int32_t* __restrict__ cnt,
                  Rows rows, long long n_rows, int bcast, int stage) {
  extern __shared__ int4 smem4[];
  __shared__ uint64_t bar;
  int32_t* srow = reinterpret_cast<int32_t*>(smem4);
  if (stage) stage_row(srow, b, rows.W, &bar);
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const long long r =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (r >= n_rows) return;  // r is uniform across the team
  const long long lo = rows.start(r);
  const int32_t* br = stage ? srow : (bcast ? b : b + lo);
  int c = stretch<kAnd>(a + lo, br, out + lo, rows.len(r), lane, G);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) c += __shfl_xor_sync(mask, c, o, G);
  if (lane == 0) cnt[r] = c;
}

// Long rows: a cluster of gridDim-consecutive CTAs a row, CTA k of the
// cluster one stretch of it; the partial counts meet in CTA 0 through
// distributed shared memory.
template <bool kAnd>
__global__ void __launch_bounds__(kThreads, kSplitMinBlocks)
    split_kernel(const int32_t* __restrict__ a, const int32_t* b,
                 int32_t* __restrict__ out, int32_t* __restrict__ cnt,
                 Rows rows, int bcast) {
  __shared__ int warp_part[kThreads / 32];
  __shared__ int part;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned k = cluster.block_rank();
  const long long r = blockIdx.x / C;
  const long long lo = rows.start(r), n = rows.len(r);
  const long long piece = ((n + C - 1) / C + 3) & ~3LL;
  const long long s0 = min(n, k * piece), s1 = min(n, s0 + piece);
  const int32_t* br = (bcast ? b : b + lo) + s0;
  int c = stretch<kAnd>(a + lo + s0, br, out + lo + s0, s1 - s0,
                        threadIdx.x, kThreads);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
    part = s;
  }
  cluster.sync();  // every CTA's partial is written
  if (k == 0 && threadIdx.x == 0) {
    int s = 0;
    for (unsigned j = 0; j < C; ++j) s += *cluster.map_shared_rank(&part, j);
    cnt[r] = s;
  }
  cluster.sync();  // no CTA leaves while CTA 0 may read its shared memory
}

template <bool kAnd, int G>
cudaError_t launch_narrow(const int32_t* a, const int32_t* b, int32_t* out,
                          int32_t* cnt, Rows rows, long long n_rows,
                          int bcast, int stage, cudaStream_t stream) {
  const long long ctas = (n_rows + kThreads / G - 1) / (kThreads / G);
  const size_t smem =
      stage ? static_cast<size_t>((rows.W + 3) / 4 + 1) * sizeof(int4) : 0;
  narrow_kernel<kAnd, G><<<static_cast<unsigned>(ctas), kThreads, smem,
                           stream>>>(a, b, out, cnt, rows, n_rows, bcast,
                                     stage);
  return cudaGetLastError();
}

// Largest broadcast row staged in shared memory (the default dynamic
// shared-memory limit, less the int4 of slack a funnel load may touch).
constexpr long long kStageMaxWords = (48 * 1024) / 4 - 4;

// Launch over n_rows rows of `total` words in all: the narrow kernel with
// the team that covers the mean row, or the split kernel for long rows.
template <bool kAnd>
cudaError_t launch(const int32_t* a, const int32_t* b, int32_t* out,
                   int32_t* cnt, Rows rows, long long n_rows, long long total,
                   int bcast, cudaStream_t stream) {
  if (n_rows <= 0) return cudaSuccess;
  const long long mean = total / n_rows;
  if (mean > kSplitWords) {
    long long C = (mean + kSliceWords - 1) / kSliceWords;
    if (C > kMaxCluster) C = kMaxCluster;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_rows * C));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(C);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, split_kernel<kAnd>, a, b, out, cnt, rows,
                           bcast);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  // one row reads the broadcast row once: nothing to stage
  const int stage =
      bcast && n_rows > 1 && rows.W > 0 && rows.W <= kStageMaxWords;
  // a team of the power of two lanes that covers half the row's vectors
  const long long vecs = (mean + 7) / 8;
  if (vecs <= 4)
    return launch_narrow<kAnd, 4>(a, b, out, cnt, rows, n_rows, bcast, stage,
                                  stream);
  if (vecs <= 8)
    return launch_narrow<kAnd, 8>(a, b, out, cnt, rows, n_rows, bcast, stage,
                                  stream);
  if (vecs <= 16)
    return launch_narrow<kAnd, 16>(a, b, out, cnt, rows, n_rows, bcast, stage,
                                   stream);
  return launch_narrow<kAnd, 32>(a, b, out, cnt, rows, n_rows, bcast, stage,
                                 stream);
}

}  // namespace rowwise

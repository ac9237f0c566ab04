// (node, feature, bin) histogram of per-row stat channels — the Hopper port
// of the Pallas kernel shifu_tpu/ops/hist_pallas.py::_hist_kernel (launched
// there from build_histograms_pallas).  Built by
// shifu_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (plain C entry point, no PyTorch headers).
//
// What it computes:
//   out[k, c, b, s] = sum_n [node_idx[n] == k] * stats[n, s] * [bins[n, c] == b]
// for bins [N, C] uint8 or int32, node_idx [N] int32 (-1 = inactive row),
// stats [N, S] f32, out [K, C, B, S] f32; any K, any B <= 65536, any S >= 1.
// Rows whose node id is outside [0, K) and cells whose bin id is outside
// [0, B) contribute nothing.
//
// Determinism: every sum is taken in 64-bit fixed point.  Channel s is
// scaled by 2^e_s, with e_s chosen from amax_s = max_n |stats[n, s]| (read
// from a device tensor the wrapper computes, so the host never syncs) and N
// such that amax_s * N * 2^e_s < 2^62.  Each row's stat becomes the integer
// q = rint(stats[n, s] * 2^e_s), |q| <= 2^62 / N, so no partial or total
// sum of N quanta can reach 2^63: integer addition is exact and
// associative, so the 64-bit atomic adds (two's complement; in shared
// memory as a low and a high 32-bit word with an explicit carry, see
// add_u64) give the same bits whatever order the blocks, warps and
// threads run in.  The result is rint_f32(sum) * 2^-e_s.
// Integer-valued stats (the count channel w with integer weights) are
// exact: q = w * 2^e_s loses no bit.  A value loses bits only below
// 2^-e_s = about amax_s * N * 2^-62, 42 bits under amax_s at N = 2^20.
// Non-finite stats are outside the contract: their whole channel comes
// out NaN.
//
// What bounds it on an H100: bytes.  It must read the bins of every active
// row once (N*C bytes at uint8: 268 MB at N = 2^20, C = 256), node_idx and
// the active rows' stats once, and write [K, C, B, S] f32 once; its
// N*C*S additions are far below the card's integer rate.
//
// What the design does about it: one block owns a group of columns, a tile
// of nodes and a tile of bins, over a chunk of rows, with that sub-
// histogram private in shared memory (<= 96 KB with the row staging, so
// two blocks share an SM).  Bins are tiled only when one node's column
// does not fit; nodes are tiled so that a block still holds >= 32 columns
// (a warp's worth of neighbouring bin bytes per row).  The block walks its
// rows in tiles of up to 1024: each thread reads up to four node ids at
// once, and the rows of the block's node tile are compacted into shared
// memory (warp ballot, one shared counter) with their quantised stats, so
// an inactive or other-tile row costs one coalesced node_idx read.  Then
// each thread keeps one column and strides over the compacted rows, so
// neighbouring threads read neighbouring bytes of a row, with four bin
// reads in flight per thread before their atomics.  The sub-histogram is
// two planes of 32-bit words (the native shared-memory atomics) whose
// column stride is odd, so 32 threads on 32 neighbouring columns hit 32
// distinct banks.  Each block
// then adds its non-zero cells into a 64-bit global accumulator, and a
// second kernel converts it to f32.  channel_exp and add_u64 live in
// fixed_point.cuh, shared with stats_hist.cu.  Not done yet (later work): staging
// rows with cp.async/TMA, vector bin loads, partitioning rows by node so
// that deep levels stop re-reading every node id once per node tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;                    // node ids in flight
constexpr int kMaxTileRows = kThreads * kRowsPerThread;
constexpr int kUnroll = 4;                           // bin reads in flight
constexpr int kSmemBudget = 96 * 1024;               // two blocks per SM
constexpr int kStageBudget = 24 * 1024;              // compacted row tile
constexpr int kWantCols = 32;
constexpr int kTargetBlocks = 528;                   // two waves, 2 x 132
constexpr long long kMinRowsPerBlock = 1024;

using shifu::add_u64;
using shifu::channel_exp;

// Shared memory, in this order: channel scales double[S]; quantised stats
// of the compacted rows long long[tile_rows * S]; the sub-histogram's low
// and high 32-bit words, two planes of unsigned[col_group * col_stride];
// compacted row offsets int[tile_rows]; their local node ids
// int[tile_rows]; the compacted-row counter int.
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_accum_kernel(const BinT* __restrict__ bins,          // [N, C]
                  const int32_t* __restrict__ node_idx,   // [N]
                  const float* __restrict__ stats,        // [N, S]
                  const float* __restrict__ amax,         // [S]
                  unsigned long long* __restrict__ acc,   // [K, C, B, S]
                  long long n_rows, int n_cols, int n_nodes, int n_bins,
                  int n_stats, int col_group, int node_tile, int bin_tile,
                  int n_col_groups, int n_node_tiles, int col_stride,
                  long long rows_per_block, int tile_rows) {
  extern __shared__ __align__(16) unsigned long long smem[];
  double* scale = reinterpret_cast<double*>(smem);
  long long* tq = reinterpret_cast<long long*>(smem + n_stats);
  unsigned* hist_lo = reinterpret_cast<unsigned*>(
      smem + n_stats + (size_t)tile_rows * n_stats);
  unsigned* hist_hi = hist_lo + (size_t)col_group * col_stride;
  int* trow = reinterpret_cast<int*>(hist_hi + (size_t)col_group * col_stride);
  int* tk = trow + tile_rows;
  int* n_valid = tk + tile_rows;

  const int cg = blockIdx.x % n_col_groups;
  const int tile = blockIdx.x / n_col_groups;
  const int c0 = cg * col_group;
  const int cols = min(col_group, n_cols - c0);
  const int k0 = (tile % n_node_tiles) * node_tile;
  const int kt = min(node_tile, n_nodes - k0);
  const int b0 = (tile / n_node_tiles) * bin_tile;
  const int bt = min(bin_tile, n_bins - b0);
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, n_rows);
  if (cols <= 0 || kt <= 0 || bt <= 0 || r0 >= r1) return;

  for (int s = threadIdx.x; s < n_stats; s += blockDim.x)
    scale[s] = ldexp(1.0, channel_exp(__ldg(amax + s), n_rows));
  const int slots = cols * col_stride;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    hist_lo[i] = 0u;
    hist_hi[i] = 0u;
  }
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  // (row, column) pairs: each thread keeps one column and strides over
  // the compacted rows; neighbouring threads take neighbouring columns
  const int lanes = min(cols, kThreads);
  const int rows_per_pass = kThreads / lanes;
  const int row_slot = threadIdx.x / lanes;

  for (long long t0 = r0; t0 < r1; t0 += tile_rows) {
    if (threadIdx.x == 0) *n_valid = 0;
    __syncthreads();
    // the tile's rows of this node tile, compacted with their quanta
    const int tr = (int)min((long long)tile_rows, r1 - t0);
    int kk[kRowsPerThread];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int i = u * kThreads + threadIdx.x;
      kk[u] = i < tr ? __ldg(node_idx + t0 + i) - k0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const bool ok = (unsigned)kk[u] < (unsigned)kt;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      int base = 0;
      if (lane == 0 && m != 0u) base = atomicAdd(n_valid, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (ok) {
        const int slot = base + __popc(m & lanes_below);
        const int i = u * kThreads + threadIdx.x;
        trow[slot] = i;
        tk[slot] = kk[u];
        const float* st = stats + (t0 + i) * n_stats;
        for (int s = 0; s < n_stats; ++s)
          tq[slot * n_stats + s] =
              __double2ll_rn((double)__ldg(st + s) * scale[s]);
      }
    }
    __syncthreads();

    const int nv = *n_valid;
    if (row_slot < rows_per_pass) {
      for (int c = threadIdx.x % lanes; c < cols; c += lanes) {
        const BinT* col = bins + t0 * n_cols + c0 + c;
        for (int v0 = row_slot; v0 < nv; v0 += rows_per_pass * kUnroll) {
          int b[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int v = v0 + u * rows_per_pass;
            b[u] = v < nv ? (int)__ldg(col + (long long)trow[v] * n_cols) - b0
                          : -1;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if ((unsigned)b[u] >= (unsigned)bt) continue;   // tail, other tile
            const int v = v0 + u * rows_per_pass;
            const int cell =
                c * col_stride + (tk[v] * bin_tile + b[u]) * n_stats;
            const long long* q = tq + v * n_stats;
            for (int s = 0; s < n_stats; ++s)
              if (q[s] != 0) add_u64(hist_lo + cell + s, hist_hi + cell + s,
                                     q[s]);
          }
        }
      }
    }
    __syncthreads();
  }

  // add the block's non-zero cells into the global accumulator; for a
  // fixed (node, column) the bt * S cells are contiguous in both layouts
  const int run = bt * n_stats;
  const int total = cols * kt * run;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i % run;
    const int kc = i / run;
    const int c = kc % cols;
    const int k = kc / cols;
    const int cell = c * col_stride + k * bin_tile * n_stats + j;
    const unsigned long long val =
        ((unsigned long long)hist_hi[cell] << 32) | hist_lo[cell];
    if (val != 0ull)
      atomicAdd(acc + (((size_t)(k0 + k) * n_cols + (c0 + c)) * n_bins + b0)
                          * n_stats + j,
                val);
  }
}

__global__ void hist_finalize_kernel(const unsigned long long* __restrict__ acc,
                                     const float* __restrict__ amax,
                                     float* __restrict__ out,
                                     long long total, int n_stats,
                                     long long n_rows) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(i % n_stats);
    const float a = __ldg(amax + s);
    if (!isfinite(a)) {
      out[i] = __int_as_float(0x7fc00000);     // NaN: stats not finite
      continue;
    }
    out[i] = ldexpf(__ll2float_rn((long long)acc[i]),
                    -channel_exp(a, n_rows));
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename BinT>
int launch(const void* bins, const void* node_idx, const void* stats,
           const void* amax, void* acc, void* out, long long n_rows,
           int n_cols, int n_nodes, int n_bins, int n_stats, void* stream) {
  if (n_cols <= 0 || n_nodes <= 0 || n_bins <= 0 || n_bins > 65536 ||
      n_stats <= 0 || n_rows < 0)
    return cudaErrorInvalidValue;
  const long long total = (long long)n_nodes * n_cols * n_bins * n_stats;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)total * 8, st);
  if (err != cudaSuccess) return err;

  if (n_rows > 0) {
    // the compacted row tile: its quanta, row offsets and node ids
    long long tile_rows = kStageBudget / (8LL * n_stats + 8);
    tile_rows = tile_rows > kMaxTileRows ? kMaxTileRows : tile_rows / 32 * 32;
    if (tile_rows < 32) tile_rows = 32;
    const long long stage = 8LL * n_stats * (tile_rows + 1)
                            + 4LL * (2 * tile_rows + 1);
    // u64 words left for the sub-histogram
    const long long slots = (kSmemBudget - stage) / 8 - 1;
    if (slots < 2) return cudaErrorInvalidValue;
    // tile nodes until kWantCols columns fit, then bins if one does not
    const long long want = n_cols < kWantCols ? n_cols : kWantCols;
    long long node_tile = n_nodes, bin_tile = n_bins;
    if ((node_tile * bin_tile * n_stats + 1) * want > slots) {
      node_tile = (slots / want - 1) / ((long long)n_bins * n_stats);
      if (node_tile < 1) node_tile = 1;
      if (node_tile * bin_tile * n_stats + 1 > slots)
        bin_tile = (slots - 1) / n_stats;
    }
    const long long n_node_tiles = cdiv(n_nodes, node_tile);
    node_tile = cdiv(n_nodes, n_node_tiles);            // balance the tiles
    const long long n_bin_tiles = cdiv(n_bins, bin_tile);
    bin_tile = cdiv(n_bins, n_bin_tiles);
    long long col_stride = node_tile * bin_tile * n_stats;
    if ((col_stride & 1) == 0) col_stride += 1;          // odd: bank spread
    const long long max_group = slots / col_stride;
    const long long n_col_groups = cdiv(n_cols, max_group);
    const long long col_group = cdiv(n_cols, n_col_groups);
    const long long per_chunk = n_col_groups * n_node_tiles * n_bin_tiles;
    if (per_chunk > 0x7fffffffLL) return cudaErrorInvalidValue;
    long long chunks = kTargetBlocks / per_chunk;
    const long long most = cdiv(n_rows, kMinRowsPerBlock);
    if (chunks > most) chunks = most;
    if (chunks > 65535) chunks = 65535;
    if (chunks < 1) chunks = 1;
    const long long rows_per_block = cdiv(n_rows, chunks);
    chunks = cdiv(n_rows, rows_per_block);
    const size_t smem = (size_t)(8 * (n_stats * (tile_rows + 1)
                                      + col_group * col_stride)
                                 + 4 * (2 * tile_rows + 1));
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(hist_accum_kernel<BinT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    dim3 grid((unsigned)per_chunk, (unsigned)chunks);
    hist_accum_kernel<BinT><<<grid, kThreads, smem, st>>>(
        (const BinT*)bins, (const int32_t*)node_idx, (const float*)stats,
        (const float*)amax, (unsigned long long*)acc, n_rows, n_cols,
        n_nodes, n_bins, n_stats, (int)col_group, (int)node_tile,
        (int)bin_tile, (int)n_col_groups, (int)n_node_tiles,
        (int)col_stride, rows_per_block, (int)tile_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  long long blocks = cdiv(total, 256);
  if (blocks > 8192) blocks = 8192;
  hist_finalize_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (const unsigned long long*)acc, (const float*)amax, (float*)out, total,
      n_stats, n_rows);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = launched).  `bin_bytes` is
// the width of a bin id: 1 (uint8 planes, <= 256 bins) or 4 (int32).
// `amax` [S] holds max |stats[:, s]|; `acc` is [K*C*B*S] 8-byte scratch the
// kernel zeroes itself; `out` is [K, C, B, S] f32.  All contiguous.
extern "C" int shifu_hist(const void* bins, int bin_bytes,
                          const void* node_idx, const void* stats,
                          const void* amax, void* acc, void* out,
                          long long n_rows, int n_cols, int n_nodes,
                          int n_bins, int n_stats, void* stream) {
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, node_idx, stats, amax, acc, out, n_rows,
                           n_cols, n_nodes, n_bins, n_stats, stream);
  if (bin_bytes == 4)
    return launch<int32_t>(bins, node_idx, stats, amax, acc, out, n_rows,
                           n_cols, n_nodes, n_bins, n_stats, stream);
  return cudaErrorInvalidValue;
}

// Tree-batched (tree, node, feature, bin) histogram — the Hopper port of the
// Pallas kernel shifu_tpu/ops/hist_pallas.py::_hist_kernel_batch (launched
// there from build_histograms_pallas_batch).  Built by
// shifu_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (plain C entry points, no PyTorch headers).
//
// What it computes, for TB trees over one shared bin plane:
//   out[t, k, c, b, s] = sum_n [node_idx[t, n] == k] * stats[t, n, s]
//                              * [bins[n, c] == b]
// for bins [N, C] uint8 or int32, node_idx [TB, N] int32 (-1 = inactive),
// stats [TB, N, S] f32, out [TB, K, C, B, S] f32; any TB >= 1, any K, any
// B <= 65536, any S >= 1.  Rows whose node id is outside [0, K) and cells
// whose bin id is outside [0, B) contribute nothing.
//
// The contract: tree t's slice out[t] is bit-identical to hist.cu (B1) on
// (bins, node_idx[t], stats[t]).  Both take every sum in 64-bit fixed
// point with the scale of fixed_point.cuh::channel_exp, here per (tree,
// channel) from that tree's own amax[t, s] = max_n |stats[t, n, s]| and the
// same N, and both finalize as rint_f32(sum) * 2^-e.  Integer sums do not
// depend on their order, so neither the tiling below nor the order in
// which atomics land can move a bit.
//
// What bounds it on an H100: bytes.  The bins of the active rows once
// (268 MB at N = 2^20, C = 256, uint8), each tree's node ids and its
// active rows' stats once, and the [TB, K, C, B, S] f32 output once (4.3 GB
// at TB = 8 on the deepest level of a depth-14 tree, K = 4096); the adds
// are far below the card's integer rate.
//
// What the design does about it — two modes, chosen per launch from the
// shapes alone:
//
// * Shared rows (shallow levels: a tile of >= 2 trees with all K nodes
//   fits 32 columns of shared memory — at B = 64, S = 2 only K = 1).  A
//   block owns a tree tile, a
//   column group and a row range.  It stages each row tile's node ids and
//   quantised stats for every tree of its tile, then each thread keeps
//   one column, reads a row's bin ONCE and adds it into every tree of the
//   tile whose node is live — the bins read is shared by the tree tile,
//   which is why the batched kernel exists.
// * Partitioned rows (deeper levels).  Tiling K nodes the way hist.cu
//   does would make every node tile re-read all N node ids (at K = 4096
//   thousands of times a level).  Instead three small kernels first
//   counting-sort each tree's active rows by node (counts, a per-tree
//   exclusive scan, a scatter — the order inside a node is whatever the
//   atomics give, which the integer sums do not see).  A block then owns
//   (tree, node tile, bin tile, column group) and walks only that node
//   tile's segment of its tree's sorted rows: every row's node id is read
//   a constant number of times per level, whatever K is.
//
// In both modes the block's sub-histogram lives in shared memory as two
// planes of 32-bit words (the native shared atomics; fixed_point.cuh's
// add_u64 carries between them) with an odd column stride, so 32 threads on
// 32 neighbouring columns hit 32 distinct banks, in <= 96 KB so two blocks
// share an SM.  When a launch needs only one block per output tile (one
// row chunk: the deep levels), blocks write their finalized f32 cells
// straight to `out`; otherwise they add their non-zero cells into a 64-bit
// global accumulator that a last kernel converts.  Not done yet (later
// work): cp.async/TMA staging, vector bin loads, sharing the bins read
// across trees at deep levels.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 1024;
constexpr int kUnroll = 4;                           // bin reads in flight
constexpr int kSmemBudget = 96 * 1024;               // two blocks per SM
constexpr int kStageBudget = 24 * 1024;              // staged row tile
// columns a block wants: a warp's worth of neighbouring bin bytes a row
// (9-column blocks ran at under half of hist.cu's shared-atomic rate on an
// H100)
constexpr int kWantCols = 32;
constexpr int kTargetBlocks = 528;                   // two waves, 2 x 132
constexpr long long kMinRowsPerBlock = 1024;
constexpr int kNanExp = INT_MIN;                     // channel not finite
constexpr int kScanThreads = 1024;

using shifu::add_u64;
using shifu::channel_exp;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// How one launch tiles its work; a pure function of the shapes, so the
// workspace query and the launch agree.
struct Plan {
  int shared;                        // 1 shared rows, 0 partitioned rows
  long long tree_tile, n_tree_tiles;
  long long node_tile, n_node_tiles;
  long long bin_tile, n_bin_tiles;
  long long col_group, n_col_groups;
  long long col_stride;              // cells of one column's sub-histogram
  long long tile_rows;               // rows staged at once
  long long chunks;                  // row chunks (grid y)
  long long rows_per_block;          // shared mode
  int direct;                        // one chunk: blocks write f32
  size_t smem;
  size_t ws_acc, ws_off, ws_cur, ws_perm, ws_bytes;
};

long long stage_rows(long long tt, long long n_stats) {
  long long r = kStageBudget / (4 + 4 * tt + 8 * tt * n_stats);
  r = r > kMaxTileRows ? kMaxTileRows : r / 32 * 32;
  return r < 32 ? 32 : r;
}

// cells left for the sub-histogram after the staging of tt trees
long long hist_cells(long long tt, long long n_stats, long long tile_rows) {
  const long long stage = 12 * tt * n_stats
                          + tile_rows * (4 + 4 * tt + 8 * tt * n_stats);
  return (kSmemBudget - stage) / 8 - 1;
}

// mode -1 picks by the shapes; 0 / 1 force partitioned / shared rows (for
// A/B timing; forcing shared rows that do not fit is refused).
int make_plan(long long n_rows, long long n_cols, long long n_trees,
              long long n_nodes, long long n_bins, long long n_stats,
              int mode, Plan* p) {
  if (n_cols <= 0 || n_trees <= 0 || n_nodes <= 0 || n_bins <= 0 ||
      n_bins > 65536 || n_stats <= 0 || n_rows < 0 || n_rows > INT_MAX)
    return cudaErrorInvalidValue;
  *p = Plan{};
  p->chunks = 1;
  const long long total = n_trees * n_nodes * n_cols * n_bins * n_stats;
  if (n_rows == 0) return cudaSuccess;

  // shared rows: the largest tree tile (>= 2 trees unless TB = 1) that
  // holds all K nodes for kWantCols columns
  const long long min_cols = n_cols < kWantCols ? n_cols : kWantCols;
  const long long least = n_trees < 2 ? n_trees : 2;
  for (long long tt = n_trees; mode != 0 && tt >= least; --tt) {
    const long long rows = stage_rows(tt, n_stats);
    const long long cells = hist_cells(tt, n_stats, rows);
    long long stride = tt * n_nodes * n_bins * n_stats;
    if ((stride & 1) == 0) stride += 1;
    if (cells > 0 && stride * min_cols <= cells) {
      p->shared = 1;
      p->tree_tile = tt;
      p->node_tile = n_nodes;
      p->bin_tile = n_bins;
      p->col_stride = stride;
      p->tile_rows = rows;
      const long long max_group = cells / stride;
      p->n_col_groups = cdiv(n_cols, max_group);
      p->col_group = cdiv(n_cols, p->n_col_groups);
      break;
    }
  }
  if (mode == 1 && !p->shared) return cudaErrorInvalidValue;
  if (!p->shared) {
    // partitioned rows: one tree a block; tile nodes until kWantCols
    // columns fit, then bins if one node's column does not
    p->tree_tile = 1;
    p->tile_rows = stage_rows(1, n_stats);
    const long long cells = hist_cells(1, n_stats, p->tile_rows);
    if (cells < 2 || n_stats + 1 > cells) return cudaErrorInvalidValue;
    const long long want = n_cols < kWantCols ? n_cols : kWantCols;
    long long node_tile = n_nodes, bin_tile = n_bins;
    if ((node_tile * bin_tile * n_stats + 1) * want > cells) {
      node_tile = (cells / want - 1) / (n_bins * n_stats);
      if (node_tile < 1) node_tile = 1;
      if (node_tile * bin_tile * n_stats + 1 > cells)
        bin_tile = (cells - 1) / n_stats;
    }
    p->n_node_tiles = cdiv(n_nodes, node_tile);
    p->node_tile = cdiv(n_nodes, p->n_node_tiles);      // balance the tiles
    p->n_bin_tiles = cdiv(n_bins, bin_tile);
    p->bin_tile = cdiv(n_bins, p->n_bin_tiles);
    long long stride = p->node_tile * p->bin_tile * n_stats;
    if ((stride & 1) == 0) stride += 1;
    p->col_stride = stride;
    const long long max_group = cells / stride;
    p->n_col_groups = cdiv(n_cols, max_group);
    p->col_group = cdiv(n_cols, p->n_col_groups);
  } else {
    p->n_node_tiles = p->n_bin_tiles = 1;
  }
  p->n_tree_tiles = cdiv(n_trees, p->tree_tile);
  const long long tiles = p->n_tree_tiles * p->n_node_tiles
                          * p->n_bin_tiles * p->n_col_groups;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long chunks = kTargetBlocks / tiles;
  const long long most = cdiv(n_rows, kMinRowsPerBlock);
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  if (p->shared) {
    p->rows_per_block = cdiv(n_rows, chunks);
    chunks = cdiv(n_rows, p->rows_per_block);
  }
  p->chunks = chunks;
  p->direct = chunks == 1;

  const long long tt = p->tree_tile;
  p->smem = (size_t)(8 * tt * n_stats                       // scales
                     + 8 * p->tile_rows * tt * n_stats       // quanta
                     + 8 * p->col_group * p->col_stride      // lo + hi
                     + 4 * tt * n_stats                      // exponents
                     + 4 * p->tile_rows                      // row ids
                     + 4 * p->tile_rows * tt);               // node ids
  size_t off = 0;
  p->ws_acc = off;
  if (!p->direct) off = align16(off + (size_t)total * 8);
  p->ws_off = off;
  p->ws_cur = off;
  p->ws_perm = off;
  if (!p->shared) {
    const size_t seg = align16((size_t)n_trees * (n_nodes + 1) * 4);
    p->ws_cur = p->ws_off + seg;
    p->ws_perm = p->ws_cur + seg;
    off = align16(p->ws_perm + (size_t)n_trees * n_rows * 4);
  }
  p->ws_bytes = off;
  return cudaSuccess;
}

// ---------------------------------------------------- row partition
__global__ void count_kernel(const int32_t* __restrict__ node_idx,
                             int* __restrict__ cnt, long long n_rows,
                             long long total, int n_nodes) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int k = __ldg(node_idx + i);
    if ((unsigned)k < (unsigned)n_nodes)
      atomicAdd(cnt + (i / n_rows) * (n_nodes + 1) + k, 1);
  }
}

// In-place exclusive scan of each tree's K + 1 counts (one block a tree).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ cnt, int n_nodes) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry_s;
  int* row = cnt + (size_t)blockIdx.x * (n_nodes + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int base = 0; base <= n_nodes; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i <= n_nodes ? row[i] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;                       // inclusive over warps
    }
    __syncthreads();
    const int carry = carry_s;
    const int incl = x + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i <= n_nodes) row[i] = carry + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry_s = carry + incl;
    __syncthreads();
  }
}

__global__ void scatter_kernel(const int32_t* __restrict__ node_idx,
                               int* __restrict__ cur, int* __restrict__ perm,
                               long long n_rows, long long total,
                               int n_nodes) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int k = __ldg(node_idx + i);
    if ((unsigned)k < (unsigned)n_nodes) {
      const long long t = i / n_rows;
      const int pos = atomicAdd(cur + t * (n_nodes + 1) + k, 1);
      perm[t * n_rows + pos] = (int)(i - t * n_rows);
    }
  }
}

// ------------------------------------------------------ accumulation
struct Args {
  const int32_t* node_idx;           // [TB, N]
  const float* stats;                // [TB, N, S]
  const float* amax;                 // [TB, S]
  const int* off;                    // [TB, K + 1] partitioned mode
  const int* perm;                   // [TB, N] partitioned mode
  unsigned long long* acc;           // [TB, K, C, B, S] unless direct
  float* out;                        // [TB, K, C, B, S]
  long long n_rows;
  int n_cols, n_trees, n_nodes, n_bins, n_stats;
  int shared, direct;
  int tree_tile, node_tile, bin_tile, col_group;
  int n_node_tiles, n_bin_tiles, n_col_groups, col_stride, tile_rows;
  long long chunks, rows_per_block;
};

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_batch_kernel(const BinT* __restrict__ bins, const Args a) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int S = a.n_stats;

  // this block's tile: column group, node tile, bin tile, tree tile
  long long x = blockIdx.x;
  const int cg = (int)(x % a.n_col_groups);
  x /= a.n_col_groups;
  const int nt = (int)(x % a.n_node_tiles);
  x /= a.n_node_tiles;
  const int bti = (int)(x % a.n_bin_tiles);
  const int tti = (int)(x / a.n_bin_tiles);
  const int c0 = cg * a.col_group;
  const int cols = min(a.col_group, a.n_cols - c0);
  const int k0 = nt * a.node_tile;
  const int kt = min(a.node_tile, a.n_nodes - k0);
  const int b0 = bti * a.bin_tile;
  const int bt = min(a.bin_tile, a.n_bins - b0);
  const int t0 = tti * a.tree_tile;
  const int tt = min(a.tree_tile, a.n_trees - t0);
  if (cols <= 0 || kt <= 0 || bt <= 0 || tt <= 0) return;

  // this block's rows: a contiguous range (shared mode) or a chunk of the
  // node tile's segment of its tree's sorted rows (partitioned mode)
  long long r0, r1;
  if (a.shared) {
    r0 = (long long)blockIdx.y * a.rows_per_block;
    r1 = min(r0 + a.rows_per_block, a.n_rows);
  } else {
    const int* o = a.off + (size_t)t0 * (a.n_nodes + 1);
    const long long s0 = o[k0], s1 = o[k0 + kt];
    const long long per = (s1 - s0 + a.chunks - 1) / a.chunks;
    r0 = s0 + (long long)blockIdx.y * per;
    r1 = min(r0 + per, s1);
  }
  // a direct block writes every cell of its tile, rows or none
  if (r0 >= r1 && !a.direct) return;

  const int nq = a.tree_tile * S;
  double* scale = reinterpret_cast<double*>(smem);
  long long* tq = reinterpret_cast<long long*>(scale + nq);
  unsigned* hist_lo = reinterpret_cast<unsigned*>(
      tq + (size_t)a.tile_rows * nq);
  unsigned* hist_hi = hist_lo + (size_t)a.col_group * a.col_stride;
  int* exps = reinterpret_cast<int*>(hist_hi
                                     + (size_t)a.col_group * a.col_stride);
  int* trow = exps + nq;
  int* tk = trow + a.tile_rows;

  for (int i = threadIdx.x; i < tt * S; i += blockDim.x) {
    const float am = __ldg(a.amax + (size_t)t0 * S + i);
    const int e = channel_exp(am, a.n_rows);
    scale[i] = ldexp(1.0, e);
    exps[i] = isfinite(am) ? e : kNanExp;
  }
  const int slots = cols * a.col_stride;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    hist_lo[i] = 0u;
    hist_hi[i] = 0u;
  }
  __syncthreads();

  // (row, column) pairs: each thread keeps one column and strides over the
  // staged rows; neighbouring threads take neighbouring columns
  const int lanes = min(cols, kThreads);
  const int rows_per_pass = kThreads / lanes;
  const int row_slot = threadIdx.x / lanes;
  const size_t n_rows = (size_t)a.n_rows;

  for (long long i0 = r0; i0 < r1; i0 += a.tile_rows) {
    const int tr = (int)min((long long)a.tile_rows, r1 - i0);
    for (int v = threadIdx.x; v < tr; v += blockDim.x) {
      if (a.shared) {
        const long long row = i0 + v;
        trow[v] = (int)row;
        for (int t = 0; t < tt; ++t) {
          const size_t tn = (t0 + t) * n_rows + row;
          const int k = __ldg(a.node_idx + tn) - k0;
          const bool ok = (unsigned)k < (unsigned)kt;
          tk[v * a.tree_tile + t] = ok ? k : -1;
          if (ok)
            for (int s = 0; s < S; ++s)
              tq[((size_t)v * a.tree_tile + t) * S + s] = __double2ll_rn(
                  (double)__ldg(a.stats + tn * S + s) * scale[t * S + s]);
        }
      } else {
        const int row = __ldg(a.perm + t0 * n_rows + i0 + v);
        const size_t tn = t0 * n_rows + row;
        trow[v] = row;
        tk[v] = __ldg(a.node_idx + tn) - k0;    // in [0, kt) by the sort
        for (int s = 0; s < S; ++s)
          tq[(size_t)v * S + s] = __double2ll_rn(
              (double)__ldg(a.stats + tn * S + s) * scale[s]);
      }
    }
    __syncthreads();

    if (row_slot < rows_per_pass) {
      for (int c = threadIdx.x % lanes; c < cols; c += lanes) {
        const BinT* col = bins + c0 + c;
        for (int v0 = row_slot; v0 < tr; v0 += rows_per_pass * kUnroll) {
          int b[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int v = v0 + u * rows_per_pass;
            b[u] = v < tr
                ? (int)__ldg(col + (size_t)trow[v] * a.n_cols) - b0 : -1;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if ((unsigned)b[u] >= (unsigned)bt) continue;  // tail, other tile
            const int v = v0 + u * rows_per_pass;
            for (int t = 0; t < tt; ++t) {
              const int k = tk[v * a.tree_tile + t];
              if (k < 0) continue;
              const int cell = c * a.col_stride
                               + ((t * kt + k) * bt + b[u]) * S;
              const long long* q = tq + ((size_t)v * a.tree_tile + t) * S;
              for (int s = 0; s < S; ++s)
                if (q[s] != 0)
                  add_u64(hist_lo + cell + s, hist_hi + cell + s, q[s]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the block's cells out: for a fixed (tree, node, column) the bt * S
  // cells are contiguous in both layouts
  const int run = bt * S;
  const long long total = (long long)tt * kt * cols * run;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = (int)(i % run);
    long long rest = i / run;
    const int c = (int)(rest % cols);
    rest /= cols;
    const int k = (int)(rest % kt);
    const int t = (int)(rest / kt);
    const int cell = c * a.col_stride + (t * kt + k) * bt * S + j;
    const unsigned long long val =
        ((unsigned long long)hist_hi[cell] << 32) | hist_lo[cell];
    const size_t g =
        ((((size_t)(t0 + t) * a.n_nodes + (k0 + k)) * a.n_cols + (c0 + c))
             * a.n_bins + b0) * S + j;
    if (a.direct) {
      const int e = exps[t * S + j % S];
      a.out[g] = e == kNanExp ? __int_as_float(0x7fc00000)
                              : ldexpf(__ll2float_rn((long long)val), -e);
    } else if (val != 0ull) {
      atomicAdd(a.acc + g, val);
    }
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                const float* __restrict__ amax,
                                float* __restrict__ out, long long total,
                                long long per_tree, int n_stats,
                                long long n_rows) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const float a = __ldg(amax + (i / per_tree) * n_stats + i % n_stats);
    if (!isfinite(a)) {
      out[i] = __int_as_float(0x7fc00000);     // NaN: stats not finite
      continue;
    }
    out[i] = ldexpf(__ll2float_rn((long long)acc[i]),
                    -channel_exp(a, n_rows));
  }
}

unsigned grid_for(long long n, long long most) {
  long long blocks = cdiv(n, 256);
  if (blocks > most) blocks = most;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename BinT>
int launch(const void* bins, const void* node_idx, const void* stats,
           const void* amax, void* ws, long long ws_bytes, void* out,
           long long n_rows, int n_cols, int n_trees, int n_nodes,
           int n_bins, int n_stats, int mode, void* stream) {
  Plan p;
  int err0 = make_plan(n_rows, n_cols, n_trees, n_nodes, n_bins, n_stats,
                       mode, &p);
  if (err0 != cudaSuccess) return err0;
  if ((size_t)ws_bytes < p.ws_bytes) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total =
      (long long)n_trees * n_nodes * n_cols * n_bins * n_stats;
  if (n_rows == 0)
    return cudaMemsetAsync(out, 0, (size_t)total * 4, st);

  char* w = (char*)ws;
  Args a{};
  a.node_idx = (const int32_t*)node_idx;
  a.stats = (const float*)stats;
  a.amax = (const float*)amax;
  a.acc = (unsigned long long*)(w + p.ws_acc);
  a.off = (const int*)(w + p.ws_off);
  a.perm = (const int*)(w + p.ws_perm);
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.n_cols = n_cols;
  a.n_trees = n_trees;
  a.n_nodes = n_nodes;
  a.n_bins = n_bins;
  a.n_stats = n_stats;
  a.shared = p.shared;
  a.direct = p.direct;
  a.tree_tile = (int)p.tree_tile;
  a.node_tile = (int)p.node_tile;
  a.bin_tile = (int)p.bin_tile;
  a.col_group = (int)p.col_group;
  a.n_node_tiles = (int)p.n_node_tiles;
  a.n_bin_tiles = (int)p.n_bin_tiles;
  a.n_col_groups = (int)p.n_col_groups;
  a.col_stride = (int)p.col_stride;
  a.tile_rows = (int)p.tile_rows;
  a.chunks = p.chunks;
  a.rows_per_block = p.rows_per_block;

  cudaError_t err;
  if (!p.direct) {
    err = cudaMemsetAsync(a.acc, 0, (size_t)total * 8, st);
    if (err != cudaSuccess) return err;
  }
  if (!p.shared) {
    const long long cells = (long long)n_trees * n_rows;
    int* off = (int*)(w + p.ws_off);
    int* cur = (int*)(w + p.ws_cur);
    const size_t seg = (size_t)n_trees * (n_nodes + 1) * 4;
    err = cudaMemsetAsync(off, 0, seg, st);
    if (err != cudaSuccess) return err;
    count_kernel<<<grid_for(cells, 8192), 256, 0, st>>>(
        a.node_idx, off, n_rows, cells, n_nodes);
    scan_kernel<<<n_trees, kScanThreads, 0, st>>>(off, n_nodes);
    err = cudaMemcpyAsync(cur, off, seg, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return err;
    scatter_kernel<<<grid_for(cells, 8192), 256, 0, st>>>(
        a.node_idx, cur, (int*)(w + p.ws_perm), n_rows, cells, n_nodes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hist_batch_kernel<BinT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = p.n_tree_tiles * p.n_node_tiles * p.n_bin_tiles
                          * p.n_col_groups;
  dim3 grid((unsigned)tiles, (unsigned)p.chunks);
  hist_batch_kernel<BinT><<<grid, kThreads, p.smem, st>>>(
      (const BinT*)bins, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!p.direct) {
    finalize_kernel<<<grid_for(total, 8192), 256, 0, st>>>(
        a.acc, a.amax, a.out, total, total / n_trees, n_stats, n_rows);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Bytes of device scratch one launch at these shapes needs (0 if none), in
// *bytes; returns a cudaError_t (0 = the shapes are supported).  `mode` as
// for make_plan, here and below.
extern "C" int shifu_hist_batch_workspace(long long n_rows, int n_cols,
                                          int n_trees, int n_nodes,
                                          int n_bins, int n_stats, int mode,
                                          long long* bytes) {
  Plan p;
  const int err = make_plan(n_rows, n_cols, n_trees, n_nodes, n_bins,
                            n_stats, mode, &p);
  *bytes = err == cudaSuccess ? (long long)p.ws_bytes : 0;
  return err;
}

// How a launch at these shapes is tiled, for the smoke's log: writes
// {shared, tree_tile, node_tile, bin_tile, col_group, chunks, direct,
// smem} into plan[8].
extern "C" int shifu_hist_batch_plan(long long n_rows, int n_cols,
                                     int n_trees, int n_nodes, int n_bins,
                                     int n_stats, int mode,
                                     long long* plan) {
  Plan p;
  const int err = make_plan(n_rows, n_cols, n_trees, n_nodes, n_bins,
                            n_stats, mode, &p);
  const long long v[8] = {p.shared, p.tree_tile, p.node_tile, p.bin_tile,
                          p.col_group, p.chunks, p.direct,
                          (long long)p.smem};
  for (int i = 0; i < 8; ++i) plan[i] = err == cudaSuccess ? v[i] : 0;
  return err;
}

// Launch on `stream`; returns a cudaError_t (0 = launched).  `bin_bytes` is
// the width of a bin id: 1 (uint8 planes, <= 256 bins) or 4 (int32).
// `amax` [TB, S] holds max_n |stats[t, n, s]|; `ws` is at least
// shifu_hist_batch_workspace bytes of scratch; `out` is [TB, K, C, B, S]
// f32.  All contiguous.
extern "C" int shifu_hist_batch(const void* bins, int bin_bytes,
                                const void* node_idx, const void* stats,
                                const void* amax, void* ws,
                                long long ws_bytes, void* out,
                                long long n_rows, int n_cols, int n_trees,
                                int n_nodes, int n_bins, int n_stats,
                                int mode, void* stream) {
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, node_idx, stats, amax, ws, ws_bytes, out,
                           n_rows, n_cols, n_trees, n_nodes, n_bins, n_stats,
                           mode, stream);
  if (bin_bytes == 4)
    return launch<int32_t>(bins, node_idx, stats, amax, ws, ws_bytes, out,
                           n_rows, n_cols, n_trees, n_nodes, n_bins, n_stats,
                           mode, stream);
  return cudaErrorInvalidValue;
}

// (tree, node, feature, bin) histograms of per-row stat channels — the
// Hopper port of two Pallas kernels of shifu_tpu/ops/hist_pallas.py:
// _hist_kernel (B1, launched from build_histograms_pallas) and its
// tree-batched form _hist_kernel_batch (B2, from
// build_histograms_pallas_batch).  One source serves both: B1 is a launch
// with TB = 1.  Built by shifu_tpu_torch/ops/cuda_lib.py with
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
// Determinism.  Every sum is an integer sum, so neither the tiling nor the
// order in which atomics land can move a bit, and tree t's slice is the
// same whatever TB it was launched with.  Channel (t, s) takes one of two
// exact forms, chosen on the device from flags the wrapper computes
// there (the host never syncs on them):
// * 64-bit fixed point.  The channel is scaled by 2^e, e from
//   amax = max_n |stats[t, n, s]| and N (fixed_point.cuh::channel_exp),
//   so amax * N * 2^e < 2^62; each row's quantum q = rint(v * 2^e) then
//   sums without reaching 2^63.  A shared cell is two 32-bit words with
//   an explicit carry (add_u64: two native shared atomics, the first
//   returning).  The result is rint_f32(sum) * 2^-e.
// * 32-bit integers, when every value of the channel is an integer and
//   amax * N < 2^31 (exact[t, s] != 0): every partial sum fits an int32,
//   and a cell takes one native, non-returning shared atomic a row.  The
//   result is rint_f32(sum v), which is the 64-bit form's bits: e >= 31
//   there, so each q = v * 2^e exactly, sum q = 2^e * sum v exactly, and
//   rint_f32(2^e * x) * 2^-e = rint_f32(x) for an integer x, since
//   scaling by a power of two commutes with rounding when nothing
//   overflows or underflows (|x| * 2^e < 2^62).  Where blocks must add
//   into a global 64-bit accumulator, such a cell goes in as x * 2^e, the
//   64-bit form's value.
// Non-finite stats make their whole channel NaN.
//
// What bounds it on an H100, and what the design does about it.  The
// floor is bytes: the bins of the live rows once (268 MB at N = 2^20,
// C = 256, uint8), the node ids and live stats once, the [TB, K, C, B, S]
// f32 output once (4.3 GB at TB = 8, K = 4096).  Measured on the
// kernels this design replaced, one source each for B1 and B2
// (`chip_smoke.py --hist-of` on their checkout: they skip their shared
// adds on all-zero stats), the adds took only 4-18% of a launch: the rest
// was latency — one bin byte a thread a load, few loads in flight, a
// chain of dependent loads to stage each row tile — plus, in the batched
// one, a partition whose every row hit one global counter at K = 1 (18.7
// ms when forced to partitioned rows, against 10.6 for its shared-rows
// layout), and, in the single-tree one, node tiles that each re-read
// every node id (62.5 ms at K = 4096).  So:
// * Rows are partitioned by node first (three small kernels: count, a
//   per-tree exclusive scan, scatter into perm), so a block walks only
//   its node tile's rows and each node id is read a constant number of
//   times a level, whatever K is.  Rows whose stats are all zero (out of
//   the bag, validation rows) contribute nothing and are dropped here.
//   Count and scatter aggregate a warp's lanes on the same node
//   (__match_any_sync: one atomic per distinct node a warp), and for
//   K < 8192 a block's lanes in shared memory first, so K = 1 does not
//   serialise every row of a tree on one global counter.
// * One tree a block, a warp a row: its lanes take neighbouring columns,
//   V bin ids a lane in one vector load (V = 2 for 256 uint8 columns of
//   64 bins: 64 bytes a warp a row), four rows' loads in flight a warp,
//   16 warps a block, two blocks an SM.  Rows are gathered through perm,
//   which TMA cannot do; with 32 warps an SM keeping 128 row loads in
//   flight, staging them with cp.async would add a copy and a barrier for
//   little (chip_smoke.py::time_parts: the row walk is 28% of a launch at
//   K = 1, the adds 48%).
// * The sub-histogram keeps lane l's columns in bank l: word
//   ((plane * cells + cell) * V + j) * 32 + l for column l * V + j, so a
//   warp's 32 adds for one row never share a bank, whatever the bins
//   (an odd column stride spreads 32 columns over 32 banks only when
//   their bins agree).  A row's adds go channel by channel over its
//   group of four rows, a 64-bit channel's returning low-word atomics all
//   issued before their carries.
// * One block per output tile (the deep levels) writes f32 straight to
//   `out`: a warp reads 32 cells of its lanes' 32 columns (again one bank
//   a lane), transposes the 32 x 32 block in registers and writes each
//   column's 32 cells as one 128-byte run.  Otherwise blocks add their
//   cells into a 64-bit global accumulator that a last kernel converts.
// * A launch picks its tiling from the shapes alone (make_plan), so the
//   workspace query and the launch agree.  Cells are sized for the 64-bit
//   form (the flags live on the device); a 32-bit channel leaves its high
//   words at zero.  A layout that shares one bin read among a tile of
//   trees lost to this one on an H100 at K = 1, the only K where it fits
//   (TB = 8 and TB = 1), so there is none.
// Production runs every launch to its end (shifu_hist).  On a mesh, where
// each rank holds a block of the rows (shifu_tpu_torch/ops/hist.py,
// build_histograms_sharded), a launch stops before the rounding instead
// (shifu_hist_raw): it writes every cell's 64-bit fixed-point sum, at the
// scale of a channel amax and a row count that the caller reduced over the
// ranks (device values), into an int64 [TB, K, C, B, S] buffer.  The
// caller sums those buffers over the ranks, exactly, and shifu_hist_flush
// rounds each cell to f32 once, as the last kernel of a single launch
// does; a 32-bit channel's cell is the 64-bit form's value there too.
// So the sharded result has the bits of one launch over all the rows.
// A second entry point, shifu_hist_until, stops a launch after its set-up, its row walk or
// its adds, through kernel instantiations of their own, so a timing run can
// split a launch's time by part without a branch in the production kernel.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 512;                 // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                    // rows' bin loads in flight
constexpr int kSmemBudget = 100 * 1024;       // two blocks per SM
constexpr int kTileRows = kThreads;           // rows staged at once
constexpr int kTargetBlocks = 528;            // two waves of two a SM
constexpr long long kMinRowsPerBlock = 1024;
constexpr int kNanExp = INT_MIN;              // channel not finite
constexpr int kScanThreads = 1024;
constexpr int kPartThreads = 256;
constexpr long long kPartRows = 4096;         // rows a partition block takes
constexpr int kMaxSmemKeys = 8192;            // nodes counted in shared memory

// the last part a launch runs: all of them in production; a timing launch
// (shifu_hist_until) stops after the partition and block set-up, the row
// walk (staging, bin loads) or the adds
constexpr int kSetup = 0, kWalk = 1, kAdds = 2, kAll = 3;

using shifu::add_u64;
using shifu::channel_exp;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// How one launch tiles its work; a pure function of the shapes.
struct Plan {
  int vec;                           // bin ids a lane loads at once (V)
  long long node_tile, n_node_tiles;
  long long bin_tile, n_bin_tiles;
  long long col_group, n_col_groups; // 32 * V columns a block
  long long chunks;                  // row chunks of a tile (grid y)
  int direct;                        // one chunk: blocks write f32
  int smem_keys;                     // partition counts in shared memory
  size_t smem;
  size_t ws_acc, ws_off, ws_cur, ws_perm, ws_bytes;
};

// shared memory of a block: the sub-histogram (two planes of S channels x
// cells x V x 32 words), then the staged rows' quanta, the channels'
// scales, exponents and flags, the rows and their first cells
size_t smem_bytes(long long S, long long cells, long long v) {
  return (size_t)(4 * 2 * S * cells * v * 32 + 8 * kTileRows * S + 16 * S
                  + 8 * kTileRows);
}

bool vec_ok(long long v, long long n_cols, int bin_bytes) {
  if (v == 1) return true;
  return bin_bytes == 1 && n_cols % v == 0 && n_cols >= 32 * v;
}

// raw: the launch writes 64-bit cells to a caller's buffer (never direct)
int make_plan(long long n_rows, long long n_cols, long long n_trees,
              long long n_nodes, long long n_bins, long long n_stats,
              int bin_bytes, int raw, Plan* p) {
  if (n_cols <= 0 || n_trees <= 0 || n_nodes <= 0 || n_bins <= 0 ||
      n_bins > 65536 || n_stats <= 0 || n_rows < 0 || n_rows > INT_MAX ||
      n_trees > 65535 || (bin_bytes != 1 && bin_bytes != 4))
    return cudaErrorInvalidValue;
  *p = Plan{};
  p->chunks = 1;
  if (n_rows == 0) return cudaSuccess;
  const long long S = n_stats;
  // one tree a block: the widest V whose block holds one node's bins, then
  // as many nodes as fit; else bins tiled at V = 1
  const long long vecs[3] = {4, 2, 1};
  p->vec = 1;
  for (int i = 0; i < 3; ++i)
    if (vec_ok(vecs[i], n_cols, bin_bytes) &&
        smem_bytes(S, n_bins, vecs[i]) <= kSmemBudget) {
      p->vec = (int)vecs[i];
      break;
    }
  const long long per_cell = 4 * 2 * S * p->vec * 32;
  const long long room = kSmemBudget - (long long)smem_bytes(S, 0, 1);
  if (room < per_cell) return cudaErrorInvalidValue;
  long long node_tile = room / (per_cell * n_bins), bin_tile = n_bins;
  if (node_tile < 1) {
    node_tile = 1;
    bin_tile = room / per_cell;
  }
  if (node_tile > n_nodes) node_tile = n_nodes;
  p->n_node_tiles = cdiv(n_nodes, node_tile);
  p->node_tile = cdiv(n_nodes, p->n_node_tiles);        // balance the tiles
  p->n_bin_tiles = cdiv(n_bins, bin_tile);
  p->bin_tile = cdiv(n_bins, p->n_bin_tiles);
  p->smem_keys = n_nodes < kMaxSmemKeys;
  p->col_group = 32 * p->vec;
  p->n_col_groups = cdiv(n_cols, p->col_group);
  const long long tiles = n_trees * p->n_node_tiles * p->n_bin_tiles
                          * p->n_col_groups;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long chunks = kTargetBlocks / tiles;
  const long long most = cdiv(n_rows, kMinRowsPerBlock);
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  p->chunks = chunks;
  p->direct = chunks == 1 && !raw;
  p->smem = smem_bytes(S, p->node_tile * p->bin_tile, p->vec);

  const long long total = n_trees * n_nodes * n_cols * n_bins * S;
  size_t off = 0;
  p->ws_acc = off;
  if (!p->direct && !raw) off = align16(off + (size_t)total * 8);
  const size_t seg = align16((size_t)n_trees * (n_nodes + 1) * 4);
  p->ws_off = off;
  p->ws_cur = p->ws_off + seg;
  p->ws_perm = p->ws_cur + seg;
  p->ws_bytes = align16(p->ws_perm + (size_t)n_trees * n_rows * 4);
  return cudaSuccess;
}

// ---------------------------------------------------- row partition
// Row n of tree t is live at this level when its node id is in [0, K) and
// one of its stats is not zero (a zero row adds nothing to any cell).
__device__ __forceinline__ int live_node(const int32_t* __restrict__ node_idx,
                                         const float* __restrict__ stats,
                                         size_t tn, int n_nodes,
                                         int n_stats) {
  const int k = __ldg(node_idx + tn);
  if ((unsigned)k >= (unsigned)n_nodes) return -1;
  for (int s = 0; s < n_stats; ++s)
    if (__ldg(stats + tn * n_stats + s) != 0.0f) return k;
  return -1;
}

// Counts (kScatter = false) or scatters (true) the live rows of tree
// blockIdx.y in rows [r0, r1) by node.  `glob` is the tree's [K + 1]
// counts, or its cursors (the exclusive scan of the counts) when
// scattering.  With kSmemKeys the block first counts in shared memory and
// touches each global counter once; either way a warp's lanes on one node
// share one atomic (__match_any_sync), the leader's old value plus each
// lane's rank among its peers giving the lane's slot.
template <bool kSmemKeys, bool kScatter>
__global__ void __launch_bounds__(kPartThreads)
partition_kernel(const int32_t* __restrict__ node_idx,
                 const float* __restrict__ stats, int* __restrict__ counts,
                 int* __restrict__ perm, long long n_rows, int n_nodes,
                 int n_stats) {
  extern __shared__ int keys[];
  const int t = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * kPartRows;
  const long long r1 = r0 + kPartRows < n_rows ? r0 + kPartRows : n_rows;
  int* glob = counts + (size_t)t * (n_nodes + 1);
  const size_t tbase = (size_t)t * n_rows;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (kSmemKeys) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) keys[i] = 0;
    __syncthreads();
    for (long long b = r0; b < r1; b += blockDim.x) {
      const long long r = b + threadIdx.x;
      const int k = r < r1 ? live_node(node_idx, stats, tbase + r, n_nodes,
                                       n_stats) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      if (k >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(keys + k, __popc(peers));
    }
    __syncthreads();
    // the block's counts out; when scattering, each becomes the block's
    // first slot of its node
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
      const int c = keys[i];
      if (c == 0) continue;
      if (kScatter)
        keys[i] = atomicAdd(glob + i, c);
      else
        atomicAdd(glob + i, c);
    }
    if (!kScatter) return;
    __syncthreads();
  }
  for (long long b = r0; b < r1; b += blockDim.x) {
    const long long r = b + threadIdx.x;
    const int k = r < r1 ? live_node(node_idx, stats, tbase + r, n_nodes,
                                     n_stats) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (k >= 0 && lane == leader)
      slot = atomicAdd(kSmemKeys ? keys + k : glob + k, __popc(peers));
    if (!kScatter) continue;
    slot = __shfl_sync(0xffffffffu, slot, leader);
    if (k >= 0) perm[tbase + slot + __popc(peers & below)] = (int)r;
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

// ------------------------------------------------------ accumulation
struct Args {
  const int32_t* node_idx;           // [TB, N]
  const float* stats;                // [TB, N, S]
  const float* amax;                 // [TB, S]
  const int32_t* exact;              // [TB, S] 32-bit integer channels
  const int* off;                    // [TB, K + 1] segment starts
  const int* perm;                   // [TB, N] rows sorted by node
  unsigned long long* acc;           // [TB, K, C, B, S] unless direct
  float* out;                        // [TB, K, C, B, S]
  const long long* n_scale;          // [1] rows of the scale, or null: N
  long long n_rows;
  int n_cols, n_trees, n_nodes, n_bins, n_stats;
  int direct;
  int node_tile, bin_tile, col_group;
  int n_node_tiles, n_bin_tiles, n_col_groups;
  long long chunks;
};

// V bin ids of one row a lane loads at once
template <typename BinT, int V> struct Lanes;
template <> struct Lanes<uint8_t, 1> {
  using T = unsigned char;
  static __device__ __forceinline__ int at(T x, int) { return x; }
};
template <> struct Lanes<uint8_t, 2> {
  using T = unsigned short;
  static __device__ __forceinline__ int at(T x, int j) {
    return (x >> (8 * j)) & 0xff;
  }
};
template <> struct Lanes<uint8_t, 4> {
  using T = unsigned int;
  static __device__ __forceinline__ int at(T x, int j) {
    return (x >> (8 * j)) & 0xff;
  }
};
template <> struct Lanes<int32_t, 1> {
  using T = int;
  static __device__ __forceinline__ int at(T x, int) { return x; }
};

// A warp's 32 x 32 block in registers, row l in lane l, transposed in
// place (five rounds of exchanging off-diagonal halves with lane l ^ k):
// afterwards lane l holds column l.
__device__ __forceinline__ void transpose32(float (&v)[32], int lane) {
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1) {
    const bool upper = lane & k;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (e & k) continue;
      const float send = upper ? v[e] : v[e + k];
      const float recv = __shfl_xor_sync(0xffffffffu, send, k);
      if (upper)
        v[e] = recv;
      else
        v[e + k] = recv;
    }
  }
}

// One cell of the sub-histogram as f32 (direct blocks) or as the 64-bit
// form's value (for the global accumulator).
__device__ __forceinline__ float cell_f32(const unsigned* w, size_t hi_off,
                                          int ex, int e) {
  if (ex) return __int2float_rn((int)w[0]);
  if (e == kNanExp) return __int_as_float(0x7fc00000);  // not finite
  return ldexpf(__ll2float_rn((long long)(
                    ((unsigned long long)w[hi_off] << 32) | w[0])), -e);
}

// kTimed: a timing instantiation, which stops after part `until`; the
// production one always runs to its end
template <typename BinT, int V, bool kTimed>
__global__ void __launch_bounds__(kThreads, 2)
hist_accum_kernel(const BinT* __restrict__ bins, const Args a, int until) {
  using VT = typename Lanes<BinT, V>::T;
  const int stop = kTimed ? until : kAll;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.n_stats;

  // this block's tile: column group, node tile, bin tile, tree
  long long x = blockIdx.x;
  const int cg = (int)(x % a.n_col_groups);
  x /= a.n_col_groups;
  const int nt = (int)(x % a.n_node_tiles);
  x /= a.n_node_tiles;
  const int bti = (int)(x % a.n_bin_tiles);
  const int t0 = (int)(x / a.n_bin_tiles);
  const int c0 = cg * a.col_group;
  const int cols = min(a.col_group, a.n_cols - c0);
  const int k0 = nt * a.node_tile;
  const int kt = min(a.node_tile, a.n_nodes - k0);
  const int b0 = bti * a.bin_tile;
  const int bt = min(a.bin_tile, a.n_bins - b0);
  if (cols <= 0 || kt <= 0 || bt <= 0) return;
  const size_t N = (size_t)a.n_rows;

  // this block's rows: a chunk of the node tile's segment of its tree's
  // rows sorted by node
  const int* o = a.off + (size_t)t0 * (a.n_nodes + 1);
  const long long s0 = o[k0], s1 = o[k0 + kt];
  const long long per = (s1 - s0 + a.chunks - 1) / a.chunks;
  const long long r0 = s0 + (long long)blockIdx.y * per;
  const long long r1 = min(r0 + per, s1);
  // a direct block writes every cell of its tile, rows or none
  if (r0 >= r1 && !a.direct) return;

  const size_t plane = (size_t)kt * bt * V * 32;    // words of one channel
  const size_t hi_off = (size_t)S * plane;
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  long long* tq = reinterpret_cast<long long*>(
      hist + 2 * (size_t)S * a.node_tile * a.bin_tile * V * 32);
  double* scale = reinterpret_cast<double*>(tq + (size_t)kTileRows * S);
  int* exps = reinterpret_cast<int*>(scale + S);
  int* exf = exps + S;
  int* trow = exf + S;
  int* tcell = trow + kTileRows;

  const long long n_scale = a.n_scale ? __ldg(a.n_scale) : a.n_rows;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const float am = __ldg(a.amax + (size_t)t0 * S + s);
    const int ex = __ldg(a.exact + (size_t)t0 * S + s) != 0;
    const int e = channel_exp(am, n_scale);
    scale[s] = ex ? 1.0 : ldexp(1.0, e);
    exps[s] = isfinite(am) ? e : kNanExp;
    exf[s] = ex;
  }
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  for (size_t i = threadIdx.x; i < hi_off / 2; i += kThreads)
    h4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = lane * V;                     // this lane's first column
  const bool lane_on = cl < cols;
  const BinT* lane_bins = bins + c0 + cl;
  unsigned sink = 0;
  for (long long i0 = r0; stop >= kWalk && i0 < r1; i0 += kTileRows) {
    // stage the tile's rows: row id, first cell of its node, quanta
    const int tr = (int)min((long long)kTileRows, r1 - i0);
    for (int v = threadIdx.x; v < tr; v += kThreads) {
      const int row = __ldg(a.perm + t0 * N + i0 + v);
      const size_t tn = t0 * N + row;
      trow[v] = row;
      tcell[v] = kt > 1 ? (__ldg(a.node_idx + tn) - k0) * bt : 0;
      for (int s = 0; s < S; ++s)
        tq[(size_t)v * S + s] = __double2ll_rn(
            (double)__ldg(a.stats + tn * S + s) * scale[s]);
    }
    __syncthreads();

    // a warp a row, kUnroll rows' loads in flight, then their adds: a
    // channel's low words of every row first, so a 64-bit channel's
    // returning atomics overlap before their carries go in
    for (int v0 = warp; v0 < tr; v0 += kWarps * kUnroll) {
      VT xv[kUnroll];
      int cb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kWarps;
        const bool live = v < tr;
        xv[u] = live && lane_on
            ? __ldg(reinterpret_cast<const VT*>(
                  lane_bins + (size_t)trow[v] * a.n_cols))
            : VT(0);
        cb[u] = live ? tcell[v] : -1;
      }
      if (kTimed && stop < kAdds) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) sink += (unsigned)xv[u];
        continue;
      }
      for (int s = 0; s < S; ++s) {
        long long q[kUnroll];
        int wo[kUnroll][V];                    // word of each add, or -1
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          q[u] = cb[u] < 0 ? 0 : tq[(size_t)(v0 + u * kWarps) * S + s];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int b = Lanes<BinT, V>::at(xv[u], j) - b0;
            wo[u][j] = q[u] != 0 && lane_on && (unsigned)b < (unsigned)bt
                ? (int)(s * plane) + ((cb[u] + b) * V + j) * 32 + lane
                : -1;
          }
        }
        if (exf[s]) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (wo[u][j] >= 0)                 // int32, two's complement
                atomicAdd(hist + wo[u][j], (unsigned)q[u]);
        } else {
          unsigned old[kUnroll][V];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < V; ++j)
              old[u][j] = wo[u][j] >= 0
                  ? atomicAdd(hist + wo[u][j], (unsigned)q[u]) : 0u;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (wo[u][j] >= 0) {
                const unsigned ql = (unsigned)q[u];
                atomicAdd(hist + wo[u][j] + hi_off,
                          (unsigned)(q[u] >> 32)
                          + (old[u][j] + ql < old[u][j] ? 1u : 0u));
              }
        }
      }
    }
    __syncthreads();
  }
  if (kTimed) {
    if (sink == 0x9e3779b9u) hist[threadIdx.x] ^= 1u;  // keeps timed loads
    if (stop < kAll) return;
  }
  __syncthreads();

  // the block's cells out; for a fixed (node, column) the bt * S cells
  // are contiguous in `out`
  const int run = bt * S;
  const size_t col_stride = (size_t)a.n_bins * S;
  const size_t tile0 =
      (((size_t)t0 * a.n_nodes + k0) * a.n_cols + c0) * col_stride
      + (size_t)b0 * S;
  if (a.direct && run % 32 == 0) {
    // a warp reads 32 cells of its 32 lanes' columns (one bank a lane),
    // transposes them and writes each column's 32 cells as one
    // coalesced 128-byte run
    const int p32s = run / 32;
    for (int unit = warp; unit < kt * V * p32s; unit += kWarps) {
      const int p32 = unit % p32s;
      const int j = (unit / p32s) % V;
      const int k = unit / p32s / V;
      float val[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int idx = p32 * 32 + e;
        const int b = idx / S, s = idx - b * S;
        val[e] = cell_f32(hist + s * plane + ((k * bt + b) * V + j) * 32
                          + lane, hi_off, exf[s], exps[s]);
      }
      transpose32(val, lane);
      float* dst = a.out + tile0 + (size_t)k * a.n_cols * col_stride
                   + (size_t)j * col_stride + p32 * 32 + lane;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c * V + j < cols) dst[(size_t)c * V * col_stride] = val[c];
    }
    return;
  }
  // otherwise lane-fastest, four cells at a time where they are aligned
  const int W = run % 4 == 0 && col_stride % 4 == 0 && (b0 * S) % 4 == 0
                ? 4 : 1;
  const int P = run / W;
  const long long items = (long long)kt * P * V * 32;
  for (long long i = threadIdx.x; i < items; i += kThreads) {
    const int ln = (int)(i % 32);
    long long r = i / 32;
    const int j = (int)(r % V);
    r /= V;
    const int p = (int)(r % P);
    const int k = (int)(r / P);
    const int c = ln * V + j;
    if (c >= cols) continue;
    const size_t g = tile0 + ((size_t)k * a.n_cols + c) * col_stride
                     + (size_t)p * W;
    float f[4];
    for (int e = 0; e < W; ++e) {
      const int idx = p * W + e;
      const int b = idx / S, s = idx % S;
      const unsigned* w = hist + s * plane + ((k * bt + b) * V + j) * 32
                          + ln;
      if (a.direct) {
        f[e] = cell_f32(w, hi_off, exf[s], exps[s]);
        continue;
      }
      const long long val = exf[s]
          ? (long long)(int)w[0] * (1LL << exps[s])   // the 64-bit form
          : (long long)(((unsigned long long)w[hi_off] << 32) | w[0]);
      if (val != 0) atomicAdd(a.acc + g + e, (unsigned long long)val);
    }
    if (!a.direct) continue;
    if (W == 4)
      *reinterpret_cast<float4*>(a.out + g) =
          make_float4(f[0], f[1], f[2], f[3]);
    else
      a.out[g] = f[0];
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                const float* __restrict__ amax,
                                float* __restrict__ out, long long total,
                                long long per_tree, int n_stats,
                                long long n_rows,
                                const long long* __restrict__ n_scale) {
  if (n_scale) n_rows = __ldg(n_scale);
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

template <typename BinT, int V, bool kTimed>
cudaError_t launch_accum(const void* bins, const Plan& p, const Args& a,
                         int stop, cudaStream_t st) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_accum_kernel<BinT, V, kTimed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)a.n_trees * p.n_node_tiles
                          * p.n_bin_tiles * p.n_col_groups;
  dim3 grid((unsigned)tiles, (unsigned)p.chunks);
  hist_accum_kernel<BinT, V, kTimed><<<grid, kThreads, p.smem, st>>>(
      (const BinT*)bins, a, stop);
  return cudaGetLastError();
}

template <bool kTimed>
cudaError_t accumulate(const void* bins, int bin_bytes, const Plan& p,
                       const Args& a, int stop, cudaStream_t st) {
  if (bin_bytes == 4)
    return launch_accum<int32_t, 1, kTimed>(bins, p, a, stop, st);
  if (p.vec == 4)
    return launch_accum<uint8_t, 4, kTimed>(bins, p, a, stop, st);
  if (p.vec == 2)
    return launch_accum<uint8_t, 2, kTimed>(bins, p, a, stop, st);
  return launch_accum<uint8_t, 1, kTimed>(bins, p, a, stop, st);
}

template <bool kSmemKeys>
cudaError_t partition(const Args& a, int* off, int* cur, int* perm,
                      size_t seg, cudaStream_t st) {
  dim3 grid((unsigned)cdiv(a.n_rows, kPartRows), (unsigned)a.n_trees);
  const size_t keys = kSmemKeys ? (size_t)a.n_nodes * 4 : 0;
  partition_kernel<kSmemKeys, false><<<grid, kPartThreads, keys, st>>>(
      a.node_idx, a.stats, off, nullptr, a.n_rows, a.n_nodes, a.n_stats);
  scan_kernel<<<(unsigned)a.n_trees, kScanThreads, 0, st>>>(off, a.n_nodes);
  cudaError_t err = cudaMemcpyAsync(cur, off, seg, cudaMemcpyDeviceToDevice,
                                    st);
  if (err != cudaSuccess) return err;
  partition_kernel<kSmemKeys, true><<<grid, kPartThreads, keys, st>>>(
      a.node_idx, a.stats, cur, perm, a.n_rows, a.n_nodes, a.n_stats);
  return cudaGetLastError();
}

// raw: `raw_out` receives the 64-bit cells at the scale of `n_scale`
// (device [1]) and nothing is rounded; otherwise `out` gets f32 and
// `n_scale` may be null (the scale of n_rows)
int launch(const void* bins, int bin_bytes, const void* node_idx,
           const void* stats, const void* amax, const void* exact, void* ws,
           long long ws_bytes, void* out, long long n_rows, int n_cols,
           int n_trees, int n_nodes, int n_bins, int n_stats, int stop,
           int raw, const long long* n_scale, void* raw_out, void* stream) {
  Plan p;
  const int err0 = make_plan(n_rows, n_cols, n_trees, n_nodes, n_bins,
                             n_stats, bin_bytes, raw, &p);
  if (err0 != cudaSuccess) return err0;
  if ((size_t)ws_bytes < p.ws_bytes || stop < kSetup || stop > kAll ||
      (raw && (stop != kAll || !n_scale || !raw_out)))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total =
      (long long)n_trees * n_nodes * n_cols * n_bins * n_stats;
  if (n_rows == 0)
    return raw ? cudaMemsetAsync(raw_out, 0, (size_t)total * 8, st)
               : cudaMemsetAsync(out, 0, (size_t)total * 4, st);

  char* w = (char*)ws;
  Args a{};
  a.node_idx = (const int32_t*)node_idx;
  a.stats = (const float*)stats;
  a.amax = (const float*)amax;
  a.exact = (const int32_t*)exact;
  a.acc = raw ? (unsigned long long*)raw_out
              : (unsigned long long*)(w + p.ws_acc);
  a.n_scale = n_scale;
  a.off = (const int*)(w + p.ws_off);
  a.perm = (const int*)(w + p.ws_perm);
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.n_cols = n_cols;
  a.n_trees = n_trees;
  a.n_nodes = n_nodes;
  a.n_bins = n_bins;
  a.n_stats = n_stats;
  a.direct = p.direct;
  a.node_tile = (int)p.node_tile;
  a.bin_tile = (int)p.bin_tile;
  a.col_group = (int)p.col_group;
  a.n_node_tiles = (int)p.n_node_tiles;
  a.n_bin_tiles = (int)p.n_bin_tiles;
  a.n_col_groups = (int)p.n_col_groups;
  a.chunks = p.chunks;

  cudaError_t err;
  const bool flush = stop == kAll;
  if (!p.direct && flush) {
    err = cudaMemsetAsync(a.acc, 0, (size_t)total * 8, st);
    if (err != cudaSuccess) return err;
  }
  int* off = (int*)(w + p.ws_off);
  const size_t seg = (size_t)n_trees * (n_nodes + 1) * 4;
  err = cudaMemsetAsync(off, 0, seg, st);
  if (err != cudaSuccess) return err;
  int* cur = (int*)(w + p.ws_cur);
  int* perm = (int*)(w + p.ws_perm);
  err = p.smem_keys ? partition<true>(a, off, cur, perm, seg, st)
                    : partition<false>(a, off, cur, perm, seg, st);
  if (err != cudaSuccess) return err;
  err = flush ? accumulate<false>(bins, bin_bytes, p, a, stop, st)
              : accumulate<true>(bins, bin_bytes, p, a, stop, st);
  if (err != cudaSuccess) return err;
  if (!p.direct && flush && !raw) {
    finalize_kernel<<<grid_for(total, 8192), 256, 0, st>>>(
        a.acc, a.amax, a.out, total, total / n_trees, n_stats, n_rows,
        n_scale);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Bytes of device scratch one launch at these shapes needs (0 if none), in
// *bytes, for shifu_hist (raw = 0) or shifu_hist_raw (raw = 1); returns a
// cudaError_t (0 = the shapes are supported).
extern "C" int shifu_hist_workspace(long long n_rows, int n_cols,
                                    int n_trees, int n_nodes, int n_bins,
                                    int n_stats, int bin_bytes, int raw,
                                    long long* bytes) {
  Plan p;
  const int err = make_plan(n_rows, n_cols, n_trees, n_nodes, n_bins,
                            n_stats, bin_bytes, raw, &p);
  *bytes = err == cudaSuccess ? (long long)p.ws_bytes : 0;
  return err;
}

// How a launch at these shapes is tiled, for logs: writes {vec, node_tile,
// bin_tile, col_group, chunks, direct, smem} into plan[7].
extern "C" int shifu_hist_plan(long long n_rows, int n_cols, int n_trees,
                               int n_nodes, int n_bins, int n_stats,
                               int bin_bytes, long long* plan) {
  Plan p;
  const int err = make_plan(n_rows, n_cols, n_trees, n_nodes, n_bins,
                            n_stats, bin_bytes, 0, &p);
  const long long v[7] = {p.vec, p.node_tile, p.bin_tile, p.col_group,
                          p.chunks, p.direct, (long long)p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = err == cudaSuccess ? v[i] : 0;
  return err;
}

// Launch on `stream`; returns a cudaError_t (0 = launched).  `bin_bytes` is
// the width of a bin id: 1 (uint8 planes, <= 256 bins) or 4 (int32; the
// plane 4-byte aligned, a uint8 one aligned to its rows).  `amax` [TB, S]
// f32 holds max_n |stats[t, n, s]|, `exact` [TB, S] int32 is non-zero
// where every stats[t, :, s] is an integer and amax * N < 2^31; `ws` is at
// least shifu_hist_workspace bytes of scratch; `out` is [TB, K, C, B, S]
// f32.  All contiguous.
extern "C" int shifu_hist(const void* bins, int bin_bytes,
                          const void* node_idx, const void* stats,
                          const void* amax, const void* exact, void* ws,
                          long long ws_bytes, void* out, long long n_rows,
                          int n_cols, int n_trees, int n_nodes, int n_bins,
                          int n_stats, void* stream) {
  return launch(bins, bin_bytes, node_idx, stats, amax, exact, ws, ws_bytes,
                out, n_rows, n_cols, n_trees, n_nodes, n_bins, n_stats, kAll,
                0, nullptr, nullptr, stream);
}

// shifu_hist's launch on a block of the rows, stopped before the rounding:
// `raw_out` [TB, K, C, B, S] int64 receives every cell's exact 64-bit
// fixed-point sum at the scale of `amax` [TB, S] and the row count
// `n_scale` (device int64 [1]) — both reduced over every block by the
// caller — with `exact` [TB, S] decided from them too; `ws` is
// shifu_hist_workspace(raw = 1) bytes.
extern "C" int shifu_hist_raw(const void* bins, int bin_bytes,
                              const void* node_idx, const void* stats,
                              const void* amax, const void* exact, void* ws,
                              long long ws_bytes, void* raw_out,
                              const void* n_scale, long long n_rows,
                              int n_cols, int n_trees, int n_nodes,
                              int n_bins, int n_stats, void* stream) {
  return launch(bins, bin_bytes, node_idx, stats, amax, exact, ws, ws_bytes,
                nullptr, n_rows, n_cols, n_trees, n_nodes, n_bins, n_stats,
                kAll, 1, (const long long*)n_scale, raw_out, stream);
}

// The rounding of shifu_hist_raw's cells (summed over the blocks): `out`
// [TB, K, C, B, S] f32 from `acc` int64 at the scale of `amax` [TB, S] and
// `n_scale` (device int64 [1]) — the bits one shifu_hist launch over all
// the rows writes.
extern "C" int shifu_hist_flush(const void* acc, const void* amax, void* out,
                                const void* n_scale, long long total,
                                int n_trees, int n_stats, void* stream) {
  if (total <= 0 || n_trees <= 0 || total % n_trees || n_stats <= 0)
    return total == 0 ? cudaSuccess : cudaErrorInvalidValue;
  finalize_kernel<<<grid_for(total, 8192), 256, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)acc, (const float*)amax, (float*)out, total,
      total / n_trees, n_stats, 0, (const long long*)n_scale);
  return cudaGetLastError();
}

// For timing only: shifu_hist's launch stopped after part `stop` (0: the
// partition and block set-up, 1: the row walk, 2: the adds; 3 runs all of
// it, as shifu_hist); below 3 `out` is undefined.
extern "C" int shifu_hist_until(const void* bins, int bin_bytes,
                                const void* node_idx, const void* stats,
                                const void* amax, const void* exact, void* ws,
                                long long ws_bytes, void* out,
                                long long n_rows, int n_cols, int n_trees,
                                int n_nodes, int n_bins, int n_stats, int stop,
                                void* stream) {
  return launch(bins, bin_bytes, node_idx, stats, amax, exact, ws, ws_bytes,
                out, n_rows, n_cols, n_trees, n_nodes, n_bins, n_stats, stop,
                0, nullptr, nullptr, stream);
}

// Per-column fine histogram of bucket ids — the Hopper port of the Pallas
// kernel shifu_tpu/ops/hist_pallas.py::_stats_hist_kernel (launched there
// from stats_histograms_pallas).  Built by shifu_tpu_torch/ops/cuda_lib.py
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (plain C entry points, no PyTorch headers).
//
// What it computes:
//   out[c, b, s] = sum_n [idx[n, c] == b] * stats[n, s]
// for bucket ids idx [N, C] int32 (any id outside [0, B) -- the stats plane
// writes -1 for a missing cell -- counts nowhere), stats [N, S] f32 with
// 1 <= S <= 4, B <= 4096, out [C, B, S] f32.
//
// Exactness: the first `n_exact` channels are count channels (the stats
// plane's pos/neg 0/1 indicators): their values must be non-negative
// integers, and they are summed as integers, exact.  Every later channel is
// summed in 64-bit fixed point: scale 2^e_s from amax_s = max_n
// |stats[n, s]| (a device tensor, so the host never syncs) with amax_s * N
// * 2^e_s < 2^62 (fixed_point.cuh::channel_exp), quanta rint(v * 2^e_s),
// integer adds, result rint_f32(sum) * 2^-e_s.  Integer adds are exact and
// associative, so the result has the same bits whatever order the blocks,
// warps and threads run in.  A non-finite weighted channel comes out NaN.
//
// What bounds it on an H100: bytes.  It must read every id and every stat
// once and write [C, B, S] f32 once (253.8 MB at N = 262,144, C = 224,
// B = 4096, S = 4: 0.076 ms at 3.35 TB/s); its N*C*S adds are far below
// the card's integer rate.
//
// What held the kernel this design replaced, by part (chip_smoke.py
// --time-of on it, each part the difference of two launches, S = 4 at
// N = 262,144, C = 224, B = 4096): a transpose of the ids to a [C, N]
// int16 copy, 0.19 of 0.61 ms (it moves 352 MB where 235 are needed), and
// the accumulate, 0.38 ms, where each of 224 one-column blocks re-read all
// of the [N, S] stats from L2 (940 MB at S = 4; 0.28 ms at S = 2, with
// half of that traffic).  A column's cells take 96 KB of shared memory at
// S = 4 and B = 4096, so an SM holds two columns at most: that is what
// forces either a transposed copy or sharing the [N, C] rows between SMs.
// So:
// 1. No transposed copy.  A thread-block cluster of up to 4 CTAs owns
//    neighbouring columns, 2 a CTA (1 where two columns' cells do not
//    fit: S = 4 with fewer than two count channels), so at 2 a CTA one
//    32-byte sector of an id row.  Each tile of cl * 512 rows is loaded
//    once: CTA r
//    reads 512 of its rows, a warp four rows' whole sectors a load, and
//    the four lanes holding one column of a warp's 16 rows trade ids
//    (shuffles) so each sends four rows as one 8-byte store into the
//    stage of the CTA that owns the column, in that CTA's shared memory
//    (distributed shared memory).  The ids cross device memory and L2
//    once, in full sectors.  (A TMA multicast of the [rows x 8] id tile
//    would land all 8 columns in every CTA: four times the stage that
//    the 35 KB left beside two S = 4 columns can hold.)  (One row a thread and eight 4-byte loads of
//    one sector each staged much slower: every load touched 32 lines.  So
//    did CTAs without a cluster, each loading its own two columns' 8
//    bytes of every sector.)
// 2. A CTA reads each row's stats once for its two columns (half the L2
//    stats traffic of one column a block) and quantises them once.
// 3. The stage holds four tiles, with one split cluster barrier a tile.
//    Tile i is pushed two iterations ahead, released by the arrive of the
//    next iteration and read after the wait of its own; the id loads are
//    volatile, so they are issued a tile ahead and not sunk below the adds.
// 4. The adds go into the CTA's own cells with native shared atomics: a
//    count channel one non-returning atomic, a weighted channel two
//    words with an explicit carry, all rows' returning low-word atomics
//    of a tile issued before their carries (as in hist.cu).  Zero values
//    add nothing and are skipped.  (Native 64-bit shared atomics, and
//    cells laid out as channel planes, were slower.)
// 5. With enough columns the grid is one wave (28 clusters of 4 at C =
//    224: 112 SMs) and each CTA writes its columns' cells straight to
//    f32.  With few columns the rows are split over more clusters, which
//    add their non-zero cells into a 64-bit global accumulator that a last
//    kernel writes as f32.
// What holds it now (chip_smoke.py, by part): staging and adds take about
// equal shares and do not overlap.  In trials on an H100 a second cluster
// barrier a tile added about as much again as the staging part, adding a
// staged tile over and over without exchange or barrier took about two
// thirds of a launch, and relaxed arrives, mbarrier handshakes (spinning
// or suspending) and stats loaded a tile ahead moved nothing: the
// per-tile synchronisation is the open lever (PERF.md section 7).
// Production runs every launch to its end (shifu_stats_hist).  On a mesh,
// where each rank holds a block of a chunk's rows
// (shifu_tpu_torch/ops/stats_hist.py, stats_histograms_sharded), a launch
// stops before the rounding instead (shifu_stats_hist_raw): it writes
// every cell's exact sum into an int64 [C, B, S] buffer — counts as
// integers, weighted channels in 64-bit fixed point at the scale of an
// amax and a row count that the caller reduced over the ranks (device
// values).  The caller sums those buffers over the ranks, exactly, and
// shifu_stats_hist_flush rounds each cell to f32 once, as the last kernel
// of a single launch does, so the sharded result has the bits of one
// launch over all the rows.  A second entry point, shifu_stats_hist_until, stops a launch after staging the
// ids (loads, exchange, barriers) or after the adds, through kernel
// instantiations of their own, so a timing run can split a launch's time
// by part without a branch in the production kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxStats = 4;
constexpr int kSectorCols = 8;            // int32 ids in a 32-byte sector
constexpr int kSliceRows = 512;           // rows a CTA loads a tile
constexpr int kLoads = kSliceRows * kSectorCols / kThreads;  // a thread
constexpr int kStages = 4;                // tiles staged at once
constexpr int kMaxG = 2;                  // columns a CTA owns
constexpr int kMaxCluster = 4;            // CTAs a cluster
constexpr int kRows = kMaxCluster * kSliceRows / kThreads;  // a thread's
                                          // rows of a tile
constexpr int kSmemMax = 227 * 1024;      // Hopper's per block
constexpr long long kMinRowsPerChunk = 4096;

// the last part a launch runs: all of them in production; a timing launch
// (shifu_stats_hist_until) stops after staging the ids or after the adds
constexpr int kStage = 1, kAccum = 2, kAll = 3;

using shifu::channel_exp;

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Word offset of channel s inside a bucket's cell: count channels first,
// one word each, then the weighted ones, two words each.
__host__ __device__ __forceinline__ int slot(int s, int n_exact) {
  return s < n_exact ? s : n_exact + 2 * (s - n_exact);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  const int32_t* idx;                 // [N, C]
  const float* stats;                 // [N, S]
  const float* amax;                  // [S]
  unsigned long long* acc;            // [C, B, S], split rows only
  float* out;                         // [C, B, S]
  const long long* n_scale;           // [1] rows of the scale, or null: N
  long long n_rows, rows_per_chunk;
  int n_cols, n_buckets, n_stats, n_exact;
  int g, cl, direct;
};

// How one launch tiles its work; a pure function of the shapes and the
// card's SM count.
struct Plan {
  int g, cl;                          // columns a CTA, CTAs a cluster
  long long clusters, chunks;         // column clusters, row chunks
  int direct;                         // one chunk: CTAs write f32
  long long tile_rows;                // rows a tile: cl * kSliceRows
  size_t smem;
};

// raw: the launch writes 64-bit cells to the caller's buffer (never direct)
int make_plan(long long n_rows, int n_cols, int n_buckets, int n_stats,
              int n_exact, int n_sms, int raw, Plan* p) {
  if (n_cols <= 0 || n_buckets <= 0 || n_buckets > 4096 || n_stats <= 0 ||
      n_stats > kMaxStats || n_exact < 0 || n_exact > n_stats || n_rows < 0)
    return cudaErrorInvalidValue;
  const size_t words = n_exact + 2 * (n_stats - n_exact);
  const size_t col_bytes = 4 * (size_t)n_buckets * words;
  const size_t stage_bytes = 2ull * kStages * kSectorCols * kSliceRows;
  p->g = 2 * col_bytes + stage_bytes <= (size_t)kSmemMax ? 2 : 1;
  if (col_bytes + stage_bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
  p->cl = kMaxCluster;
  const long long owners = cdiv(n_cols, p->g);     // CTAs with columns
  if (owners < p->cl) p->cl = (int)owners;
  p->clusters = cdiv(n_cols, (long long)p->cl * p->g);
  const long long ctas = p->clusters * p->cl;
  long long chunks = n_sms / ctas;
  const long long most = cdiv(n_rows, kMinRowsPerChunk);
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  p->chunks = cdiv(n_rows, cdiv(n_rows > 0 ? n_rows : 1, chunks));
  if (p->chunks < 1) p->chunks = 1;
  p->direct = p->chunks == 1 && !raw;
  p->tile_rows = (long long)p->cl * kSliceRows;
  p->smem = p->g * col_bytes + 2ull * kStages * p->g * p->tile_rows;
  return cudaSuccess;
}

// A global load issued where it stands: volatile, so the compiler cannot
// sink it below the adds that follow (to shorten its register's life),
// which would expose its latency on every tile.
__device__ __forceinline__ int load_early(const int32_t* p) {
  int x;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(x) : "l"(p) : "memory");
  return x;
}

// This CTA's share of one tile's ids: kSliceRows rows of the tile from
// row `row0`, the cluster's w = g * cl columns.  Lane l of warp q takes
// column l % 8 of rows 16 q + 4 k + l / 8, k < kLoads, so each load of a
// warp reads four rows' whole 32-byte sectors.  An id outside [0, B), past
// the chunk's last row (r1) or past the last column is -1 (the range check
// waits for push_ids, so the loads stay in flight until then).
__device__ __forceinline__ void load_ids(const Args& a, long long row0,
                                         long long r1, int c0,
                                         int (&v)[kLoads]) {
  const int w = a.g * a.cl;
  const int c = threadIdx.x & 7;
  const long long row = row0 + (threadIdx.x >> 5) * (4 * kLoads)
                        + ((threadIdx.x >> 3) & 3);
  const bool col_ok = c < w && c0 + c < a.n_cols;
  const int32_t* p = a.idx + row * a.n_cols + c0 + c;
#pragma unroll
  for (int k = 0; k < kLoads; ++k)
    v[k] = col_ok && row + 4 * k < r1 ? load_early(p + 4LL * k * a.n_cols)
                                      : -1;
}

// Maps a loaded id to the stage's form: its bucket, or -1 outside [0, B).
__device__ __forceinline__ int16_t bucket_or_missing(int x, int n_buckets) {
  return (int16_t)((unsigned)x < (unsigned)n_buckets ? x : -1);
}

// Writes a thread's ids (load_ids' rows, at tile position at0 on) into
// the owner's stage buffer `buf`: column j of the cluster lives in CTA
// j / g as its local column j % g.  The four lanes that hold one column of
// a warp's 16 rows first trade ids (a 4 x 4 transpose through shuffles),
// so that each holds four consecutive rows and sends them as one 8-byte
// store: a quarter of the remote stores one id a store would take.
__device__ __forceinline__ void push_ids(cg::cluster_group& cluster,
                                         int16_t* stage, const Args& a,
                                         int buf, int at0,
                                         const int (&v)[kLoads]) {
  static_assert(kLoads == 4, "the transpose trades four ids a lane");
  const int c = threadIdx.x & 7;
  const int ri = (threadIdx.x >> 3) & 3;         // this lane's row in 4
  // round j: lane ri sends its id of row group (ri + j) % 4 and takes lane
  // (ri - j) % 4's id of row group ri, i.e. row 4 ri + (ri - j) % 4
  int out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = (ri + j) & 3;
    const int send = k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
    const int from = (ri - j) & 3;
    const int got = __shfl_sync(0xffffffffu, send, (from << 3) | c);
    if (from == 0) out[0] = got;
    else if (from == 1) out[1] = got;
    else if (from == 2) out[2] = got;
    else out[3] = got;
  }
  if (c >= a.g * a.cl) return;
  const long long tile = (long long)a.cl * kSliceRows;
  int16_t* dst = cluster.map_shared_rank(stage, (unsigned)(c / a.g))
      + ((long long)buf * a.g + c % a.g) * tile + at0
      + (threadIdx.x >> 5) * (4 * kLoads) + 4 * ri;
  unsigned long long packed = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    packed |= (unsigned long long)(uint16_t)bucket_or_missing(
                  out[m], a.n_buckets) << (16 * m);
  *reinterpret_cast<unsigned long long*>(dst) = packed;
}

// kTimed: a timing instantiation, which stops after part `until`; the
// production one always runs to its end
template <bool kTimed>
__global__ void __launch_bounds__(kThreads, 1)
stats_hist_kernel(const Args a, int until) {
  const int stop = kTimed ? until : kAll;
  extern __shared__ __align__(16) unsigned smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = a.n_stats;
  const int words = a.n_exact + 2 * (S - a.n_exact);
  const int col_words = a.n_buckets * words;
  const long long tile = (long long)a.cl * kSliceRows;
  unsigned* hist = smem;                                  // [g][B][words]
  int16_t* stage = reinterpret_cast<int16_t*>(hist + a.g * col_words);

  // this CTA's columns and the cluster's rows
  const int c0 = (int)(blockIdx.x / a.cl) * a.cl * a.g;   // cluster's first
  const int my0 = c0 + rank * a.g;
  const int mine = max(0, min(a.g, a.n_cols - my0));
  const long long r0 = (long long)blockIdx.y * a.rows_per_chunk;
  const long long r1 = min(r0 + a.rows_per_chunk, a.n_rows);
  const long long tiles = r1 > r0 ? cdiv(r1 - r0, tile) : 0;

  for (int i = threadIdx.x; i < a.g * col_words; i += kThreads) hist[i] = 0u;
  const long long n_scale = a.n_scale ? __ldg(a.n_scale) : a.n_rows;
  double scale[kMaxStats];
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s)
    scale[s] = s < S && s >= a.n_exact
                   ? ldexp(1.0, channel_exp(__ldg(a.amax + s), n_scale))
                   : 1.0;
  const int t = threadIdx.x;
  const int mine0 = rank * kSliceRows;        // this CTA's rows of a tile

  // Tile i lives in buffer i % kStages.  It is pushed two iterations
  // ahead (in iteration i - 2), released by the arrive of iteration i - 1
  // and read after the wait of iteration i.  Its buffer last held tile
  // i - 4, which every CTA had finished adding before it arrived for tile
  // i - 2.
  int v[kLoads];
  if (tiles > 0) load_ids(a, r0 + mine0, r1, c0, v);
  cluster.sync();                  // every CTA's stage exists
  if (tiles > 0) push_ids(cluster, stage, a, 0, mine0, v);
  cluster_arrive();
  if (tiles > 1) {
    load_ids(a, r0 + tile + mine0, r1, c0, v);
    push_ids(cluster, stage, a, 1, mine0, v);
  }
  if (tiles > 2) load_ids(a, r0 + 2 * tile + mine0, r1, c0, v);
  unsigned sink = 0;
  for (long long i = 0; i < tiles; ++i) {
    const long long base = r0 + i * tile;
    cluster_wait();                // tile i is visible
    cluster_arrive();              // releases tile i + 1
    if (i + 2 < tiles) {
      push_ids(cluster, stage, a, (int)((i + 2) % kStages), mine0, v);
      if (i + 3 < tiles) load_ids(a, base + 3 * tile + mine0, r1, c0, v);
    }
    const int16_t* ids = stage + (i % kStages) * a.g * tile;
    if (kTimed && stop < kAccum) {
      sink += (unsigned)ids[t % tile];
    } else if (mine > 0) {
      // rows t and t + kThreads: each row's stats read and quantised once
      // for the CTA's columns
      long long q[kRows][kMaxStats];
      int id[kRows][kMaxG];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int at = u * kThreads + t;
        const long long row = base + at;
        const bool live = at < tile && row < r1;
#pragma unroll
        for (int s = 0; s < kMaxStats; ++s) {
          const float x = live && s < S ? __ldg(a.stats + row * S + s)
                                        : 0.0f;
          q[u][s] = s < a.n_exact ? (long long)(unsigned)x
                                  : __double2ll_rn((double)x * scale[s]);
        }
#pragma unroll
        for (int k = 0; k < kMaxG; ++k)
          id[u][k] = live && k < mine ? ids[k * tile + at] : -1;
      }
      // count channels: one non-returning atomic an add
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int k = 0; k < kMaxG; ++k) {
          if (id[u][k] < 0) continue;
          unsigned* cell = hist + k * col_words + id[u][k] * words;
#pragma unroll
          for (int s = 0; s < kMaxStats; ++s)
            if (s < a.n_exact && q[u][s] != 0)
              atomicAdd(cell + s, (unsigned)q[u][s]);
        }
      // weighted channels: every returning low-word atomic of the tile's
      // rows, then the carries into the high words
#pragma unroll
      for (int s = 0; s < kMaxStats; ++s) {
        if (s < a.n_exact || s >= S) continue;
        const int lo = slot(s, a.n_exact);
        unsigned old[kRows][kMaxG];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int k = 0; k < kMaxG; ++k)
            old[u][k] = id[u][k] >= 0 && q[u][s] != 0
                ? atomicAdd(hist + k * col_words + id[u][k] * words + lo,
                            (unsigned)q[u][s])
                : 0u;
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int k = 0; k < kMaxG; ++k)
            if (id[u][k] >= 0 && q[u][s] != 0) {
              const unsigned ql = (unsigned)q[u][s];
              atomicAdd(hist + k * col_words + id[u][k] * words + lo + 1,
                        (unsigned)(q[u][s] >> 32)
                            + (old[u][k] + ql < old[u][k] ? 1u : 0u));
            }
      }
    }
  }
  cluster_wait();                  // no CTA writes into this one any more
  if (kTimed) {
    if (sink == 0x9e3779b9u) hist[0] ^= 1u;        // keeps timed loads
    if (stop < kAll) return;
  }
  __syncthreads();
  if (mine == 0) return;

  // this CTA's cells: straight to f32, or their non-zero ones into acc
  const int run = a.n_buckets * S;
  for (int i = t; i < mine * run; i += kThreads) {
    const int s = i % S;
    const int b = (i / S) % a.n_buckets;
    const int k = i / run;
    const unsigned* cell = hist + k * col_words + b * words + slot(s, a.n_exact);
    const unsigned long long val =
        s < a.n_exact ? (unsigned long long)cell[0]
                      : ((unsigned long long)cell[1] << 32) | cell[0];
    const size_t at = (size_t)(my0 + k) * run + i % run;
    if (a.direct) {
      if (s < a.n_exact) {
        a.out[at] = __ull2float_rn(val);
      } else {
        const float am = __ldg(a.amax + s);
        a.out[at] = isfinite(am) ? ldexpf(__ll2float_rn((long long)val),
                                          -channel_exp(am, n_scale))
                                 : __int_as_float(0x7fc00000);
      }
    } else if (val != 0ull) {
      atomicAdd(a.acc + at, val);
    }
  }
}

__global__ void stats_hist_finalize_kernel(
    const unsigned long long* __restrict__ acc, const float* __restrict__ amax,
    float* __restrict__ out, long long total, int n_stats, int n_exact,
    long long n_rows, const long long* __restrict__ n_scale) {
  if (n_scale) n_rows = __ldg(n_scale);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(i % n_stats);
    if (s < n_exact) {
      out[i] = __ull2float_rn(acc[i]);
      continue;
    }
    const float a = __ldg(amax + s);
    if (!isfinite(a)) {
      out[i] = __int_as_float(0x7fc00000);     // NaN: stats not finite
      continue;
    }
    out[i] = ldexpf(__ll2float_rn((long long)acc[i]),
                    -channel_exp(a, n_rows));
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <bool kTimed>
int launch_kernel(const Plan& p, const Args& a, int until, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      stats_hist_kernel<kTimed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.clusters * p.cl), (unsigned)p.chunks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, stats_hist_kernel<kTimed>, a, until);
}

// raw: `acc` receives the 64-bit cells at the scale of `n_scale` (device
// [1]) and nothing is rounded; otherwise `n_scale` may be null (the scale
// of n_rows)
int launch(const void* idx, const void* stats, const void* amax, void* acc,
           void* out, long long n_rows, int n_cols, int n_buckets,
           int n_stats, int n_exact, int until, int raw,
           const long long* n_scale, void* stream) {
  Plan p;
  int rc = make_plan(n_rows, n_cols, n_buckets, n_stats, n_exact, sm_count(),
                     raw, &p);
  if (rc != cudaSuccess) return rc;
  if (raw && (until != kAll || !n_scale)) return cudaErrorInvalidValue;
  const long long total = (long long)n_cols * n_buckets * n_stats;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows == 0)
    return raw ? cudaMemsetAsync(acc, 0, (size_t)total * 8, st)
               : cudaMemsetAsync(out, 0, (size_t)total * 4, st);
  cudaError_t err;
  if (!p.direct && until != kStage) {
    err = cudaMemsetAsync(acc, 0, (size_t)total * 8, st);
    if (err != cudaSuccess) return err;
  }
  Args a;
  a.idx = (const int32_t*)idx;
  a.stats = (const float*)stats;
  a.amax = (const float*)amax;
  a.acc = (unsigned long long*)acc;
  a.out = (float*)out;
  a.n_scale = n_scale;
  a.n_rows = n_rows;
  a.rows_per_chunk = cdiv(n_rows, p.chunks);
  a.n_cols = n_cols;
  a.n_buckets = n_buckets;
  a.n_stats = n_stats;
  a.n_exact = n_exact;
  a.g = p.g;
  a.cl = p.cl;
  a.direct = p.direct;
  rc = until == kAll ? launch_kernel<false>(p, a, until, st)
                     : launch_kernel<true>(p, a, until, st);
  if (rc != cudaSuccess) return rc;
  err = cudaGetLastError();
  if (err != cudaSuccess || p.direct || until != kAll || raw) return err;
  long long blocks = cdiv(total, 256);
  if (blocks > 8192) blocks = 8192;
  stats_hist_finalize_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (const unsigned long long*)acc, (const float*)amax, (float*)out, total,
      n_stats, n_exact, n_rows, n_scale);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = launched).  `idx` is
// [N, C] int32, `stats` [N, S] f32 whose first `n_exact` channels are count
// channels, `amax` [S] f32 max |stats[:, s]|, `acc` [C*B*S] 8-byte scratch,
// `out` [C, B, S] f32; all contiguous.
extern "C" int shifu_stats_hist(const void* idx, const void* stats,
                                const void* amax, void* acc, void* out,
                                long long n_rows, int n_cols, int n_buckets,
                                int n_stats, int n_exact, void* stream) {
  return launch(idx, stats, amax, acc, out, n_rows, n_cols, n_buckets,
                n_stats, n_exact, kAll, 0, nullptr, stream);
}

// shifu_stats_hist's launch on a block of the rows, stopped before the
// rounding: `acc` [C, B, S] int64 receives every cell's exact sum — count
// channels as integers, the others in 64-bit fixed point at the scale of
// `amax` [S] and the row count `n_scale` (device int64 [1]), both reduced
// over every block by the caller.
extern "C" int shifu_stats_hist_raw(const void* idx, const void* stats,
                                    const void* amax, void* acc,
                                    const void* n_scale, long long n_rows,
                                    int n_cols, int n_buckets, int n_stats,
                                    int n_exact, void* stream) {
  return launch(idx, stats, amax, acc, nullptr, n_rows, n_cols, n_buckets,
                n_stats, n_exact, kAll, 1, (const long long*)n_scale,
                stream);
}

// The rounding of shifu_stats_hist_raw's cells (summed over the blocks):
// `out` [C, B, S] f32 from `acc` at the scale of `amax` [S] and `n_scale`
// (device int64 [1]) — the bits one shifu_stats_hist launch over all the
// rows writes.
extern "C" int shifu_stats_hist_flush(const void* acc, const void* amax,
                                      void* out, const void* n_scale,
                                      long long total, int n_stats,
                                      int n_exact, void* stream) {
  if (total < 0 || n_stats <= 0 || total % n_stats) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  long long blocks = cdiv(total, 256);
  if (blocks > 8192) blocks = 8192;
  stats_hist_finalize_kernel<<<(unsigned)blocks, 256, 0,
                               (cudaStream_t)stream>>>(
      (const unsigned long long*)acc, (const float*)amax, (float*)out, total,
      n_stats, n_exact, 0, (const long long*)n_scale);
  return cudaGetLastError();
}

// For timing only: the same launch stopped after part `until` (1: the ids
// staged, 2: the adds done); the output is undefined.
extern "C" int shifu_stats_hist_until(const void* idx, const void* stats,
                                      const void* amax, void* acc, void* out,
                                      long long n_rows, int n_cols,
                                      int n_buckets, int n_stats, int n_exact,
                                      int until, void* stream) {
  if (until != kStage && until != kAccum) return cudaErrorInvalidValue;
  return launch(idx, stats, amax, acc, out, n_rows, n_cols, n_buckets,
                n_stats, n_exact, until, 0, nullptr, stream);
}

// How a launch at these shapes tiles its work on the current device:
// out[0..6] = columns a CTA, CTAs a cluster, column clusters, row chunks,
// direct f32 writes, rows a tile, shared memory a CTA.
extern "C" int shifu_stats_hist_plan(long long n_rows, int n_cols,
                                     int n_buckets, int n_stats, int n_exact,
                                     long long* out) {
  Plan p;
  const int rc = make_plan(n_rows, n_cols, n_buckets, n_stats, n_exact,
                           sm_count(), 0, &p);
  if (rc != cudaSuccess) return rc;
  out[0] = p.g;
  out[1] = p.cl;
  out[2] = p.clusters;
  out[3] = p.chunks;
  out[4] = p.direct;
  out[5] = p.tile_rows;
  out[6] = (long long)p.smem;
  return cudaSuccess;
}

// Per-column fine histogram of bucket ids — the Hopper port of the Pallas
// kernel shifu_tpu/ops/hist_pallas.py::_stats_hist_kernel (launched there
// from stats_histograms_pallas).  Built by shifu_tpu_torch/ops/cuda_lib.py
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (plain C entry point, no PyTorch headers).
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
// summed in 64-bit fixed point as in hist.cu: scale 2^e_s from amax_s =
// max_n |stats[n, s]| (a device tensor, so the host never syncs) with
// amax_s * N * 2^e_s < 2^62, quanta rint(v * 2^e_s), integer adds, result
// rint_f32(sum) * 2^-e_s.  Integer adds are exact and associative, so the
// result has the same bits whatever order the blocks, warps and threads
// run in.  A non-finite weighted channel comes out NaN.
//
// What bounds it on an H100: bytes.  It must read every id and every stat
// once and write [C, B, S] f32 once; its N*C*S adds are far below the
// card's integer rate.
//
// What the design does about it:
// 1. A tiled transpose (32 x 32 through shared memory) writes the ids as
//    [C, N] int16, ids outside [0, B) as -1: each column's ids then stream
//    coalesced at 2 bytes a cell, where the [N, C] layout would have a
//    block of one column read 4 bytes of every 32-byte sector.  It costs
//    one read of the int32 ids and one write at half width.
// 2. One block owns a group of columns over a range of rows, with those
//    columns' B x S cells private in shared memory (a count channel as one
//    32-bit word, a weighted one as a low and a high 32-bit word with an
//    explicit carry, add_u64).  At B = 4096 a column takes 32 KB with S = 2
//    and 96 KB with S = 4, so two blocks share an SM.  Each thread takes
//    four rows at a time, reads their stats once and their ids for every
//    column of the group (neighbouring threads, neighbouring rows:
//    coalesced) with all loads in flight before the first atomic, and adds
//    into shared memory with the native 32-bit atomics.
// 3. Groups are one column wherever there are enough columns to fill the
//    card; then one block covers all N rows of its column and writes its
//    cells straight to f32.  With few columns the rows are split over
//    several blocks, which add their non-zero cells into a 64-bit global
//    accumulator that a last kernel writes as f32.
// Not done yet (later work): fusing the transpose into the bucket-id pass
// that produces the ids, warp-private sub-histograms for skewed data.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStats = 4;
constexpr int kRowsInFlight = 4;                     // loads before atomics
constexpr int kSmemBudget = 96 * 1024;               // two blocks per SM
constexpr int kSmemMax = 227 * 1024;                 // Hopper's per block
constexpr int kTargetBlocks = 264;                   // 2 x 132 SMs
constexpr long long kMinRowsPerBlock = 4096;
constexpr int kTile = 32;

using shifu::add_u64;
using shifu::channel_exp;

// [N, C] int32 -> [C, N] int16, ids outside [0, B) as -1.
__global__ void __launch_bounds__(kTile * 8)
transpose_ids_kernel(const int32_t* __restrict__ idx,
                     int16_t* __restrict__ idx_t, long long n_rows,
                     int n_cols, int n_buckets) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const long long r0 = (long long)blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += 8) {
    const long long r = r0 + j;
    const int c = c0 + threadIdx.x;
    if (r < n_rows && c < n_cols) {
      const int v = __ldg(idx + r * n_cols + c);
      tile[threadIdx.x][j] = (unsigned)v < (unsigned)n_buckets ? v : -1;
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += 8) {
    const int c = c0 + j;
    const long long r = r0 + threadIdx.x;
    if (r < n_rows && c < n_cols)
      idx_t[(long long)c * n_rows + r] = (int16_t)tile[j][threadIdx.x];
  }
}

// Word offset of channel s inside a bucket's cell: count channels first,
// one word each, then the weighted ones, two words each.
__device__ __forceinline__ int slot(int s, int n_exact) {
  return s < n_exact ? s : n_exact + 2 * (s - n_exact);
}

// Shared memory per column of the group: for each bucket, its cell of
// n_exact + 2 * (S - n_exact) words.  `direct` blocks cover every row of
// their columns and write f32 to `out`; the others add into `acc`.
__global__ void __launch_bounds__(kThreads, 2)
stats_hist_accum_kernel(const int16_t* __restrict__ idx_t,   // [C, N]
                        const float* __restrict__ stats,     // [N, S]
                        const float* __restrict__ amax,      // [S]
                        unsigned long long* __restrict__ acc,  // [C, B, S]
                        float* __restrict__ out,             // [C, B, S]
                        long long n_rows, int n_cols, int n_buckets,
                        int n_stats, int n_exact, int col_group,
                        int n_col_groups, long long rows_per_block,
                        bool direct) {
  extern __shared__ __align__(16) unsigned smem[];
  const int words = n_exact + 2 * (n_stats - n_exact);
  const int cg = blockIdx.x % n_col_groups;
  const int c0 = cg * col_group;
  const int cols = min(col_group, n_cols - c0);
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, n_rows);
  if (cols <= 0 || r0 >= r1) return;

  const int col_words = n_buckets * words;
  for (int i = threadIdx.x; i < cols * col_words; i += blockDim.x)
    smem[i] = 0u;
  double scale[kMaxStats];
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s)
    scale[s] = s < n_stats && s >= n_exact
                   ? ldexp(1.0, channel_exp(__ldg(amax + s), n_rows))
                   : 1.0;
  __syncthreads();

  // each thread takes kRowsInFlight rows a step, blockDim apart, and
  // issues all their loads before the first atomic
  const long long step = (long long)blockDim.x * kRowsInFlight;
  for (long long base = r0 + threadIdx.x; base < r1; base += step) {
    float v[kRowsInFlight][kMaxStats];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const long long r = base + (long long)u * blockDim.x;
#pragma unroll
      for (int s = 0; s < kMaxStats; ++s)
        v[u][s] = s < n_stats && r < r1 ? __ldg(stats + r * n_stats + s)
                                        : 0.0f;
    }
    for (int c = 0; c < cols; ++c) {
      const int16_t* ids = idx_t + (long long)(c0 + c) * n_rows;
      int b[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const long long r = base + (long long)u * blockDim.x;
        b[u] = r < r1 ? __ldg(ids + r) : -1;
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (b[u] < 0) continue;                      // missing cell, tail
        unsigned* cell = smem + c * col_words + b[u] * words;
#pragma unroll
        for (int s = 0; s < kMaxStats; ++s) {
          if (s >= n_stats || v[u][s] == 0.0f) continue;
          if (s < n_exact)
            atomicAdd(cell + s, (unsigned)v[u][s]);
          else
            add_u64(cell + slot(s, n_exact), cell + slot(s, n_exact) + 1,
                    __double2ll_rn((double)v[u][s] * scale[s]));
        }
      }
    }
  }
  __syncthreads();

  // the block's cells: straight to f32, or their non-zero ones into acc
  const int run = n_buckets * n_stats;
  for (int i = threadIdx.x; i < cols * run; i += blockDim.x) {
    const int s = i % n_stats;
    const int b = (i / n_stats) % n_buckets;
    const int c = i / run;
    const unsigned* cell = smem + c * col_words + b * words + slot(s, n_exact);
    const unsigned long long val =
        s < n_exact ? (unsigned long long)cell[0]
                    : ((unsigned long long)cell[1] << 32) | cell[0];
    const size_t at = (size_t)(c0 + c) * run + i % run;
    if (direct) {
      if (s < n_exact) {
        out[at] = __ull2float_rn(val);
      } else {
        const float a = __ldg(amax + s);
        out[at] = isfinite(a) ? ldexpf(__ll2float_rn((long long)val),
                                       -channel_exp(a, n_rows))
                              : __int_as_float(0x7fc00000);
      }
    } else if (val != 0ull) {
      atomicAdd(acc + at, val);
    }
  }
}

__global__ void stats_hist_finalize_kernel(
    const unsigned long long* __restrict__ acc, const float* __restrict__ amax,
    float* __restrict__ out, long long total, int n_stats, int n_exact,
    long long n_rows) {
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

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = launched).  `idx` is
// [N, C] int32, `stats` [N, S] f32 whose first `n_exact` channels are count
// channels, `amax` [S] f32 max |stats[:, s]|, `idx_t` [C, N] int16 and
// `acc` [C*B*S] 8-byte scratch, `out` [C, B, S] f32; all contiguous.
extern "C" int shifu_stats_hist(const void* idx, const void* stats,
                                const void* amax, void* idx_t, void* acc,
                                void* out, long long n_rows, int n_cols,
                                int n_buckets, int n_stats, int n_exact,
                                void* stream) {
  if (n_cols <= 0 || n_buckets <= 0 || n_buckets > 4096 || n_stats <= 0 ||
      n_stats > kMaxStats || n_exact < 0 || n_exact > n_stats || n_rows < 0)
    return cudaErrorInvalidValue;
  const long long total = (long long)n_cols * n_buckets * n_stats;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows == 0)
    return cudaMemsetAsync(out, 0, (size_t)total * 4, st);

  dim3 tgrid((unsigned)cdiv(n_rows, kTile), (unsigned)cdiv(n_cols, kTile));
  transpose_ids_kernel<<<tgrid, dim3(kTile, 8), 0, st>>>(
      (const int32_t*)idx, (int16_t*)idx_t, n_rows, n_cols, n_buckets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long words = n_exact + 2LL * (n_stats - n_exact);
  const long long col_bytes = 4LL * n_buckets * words;
  if (col_bytes > kSmemMax) return cudaErrorInvalidValue;
  // as few columns a group as fill the card, as many as fit the budget
  long long most = kSmemBudget / col_bytes;
  if (most < 1) most = 1;
  long long col_group = cdiv(n_cols, kTargetBlocks);
  if (col_group > most) col_group = most;
  const long long n_col_groups = cdiv(n_cols, col_group);
  col_group = cdiv(n_cols, n_col_groups);                // balance them
  long long chunks = kTargetBlocks / n_col_groups;
  const long long most_chunks = cdiv(n_rows, kMinRowsPerBlock);
  if (chunks > most_chunks) chunks = most_chunks;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  const long long rows_per_block = cdiv(n_rows, chunks);
  chunks = cdiv(n_rows, rows_per_block);
  const bool direct = chunks == 1;
  if (!direct) {
    err = cudaMemsetAsync(acc, 0, (size_t)total * 8, st);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = (size_t)(col_group * col_bytes);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stats_hist_accum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)n_col_groups, (unsigned)chunks);
  stats_hist_accum_kernel<<<grid, kThreads, smem, st>>>(
      (const int16_t*)idx_t, (const float*)stats, (const float*)amax,
      (unsigned long long*)acc, (float*)out, n_rows, n_cols, n_buckets,
      n_stats, n_exact, (int)col_group, (int)n_col_groups, rows_per_block,
      direct);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  long long blocks = cdiv(total, 256);
  if (blocks > 8192) blocks = 8192;
  stats_hist_finalize_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (const unsigned long long*)acc, (const float*)amax, (float*)out, total,
      n_stats, n_exact, n_rows);
  return cudaGetLastError();
}

// Forest traversal over narrow bin planes — the Hopper port of the Pallas
// kernel shifu_tpu/ops/tree_quant.py::_traverse_kernel (launched there from
// _predict_quant_pallas).  Built by shifu_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (plain C entry points, no PyTorch headers).
//
// What it computes: for every (tree t, row n), walk `depth` levels of a
// complete binary tree — feat = split_feat[t, node]; a node with feat < 0
// is a leaf and the row stays there; otherwise b = bins[n, feat] and the row
// goes to 2*node+1 when left_mask[t, node, b] != 0, else 2*node+2 — then
// write out[t, n] = leaf_values[t, terminal node].  Bins are uint8 (forests
// of <= 256 bins, the wire dtype) or int32 (wider forests, which the
// reference walks with XLA gathers instead of its kernel).  Bin ids >=
// n_bins clamp to n_bins - 1 (the reference's gather fallback clamps; its
// Pallas one-hot would route them right), feature ids >= n_cols clamp
// likewise; negative ids are outside the contract and clamp to 0.
//
// What bounds it on an H100: bytes.  At most each row's bins are read once
// (N*C bytes at uint8), of the forest only what the walks reach, and
// [T, N] f32 written once: ops/tree_quant.py::traverse_bytes counts it for
// given data.  The walk itself is a chain of dependent integer gathers, a
// handful of integer operations per level, far below the card's
// arithmetic rate.
//
// What held the kernel this design replaced (PR 1's, kept below as the
// wide path): its row tile sat in shared memory but the forest did not, so
// every level of every walk was two dependent loads from L1/L2
// (split_feat[node], then left_mask[node, b]) at hundreds of cycles each,
// with one walk at a time in a thread: latency, not bytes (0.23 ms at N =
// 65,536, 19x its bound).  So, for masks of <= 256 bins (the packed path):
// 1. The forest is packed once, where its caller pins it on the device
//    (ops/tree_quant.py::pack_forest): each internal node (the first
//    2^depth - 1; deeper nodes are never split) as one record of its left
//    mask as a bitset, W32 32-bit words, then its split feature, padded to
//    16 bytes (W32 = 2 at <= 64 bins: the whole record is one 16-byte
//    shared load a level), and the leaf values of the 2^(depth+1) - 1
//    nodes a walk can end on, f32.  At depth 7 and 64 bins a tree is
//    3,052 bytes, against 17.6 KB as uint8 masks and int32 features.
// 2. A block stages a tile of rows' bins (odd word stride: 32 rows
//    reading one feature hit 32 banks; 261 rows of 256 uint8 columns) and
//    then chunks of as many trees as fit beside it (15 at depth 7), so
//    every gather of a walk hits shared memory.  Blocks take half an SM's
//    shared memory, two an SM: the walks are latency-bound, and two
//    blocks' 32 warps hid more of it than one block with a larger tile
//    and chunk, than three or four smaller blocks, or than more walks a
//    thread.
// 3. Each thread keeps kWalks independent (row, tree) walks in flight,
//    interleaved level by level, so the shared-memory latency of one walk
//    hides behind the others'.
// 4. Neighbouring threads take neighbouring rows of one tree, so the
//    [T, N] stores coalesce; with few rows, trees are split over
//    blockIdx.y so the grid still covers the SMs.
// Trees too large for one to fit (the depth-14 Random Forest) walk their
// packed records from L2 instead, one 16-byte load a level.  Masks wider
// than 256 bins (int32 planes of up to 65,536 bins) take the wide path:
// PR 1's kernel, which walks the uint8 masks in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 128;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kTargetBlocks = 264;     // two blocks per SM on 132 SMs

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
tree_traverse_kernel(const BinT* __restrict__ bins,           // [N, C]
                     const int32_t* __restrict__ split_feat,  // [T, K]
                     const uint8_t* __restrict__ left_mask,   // [T, K, B]
                     const float* __restrict__ leaf_values,   // [T, K]
                     float* __restrict__ out,                 // [T, N]
                     long long n_rows, int n_cols, int n_trees,
                     int n_nodes, int n_bins, int depth,
                     int tile_rows, int stride, int trees_per_block) {
  // tile: [tile_rows, stride bytes]; a row's C bins sit at its start
  extern __shared__ __align__(16) uint8_t tile[];
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, n_rows - row0);
  const int tree0 = blockIdx.y * trees_per_block;
  const int trees = min(trees_per_block, n_trees - tree0);
  if (rows <= 0 || trees <= 0) return;

  // stage the tile: 4-byte words when rows are word-sized and aligned
  const int row_bytes = n_cols * (int)sizeof(BinT);
  const uint8_t* src =
      reinterpret_cast<const uint8_t*>(bins) + row0 * row_bytes;
  if ((row_bytes & 3) == 0 && ((uintptr_t)src & 3) == 0) {
    const int words = row_bytes >> 2;
    const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dst32 = reinterpret_cast<uint32_t*>(tile);
    const int total = rows * words;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / words;
      dst32[r * (stride >> 2) + (i - r * words)] = __ldg(src32 + i);
    }
  } else {
    const int total = rows * row_bytes;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / row_bytes;
      tile[r * stride + (i - r * row_bytes)] = __ldg(src + i);
    }
  }
  __syncthreads();

  const int pairs = rows * trees;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int r = p % rows;
    const int t = tree0 + p / rows;
    const int32_t* sf = split_feat + (size_t)t * n_nodes;
    const uint8_t* lm = left_mask + (size_t)t * n_nodes * n_bins;
    const BinT* row_bins = reinterpret_cast<const BinT*>(tile + r * stride);
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int feat = __ldg(sf + node);
      if (feat < 0) break;                 // leaf: frozen for good
      const int b = max(0, min((int)row_bins[min(feat, n_cols - 1)],
                               n_bins - 1));
      node = 2 * node + (__ldg(lm + (size_t)node * n_bins + b) ? 1 : 2);
    }
    out[(size_t)t * n_rows + row0 + r] =
        __ldg(leaf_values + (size_t)t * n_nodes + node);
  }
}

template <typename BinT>
int launch(const void* bins, const void* split_feat, const void* left_mask,
           const void* leaf_values, void* out, long long n_rows, int n_cols,
           int n_trees, int n_nodes, int n_bins, int depth, void* stream) {
  if (n_rows <= 0 || n_trees <= 0) return cudaSuccess;
  if (n_cols <= 0 || n_nodes <= 0 || n_bins <= 0 || depth < 0)
    return cudaErrorInvalidValue;
  int stride = (n_cols * (int)sizeof(BinT) + 3) & ~3;
  if (((stride >> 2) & 1) == 0) stride += 4;        // odd word stride
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (stride > max_smem) return cudaErrorInvalidValue;
  const int budget = stride > kDefaultSmem ? max_smem : kDefaultSmem;
  int tile_rows = budget / stride;
  if (tile_rows > kMaxTileRows) tile_rows = kMaxTileRows;
  if ((long long)tile_rows > n_rows) tile_rows = (int)n_rows;
  const long long row_blocks = (n_rows + tile_rows - 1) / tile_rows;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long chunks = (kTargetBlocks + row_blocks - 1) / row_blocks;
  if (chunks > n_trees) chunks = n_trees;
  int trees_per_block = (int)((n_trees + chunks - 1) / chunks);
  const int fill = (kThreads + tile_rows - 1) / tile_rows;  // busy threads
  if (trees_per_block < fill) trees_per_block = fill;
  if (trees_per_block > n_trees) trees_per_block = n_trees;
  const int tree_blocks = (n_trees + trees_per_block - 1) / trees_per_block;
  const size_t smem = (size_t)tile_rows * stride;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_traverse_kernel<BinT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)row_blocks, (unsigned)tree_blocks);
  tree_traverse_kernel<BinT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const BinT*)bins, (const int32_t*)split_feat,
      (const uint8_t*)left_mask, (const float*)leaf_values, (float*)out,
      n_rows, n_cols, n_trees, n_nodes, n_bins, depth, tile_rows, stride,
      trees_per_block);
  return cudaGetLastError();
}


// ------------------------------------------------------- the packed path
constexpr int kPackedThreads = 512;
constexpr int kWalks = 4;                    // walks in flight a thread
constexpr int kMaxPackedRows = 512;
constexpr int kMinPackedRows = 32;
constexpr int kSmemBlock = 113 * 1024;    // two blocks an SM
constexpr int kSmemMax = 227 * 1024;      // Hopper's per block

// 32-bit words of a node record: W32 mask words, the split feature, then
// padding to 16 bytes
template <int W32>
struct Rec {
  static constexpr int kWords = (W32 + 1 + 3) & ~3;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// kStaged: the trees' records and leaves are copied to shared memory a
// chunk at a time; otherwise they are read from L2.
template <typename BinT, int W32, bool kStaged>
__global__ void __launch_bounds__(kPackedThreads, 2)
forest_walk_kernel(const BinT* __restrict__ bins,         // [N, C]
                   const uint32_t* __restrict__ recs,     // [T, n_int, kWords]
                   const float* __restrict__ leaves,      // [T, n_leaf]
                   float* __restrict__ out,               // [T, N]
                   long long n_rows, int n_cols, int n_trees, int n_int,
                   int n_leaf, int n_bins, int depth, int tile_rows,
                   int stride, int trees_per_block, int chunk_trees) {
  constexpr int kWords = Rec<W32>::kWords;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem;                                   // [rows, stride]
  uint32_t* srec = reinterpret_cast<uint32_t*>(
      smem + round_up(tile_rows * stride, 16));
  float* sleaf = reinterpret_cast<float*>(
      srec + (size_t)chunk_trees * n_int * kWords);

  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, n_rows - row0);
  const int tree0 = blockIdx.y * trees_per_block;
  const int trees = min(trees_per_block, n_trees - tree0);
  if (rows <= 0 || trees <= 0) return;

  // stage the row tile: 4-byte words when rows are word-sized and aligned
  const int row_bytes = n_cols * (int)sizeof(BinT);
  const uint8_t* src =
      reinterpret_cast<const uint8_t*>(bins) + row0 * row_bytes;
  if ((row_bytes & 3) == 0 && ((uintptr_t)src & 3) == 0) {
    const int words = row_bytes >> 2;
    const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dst32 = reinterpret_cast<uint32_t*>(tile);
    const int total = rows * words;
    for (int i = threadIdx.x; i < total; i += kPackedThreads) {
      const int r = i / words;
      dst32[r * (stride >> 2) + (i - r * words)] = __ldg(src32 + i);
    }
  } else {
    const int total = rows * row_bytes;
    for (int i = threadIdx.x; i < total; i += kPackedThreads) {
      const int r = i / row_bytes;
      tile[r * stride + (i - r * row_bytes)] = __ldg(src + i);
    }
  }

  for (int c0 = 0; c0 < trees; c0 += chunk_trees) {
    const int tc = min(chunk_trees, trees - c0);
    const int t_first = tree0 + c0;
    const uint32_t* crec = recs + (size_t)t_first * n_int * kWords;
    const float* cleaf = leaves + (size_t)t_first * n_leaf;
    if (kStaged) {
      __syncthreads();                     // the previous chunk is done
      const uint4* g4 = reinterpret_cast<const uint4*>(crec);
      uint4* s4 = reinterpret_cast<uint4*>(srec);
      const int n4 = tc * n_int * kWords / 4;
      for (int i = threadIdx.x; i < n4; i += kPackedThreads)
        s4[i] = __ldg(g4 + i);
      for (int i = threadIdx.x; i < tc * n_leaf; i += kPackedThreads)
        sleaf[i] = __ldg(cleaf + i);
      crec = srec;
      cleaf = sleaf;
    }
    __syncthreads();                       // tile and chunk staged

    const int pairs = rows * tc;
    for (int p0 = threadIdx.x; p0 < pairs; p0 += kPackedThreads * kWalks) {
      int node[kWalks], r[kWalks], t[kWalks];
#pragma unroll
      for (int w = 0; w < kWalks; ++w) {
        const int p = min(p0 + w * kPackedThreads, pairs - 1);
        r[w] = p % rows;
        t[w] = p / rows;
        node[w] = 0;
      }
      for (int level = 0; level < depth; ++level) {
#pragma unroll
        for (int w = 0; w < kWalks; ++w) {
          const uint32_t* rec =
              crec + ((size_t)t[w] * n_int + node[w]) * kWords;
          int feat;
          uint32_t word;
          const BinT* rb =
              reinterpret_cast<const BinT*>(tile + r[w] * stride);
          if constexpr (kWords == 4) {     // one 16-byte load a level
            const uint4 v =
                kStaged ? *reinterpret_cast<const uint4*>(rec)
                        : __ldg(reinterpret_cast<const uint4*>(rec));
            feat = (int)v.z;
            if (feat < 0) continue;        // leaf: frozen for good
            const int b =
                max(0, min((int)rb[min(feat, n_cols - 1)], n_bins - 1));
            word = b < 32 ? v.x >> b : v.y >> (b - 32);
          } else {
            feat = (int)(kStaged ? rec[W32] : __ldg(rec + W32));
            if (feat < 0) continue;        // leaf: frozen for good
            const int b =
                max(0, min((int)rb[min(feat, n_cols - 1)], n_bins - 1));
            word = (kStaged ? rec[b >> 5] : __ldg(rec + (b >> 5)))
                   >> (b & 31);
          }
          node[w] = 2 * node[w] + 2 - (int)(word & 1u);
        }
      }
#pragma unroll
      for (int w = 0; w < kWalks; ++w) {
        const int p = p0 + w * kPackedThreads;
        if (p >= pairs) continue;
        const float v = kStaged ? cleaf[t[w] * n_leaf + node[w]]
                                : __ldg(cleaf + (size_t)t[w] * n_leaf + node[w]);
        out[(size_t)(t_first + t[w]) * n_rows + row0 + r[w]] = v;
      }
    }
  }
}

struct PackedPlan {
  int tile_rows, stride, trees_per_block, chunk_trees, staged;
  long long row_blocks, tree_blocks;
  size_t smem;
};

int packed_plan(long long n_rows, int n_cols, int bin_bytes, int n_trees,
                int n_int, int n_leaf, int w32, PackedPlan* p) {
  int dev = 0, n_sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (n_sms < 1) n_sms = 1;
  int stride = (n_cols * bin_bytes + 3) & ~3;
  if (((stride >> 2) & 1) == 0) stride += 4;          // odd word stride
  p->stride = stride;
  // rows a tile: enough tiles to cover the SMs, at most 512 and at most
  // 3/5 of a block's shared memory (the rest holds a chunk of trees)
  const int rec_bytes = ((w32 + 1 + 3) & ~3) * 4;
  const long long tree_bytes = (long long)n_int * rec_bytes + 4LL * n_leaf;
  long long rows = round_up((int)min((n_rows + n_sms - 1) / n_sms,
                                     (long long)kMaxPackedRows), 32);
  if (rows < kMinPackedRows) rows = kMinPackedRows;
  // a plane too wide for that takes a block of an SM's whole shared
  // memory, down to a tile of one row
  const long long budget =
      stride <= kSmemBlock * 3 / 5 ? kSmemBlock : kSmemMax;
  const long long fit = stride <= kSmemBlock * 3 / 5
      ? (kSmemBlock * 3 / 5) / stride : budget / stride;
  if (rows > fit) rows = fit;
  if (rows > n_rows) rows = n_rows;
  if (rows < 1) return cudaErrorInvalidValue;
  p->tile_rows = (int)rows;
  p->row_blocks = (n_rows + rows - 1) / rows;
  if (p->row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long groups = (n_sms + p->row_blocks - 1) / p->row_blocks;
  if (groups > n_trees) groups = n_trees;
  p->trees_per_block = (int)((n_trees + groups - 1) / groups);
  p->tree_blocks = (n_trees + p->trees_per_block - 1) / p->trees_per_block;
  const size_t tile = (size_t)round_up((int)(rows * stride), 16);
  const long long room = budget - (long long)tile;
  long long chunk = room / tree_bytes;
  if (chunk > p->trees_per_block) chunk = p->trees_per_block;
  p->staged = chunk >= 1;
  p->chunk_trees = p->staged ? (int)chunk : p->trees_per_block;
  p->smem = tile + (p->staged ? (size_t)chunk * tree_bytes : 0);
  return cudaSuccess;
}

template <typename BinT, int W32, bool kStaged>
int launch_packed(const PackedPlan& p, const void* bins, const void* recs,
                  const void* leaves, void* out, long long n_rows,
                  int n_cols, int n_trees, int n_int, int n_leaf, int n_bins,
                  int depth, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      forest_walk_kernel<BinT, W32, kStaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)p.row_blocks, (unsigned)p.tree_blocks);
  forest_walk_kernel<BinT, W32, kStaged><<<grid, kPackedThreads, p.smem,
                                           st>>>(
      (const BinT*)bins, (const uint32_t*)recs, (const float*)leaves,
      (float*)out, n_rows, n_cols, n_trees, n_int, n_leaf, n_bins, depth,
      p.tile_rows, p.stride, p.trees_per_block, p.chunk_trees);
  return cudaGetLastError();
}

template <typename BinT, int W32>
int launch_packed_w(const PackedPlan& p, const void* bins, const void* recs,
                    const void* leaves, void* out, long long n_rows,
                    int n_cols, int n_trees, int n_int, int n_leaf,
                    int n_bins, int depth, cudaStream_t st) {
  return p.staged
      ? launch_packed<BinT, W32, true>(p, bins, recs, leaves, out, n_rows,
                                       n_cols, n_trees, n_int, n_leaf,
                                       n_bins, depth, st)
      : launch_packed<BinT, W32, false>(p, bins, recs, leaves, out, n_rows,
                                        n_cols, n_trees, n_int, n_leaf,
                                        n_bins, depth, st);
}

template <typename BinT>
int launch_packed_b(const PackedPlan& p, int w32, const void* bins,
                    const void* recs, const void* leaves, void* out,
                    long long n_rows, int n_cols, int n_trees, int n_int,
                    int n_leaf, int n_bins, int depth, cudaStream_t st) {
  switch (w32) {
    case 2:
      return launch_packed_w<BinT, 2>(p, bins, recs, leaves, out, n_rows,
                                      n_cols, n_trees, n_int, n_leaf, n_bins,
                                      depth, st);
    case 4:
      return launch_packed_w<BinT, 4>(p, bins, recs, leaves, out, n_rows,
                                      n_cols, n_trees, n_int, n_leaf, n_bins,
                                      depth, st);
    case 8:
      return launch_packed_w<BinT, 8>(p, bins, recs, leaves, out, n_rows,
                                      n_cols, n_trees, n_int, n_leaf, n_bins,
                                      depth, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = launched).  `bin_bytes`
// is the width of a bin id: 1 (uint8 planes, forests of <= 256 bins) or 4
// (int32 planes).  The caller guarantees n_nodes >= 2^(depth+1) - 1 so
// every node id stays in range.
extern "C" int shifu_tree_traverse(const void* bins, int bin_bytes,
                                   const void* split_feat,
                                   const void* left_mask,
                                   const void* leaf_values, void* out,
                                   long long n_rows, int n_cols, int n_trees,
                                   int n_nodes, int n_bins, int depth,
                                   void* stream) {
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, split_feat, left_mask, leaf_values, out,
                           n_rows, n_cols, n_trees, n_nodes, n_bins, depth,
                           stream);
  if (bin_bytes == 4)
    return launch<int32_t>(bins, split_feat, left_mask, leaf_values, out,
                           n_rows, n_cols, n_trees, n_nodes, n_bins, depth,
                           stream);
  return cudaErrorInvalidValue;
}

// The packed path (masks of <= 256 bins): `recs` [T, n_int, words] uint32,
// `leaves` [T, n_leaf] f32 from ops/tree_quant.py::pack_forest, with
// n_int = 2^depth - 1 internal nodes of W32 = ceil(n_bins / 64) * 2 mask
// words and n_leaf = 2^(depth + 1) - 1 leaf values; `bin_bytes` 1 (uint8)
// or 4 (int32).  Returns a cudaError_t (0 = launched).
extern "C" int shifu_forest_walk(const void* bins, int bin_bytes,
                                 const void* recs, const void* leaves,
                                 void* out, long long n_rows, int n_cols,
                                 int n_trees, int n_bins, int depth,
                                 void* stream) {
  if (n_rows <= 0 || n_trees <= 0) return cudaSuccess;
  if (n_cols <= 0 || n_bins <= 0 || n_bins > 256 || depth < 0 || depth > 24)
    return cudaErrorInvalidValue;
  const int w32 = n_bins <= 64 ? 2 : n_bins <= 128 ? 4 : 8;
  const int n_int = depth > 0 ? (1 << depth) - 1 : 1;
  const int n_leaf = (1 << (depth + 1)) - 1;
  PackedPlan p;
  int rc = packed_plan(n_rows, n_cols, bin_bytes, n_trees, n_int, n_leaf,
                       w32, &p);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (bin_bytes == 1)
    return launch_packed_b<uint8_t>(p, w32, bins, recs, leaves, out, n_rows,
                                    n_cols, n_trees, n_int, n_leaf, n_bins,
                                    depth, st);
  if (bin_bytes == 4)
    return launch_packed_b<int32_t>(p, w32, bins, recs, leaves, out, n_rows,
                                    n_cols, n_trees, n_int, n_leaf, n_bins,
                                    depth, st);
  return cudaErrorInvalidValue;
}

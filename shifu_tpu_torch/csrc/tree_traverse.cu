// Forest traversal over narrow bin planes — the Hopper port of the Pallas
// kernel shifu_tpu/ops/tree_quant.py::_traverse_kernel (launched there from
// _predict_quant_pallas).  Built by shifu_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (plain C entry point, no PyTorch headers).
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
// (N*C bytes at uint8), of the forest only what the walks reach (the split
// feature of each visited node, the left-mask entries looked up, the leaf
// values landed on; all of it, 1.8 MB at T=100, K=255, B=64, stays in the
// 50 MB L2), and [T, N] f32 written once: ops/tree_quant.py::traverse_bytes
// counts it for given data.  The walk itself is a chain of dependent
// integer gathers, a handful of integer operations per level, far below
// the card's arithmetic rate.
//
// What the design does about it: a block stages its tile of rows' bins in
// shared memory once and then walks every (row, tree) pair of a chunk of
// trees against that tile, so the plane is read from device memory once
// per row tile rather than once per (tree, level) — the same reuse the TPU
// kernel got from keeping the block in VMEM, but with native gathers in
// place of its one-hot matmul selects.  Consecutive threads take
// consecutive rows of one tree, so the [T, N] stores coalesce and a warp
// reads the same split_feat / left_mask lines.  The tile row stride is
// padded to an odd number of 4-byte words so 32 rows reading the same
// feature hit 32 different shared-memory banks.  When the row count is
// small, trees are split across blockIdx.y so the grid still covers the
// SMs.  Not done yet (later work): fusing the tree sum and link into the
// kernel, warp-per-row layouts, CUDA graphs around a serving bucket.

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

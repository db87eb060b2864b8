// Chunk Top-K kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of grace_tpu/ops/pallas_topk.py:
//   * grace_chunk_compress_feedback <- chunk_compress_feedback (:132, call :169)
//   * grace_chunk_aggregate_dense   <- chunk_aggregate_dense   (:237, call :263)
// and must equal them bit for bit (their plain PyTorch versions live in
// grace_tpu_torch/ops/chunk_topk.py and are the oracle).
//
// Layout: a leaf's flat n-element buffer is viewed as (main_rows, k)
// row-major, main_rows = n / k, plus one tail row holding flat[main_rows*k
// + c] for c < rem = n - main_rows*k and 0.0 elsewhere. Column c of that
// view is chunk c of the Top-K wire format. The tail is read in place: no
// padded copy of the buffer is ever made.
//
// Grouped launches. One launch covers a table of up to kMaxLeaves leaves,
// passed by value as a __grid_constant__ kernel parameter (CUDA >= 12.1
// allows 32,764 bytes of parameters), so the host does no per-leaf CUDA
// work: a model's 161 leaves are one launch of each kernel a step. Each
// leaf is cut into tiles of kTileCols columns; a leaf's entry carries its
// first tile (a prefix sum of ceil(k / kTileCols)), and a block finds its
// leaf by a binary search over that prefix. A leaf's kept elements live at
// its offset koff of the concatenated payload (K-space). The one-leaf
// entry points of the wrappers are the L = 1 case of the same kernels.
//
// What bounds them on this card: bytes. Compress reads the gradient and the
// residual and writes the residual (12 bytes an element) plus 8 bytes a
// kept element; the aggregate writes the dense output (4 bytes an element)
// and reads 8 bytes a kept element for each of the W ranks. Both do a few
// operations a byte, far below the card's ratio of ~20 fp32 FLOP/byte.
//
// What the design does about it:
//   * A block is kRowGroups warps over one tile: warp y takes rows y,
//     y + kRowGroups, ..., so the 32 lanes of a warp read 32 neighbouring
//     floats of a row and every load and store is coalesced, and a column's
//     rows are split over 8 warps instead of walked by one thread.
//   * Compress keeps the compensated values of a chunk of kChunkRows rows in
//     shared memory (16 KB a block), so each element of g and r is read once
//     and each residual element written once: 12 bytes an element, the
//     bound. Columns longer than a chunk (compression ratios under 1/128)
//     recompute comp on the residual pass. Staged in shared memory, a thread
//     needs at most 64 registers and an SM holds 4 blocks; kept in 128
//     registers instead (2 blocks an SM), the 161 leaves took 0.32 ms
//     against 0.12 (PERF.md, section 6). The tail row is loaded with the
//     first rows.
//   * The aggregate stages the W ranks' (row, value) pairs of its tile in
//     shared memory, sums each distinct winning row once into a shared
//     output tile of kAggRows rows, and writes every output element exactly
//     once: no zero-fill followed by a second write of the winners. Ranks
//     are staged kAggRankTile at a time (every world up to that in one
//     tile, staged once); past it, each rank tile adds onto the partial
//     sums the previous tiles left in the output tile, so any W is summed
//     in rank order in one launch.
//
// Bit-exactness rules (see the plain versions):
//   * comp = g*gamma + r*beta with each product rounded before the add:
//     __fmul_rn/__fadd_rn are never contracted into an FMA by nvcc.
//   * The column max propagates NaN: a NaN anywhere in the column (tail
//     included) makes the winner row 0 with the row-0 value, as jnp.max and
//     equality tests do.
//   * The winner is the first main row reaching the max, else the tail. With
//     a column's rows split over warps, partial winners combine by the
//     larger |comp| and, on a tie, the SMALLER ROW: warps see rows
//     interleaved, so "the earlier partial" is not the earlier row.
//   * vals = comp[win] + 0.0f (the masked sum of the reference turns a
//     -0.0 winner into +0.0); bf16 wire values round to nearest even, and
//     the residual absorbs the rounding (comp - float(bf16 value)).
//   * The residual is written over r in place: each element is read and
//     then written by the same thread, after the block's select.
//   * The aggregate adds the ranks' values in rank order starting from
//     +0.0; the mean multiplies by float(1/W), correctly rounded, as XLA
//     compiles the reference's division by the constant W. A row out of a
//     column's range (negative, or past its last real row) is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 32;                 // a warp's width of columns
constexpr int kRowGroups = 8;                 // compress: warps a block
constexpr int kThreads = kTileCols * kRowGroups;
constexpr int kRowsPerThread = 16;            // compress: rows a chunk
constexpr int kChunkRows = kRowGroups * kRowsPerThread;   // 128
// Compress: blocks an SM must hold (64 registers a thread at most); the
// fastest budget of those tried on the H100 (PERF.md, section 6).
constexpr int kMinBlocks = 4;
constexpr int kAggRowGroups = 8;              // aggregate: warps a block
constexpr int kAggRows = 136;                 // aggregate: output tile rows
constexpr int kMaxLeaves = 256;               // leaves a launch
constexpr int kMaxSmem = 232448;              // a block's shared memory
// Aggregate: ranks staged at once, as many as the shared memory beside the
// output tile holds (8 bytes a rank and column).
constexpr int kAggRankTile = (kMaxSmem - kAggRows * kTileCols * 4) /
                             (kTileCols * 8);

// Host table rows (int64 words), as the wrappers fill them.
constexpr int kCompressWords = 7;   // g, r, out_r, n, k, koff, tile0
constexpr int kAggregateWords = 5;  // out, n, k, koff, tile0

// A leaf's shape, divided out on the host: n <= INT32_MAX, so every flat
// index row * k + c fits 32 bits.
struct LeafShape {
  int64_t koff;          // its first kept element in the payload (K-space)
  int32_t k, main_rows, rem, pad;
};

struct CompressLeaf {
  const float* g;
  const float* r;        // nullptr: no feedback term
  float* out_r;          // may alias r
  LeafShape s;
};

struct CompressTable {
  int32_t tile0[kMaxLeaves + 1];
  int32_t num_leaves;
  CompressLeaf leaf[kMaxLeaves];
};

struct AggregateLeaf {
  float* out;
  LeafShape s;
};

struct AggregateTable {
  int32_t tile0[kMaxLeaves + 1];
  int32_t num_leaves;
  AggregateLeaf leaf[kMaxLeaves];
};

// The leaf whose tiles hold `tile`: the last l with tile0[l] <= tile.
__device__ __forceinline__ int find_leaf(const int32_t* tile0, int num_leaves,
                                         int tile) {
  int lo = 0, hi = num_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile0[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float compensate(const float* g, const float* r,
                                            int32_t i, float beta,
                                            float gamma) {
  float c = __fmul_rn(g[i], gamma);
  if (r != nullptr) c = __fadd_rn(c, __fmul_rn(r[i], beta));
  return c;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chunk_compress_feedback_kernel(const __grid_constant__ CompressTable tab,
                               void* vals, int32_t* idx, float beta,
                               float gamma, int wire_indices) {
  const int tile = blockIdx.x;
  const int li = find_leaf(tab.tile0, tab.num_leaves, tile);
  const CompressLeaf& L = tab.leaf[li];
  const int tx = threadIdx.x, rg = threadIdx.y;
  const int32_t k = L.s.k, main_rows = L.s.main_rows, rem = L.s.rem;
  const int32_t c = (tile - tab.tile0[li]) * kTileCols + tx;
  const bool live = c < k;
  const float* g = L.g;
  const float* r = L.r;

  __shared__ float s_m[kRowGroups][kTileCols];
  __shared__ float s_v[kRowGroups][kTileCols];
  __shared__ int32_t s_w[kRowGroups][kTileCols];
  __shared__ int32_t s_nan[kRowGroups][kTileCols];
  __shared__ int32_t s_win[kTileCols];
  __shared__ float s_dense[kTileCols];
  // The chunk's compensated values, kept for the residual pass.
  __shared__ float s_c[kRowsPerThread][kRowGroups][kTileCols];

  // The tail row's comp, loaded by warp 0 with its first rows.
  float tc = 0.0f;
  if (rg == 0 && live) {
    if (c < rem) {
      tc = compensate(g, r, main_rows * k + c, beta, gamma);
    } else {                       // zero padding, compensated like real lanes
      tc = __fmul_rn(0.0f, gamma);
      if (r != nullptr) tc = __fadd_rn(tc, __fmul_rn(0.0f, beta));
    }
  }
  // Pass 1: this thread's first row reaching its max |comp|, NaN flagged.
  float m = -1.0f;                 // below every |comp|: a first row takes it
  int32_t w = INT32_MAX;
  float wv = 0.0f, v0 = 0.0f;
  bool nan = false;
  for (int32_t r0 = 0; r0 < main_rows; r0 += kChunkRows) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int32_t row = r0 + rg + j * kRowGroups;
      if (live && row < main_rows) s_c[j][rg][tx] = compensate(g, r, row * k + c, beta, gamma);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int32_t row = r0 + rg + j * kRowGroups;
      if (live && row < main_rows) {
        const float x = s_c[j][rg][tx];
        const float a = fabsf(x);
        if (row == 0) v0 = x;
        if (isnan(a)) {
          nan = true;
        } else if (a > m) {        // strict: ties keep this thread's earlier row
          m = a;
          w = row;
          wv = x;
        }
      }
    }
  }
  s_m[rg][tx] = m;
  s_v[rg][tx] = wv;
  s_w[rg][tx] = w;
  s_nan[rg][tx] = nan;
  __syncthreads();

  if (rg == 0 && live) {
    for (int i = 1; i < kRowGroups; ++i) {
      const float pm = s_m[i][tx];
      const int32_t pw = s_w[i][tx];
      nan |= s_nan[i][tx] != 0;
      if (pm > m || (pm == m && pw < w)) {   // the smaller row wins a tie
        m = pm;
        w = pw;
        wv = s_v[i][tx];
      }
    }
    const float at = fabsf(tc);
    if (isnan(at)) {
      nan = true;
    } else if (at > m) {           // the tail wins only past every main row
      w = main_rows;
      wv = tc;
    }
    if (nan) {                     // no equality fires against a NaN max
      w = 0;
      wv = v0;                     // warp 0 holds row 0
    }
    const float v = __fadd_rn(wv, 0.0f);
    float dense;
    const int64_t o = L.s.koff + c;
    if (BF16) {
      const __nv_bfloat16 b = __float2bfloat16_rn(v);
      static_cast<__nv_bfloat16*>(vals)[o] = b;
      dense = __bfloat162float(b);
    } else {
      static_cast<float*>(vals)[o] = v;
      dense = v;
    }
    idx[o] = wire_indices ? w * k + c : w;
    s_win[tx] = w;
    s_dense[tx] = dense;
  }
  __syncthreads();
  if (!live) return;

  // Pass 2: the new residual, comp everywhere but comp - dense at the winner.
  const int32_t win = s_win[tx];
  const float dense = s_dense[tx];
  const bool one_chunk = main_rows <= kChunkRows;   // s_c still holds comp
  float* out_r = L.out_r;
  for (int32_t r0 = 0; r0 < main_rows; r0 += kChunkRows) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int32_t row = r0 + rg + j * kRowGroups;
      if (row < main_rows) {
        const int32_t i = row * k + c;
        const float x = one_chunk ? s_c[j][rg][tx] : compensate(g, r, i, beta, gamma);
        out_r[i] = (row == win) ? __fsub_rn(x, dense) : x;
      }
    }
  }
  if (rg == 0 && c < rem) {
    out_r[main_rows * k + c] = (win == main_rows) ? __fsub_rn(tc, dense) : tc;
  }
}

template <bool BF16>
__device__ __forceinline__ float load_val(const void* vals, int64_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(vals)[i]);
  return static_cast<const float*>(vals)[i];
}

// vals/idx: (world, stride) row-major; leaf l's columns at koff of a row.
// Dynamic shared memory: the output tile, then each staged rank's rows and
// values (min(world, kAggRankTile) ranks).
template <bool BF16>
__global__ void __launch_bounds__(kTileCols * kAggRowGroups)
chunk_aggregate_dense_kernel(const __grid_constant__ AggregateTable tab,
                             const void* vals, const int32_t* idx,
                             int64_t world, int64_t stride, int wire_indices,
                             int average) {
  extern __shared__ float smem[];
  float (*s_tile)[kTileCols] = reinterpret_cast<float (*)[kTileCols]>(smem);
  int32_t* s_row = reinterpret_cast<int32_t*>(smem + kAggRows * kTileCols);
  const int64_t rank_tile = world < kAggRankTile ? world : kAggRankTile;
  float* s_val = reinterpret_cast<float*>(s_row + rank_tile * kTileCols);

  const int tile = blockIdx.x;
  const int li = find_leaf(tab.tile0, tab.num_leaves, tile);
  const AggregateLeaf& L = tab.leaf[li];
  const int tx = threadIdx.x, rg = threadIdx.y;
  const int32_t k = L.s.k, main_rows = L.s.main_rows, rem = L.s.rem;
  const int32_t c = (tile - tab.tile0[li]) * kTileCols + tx;
  const bool live = c < k;
  const int32_t rows = main_rows + (c < rem ? 1 : 0);   // real rows of column c
  const int32_t tile_rows = main_rows + (rem > 0 ? 1 : 0);

  // Stage ranks [t0, t1): rank i's winning row of column c (-1 when out of
  // range) and value, at slot i - t0.
  auto stage = [&](int64_t t0, int64_t t1) {
    for (int64_t i = t0 + rg; i < t1; i += kAggRowGroups) {
      int32_t row = -1;
      float v = 0.0f;
      if (live) {
        const int64_t e = i * stride + L.s.koff + c;
        const int32_t x = idx[e];
        const int32_t rr = wire_indices ? (x < 0 ? -1 : x / k) : x;
        if (rr >= 0 && rr < rows) row = rr;
        v = load_val<BF16>(vals, e);
      }
      s_row[(i - t0) * kTileCols + tx] = row;
      s_val[(i - t0) * kTileCols + tx] = v;
    }
  };
  const bool one_rank_tile = world <= kAggRankTile;
  if (one_rank_tile) stage(0, world);   // once for every output chunk
  // The mean multiplies by the correctly rounded float reciprocal of W:
  // that is what XLA compiles the reference's `acc / world` to.
  const float inv_world = __fdiv_rn(1.0f, static_cast<float>(world));
  float* out = L.out;
  for (int32_t r0 = 0; r0 < tile_rows; r0 += kAggRows) {
    for (int j = rg; j < kAggRows; j += kAggRowGroups) s_tile[j][tx] = 0.0f;
    for (int64_t t0 = 0; t0 < world; t0 += rank_tile) {
      const int64_t t1 = t0 + rank_tile < world ? t0 + rank_tile : world;
      if (!one_rank_tile) stage(t0, t1);
      __syncthreads();
      // Each distinct winning row of the rank tile is summed once, by its
      // first rank there, over the tile's ranks that chose it, in rank
      // order, onto the partial sum that the earlier tiles left (+0.0 at
      // first). Ranks that did not choose it add +0.0 in the reference,
      // which changes no partial sum that starts at +0.0, so skipping them
      // is exact.
      for (int64_t i = t0 + rg; i < t1; i += kAggRowGroups) {
        const int32_t row = s_row[(i - t0) * kTileCols + tx];
        if (row < r0 || row >= r0 + kAggRows) continue;   // -1 included
        bool seen = false;
        for (int64_t j = t0; j < i; ++j) {
          if (s_row[(j - t0) * kTileCols + tx] == row) { seen = true; break; }
        }
        if (seen) continue;
        float acc = s_tile[row - r0][tx];
        for (int64_t j = i; j < t1; ++j) {
          if (s_row[(j - t0) * kTileCols + tx] == row) {
            acc = __fadd_rn(acc, s_val[(j - t0) * kTileCols + tx]);
          }
        }
        s_tile[row - r0][tx] = acc;
      }
      __syncthreads();         // the tile is summed; the slots may be restaged
    }
    if (live) {
      for (int j = rg; j < kAggRows && r0 + j < rows; j += kAggRowGroups) {
        const float v = s_tile[j][tx];
        out[(r0 + j) * k + c] = average ? __fmul_rn(v, inv_world) : v;
      }
    }
    __syncthreads();             // the tile is rewritten by the next chunk
  }
}

LeafShape leaf_shape(int64_t n, int64_t k, int64_t koff) {
  LeafShape s;
  s.koff = koff;
  s.k = static_cast<int32_t>(k);
  s.main_rows = static_cast<int32_t>(n / k);
  s.rem = static_cast<int32_t>(n - (n / k) * k);
  s.pad = 0;
  return s;
}

// Fills the leaf table from the host rows and checks the tile prefix.
// Returns the number of tiles, or -1 on a malformed table.
template <typename Table, typename Fill>
int64_t fill_table(Table& tab, const int64_t* words, int num_leaves,
                   int row_words, Fill fill) {
  if (num_leaves < 1 || num_leaves > kMaxLeaves) return -1;
  tab.num_leaves = num_leaves;
  int64_t tiles = 0;
  for (int l = 0; l < num_leaves; ++l) {
    const int64_t* w = words + static_cast<int64_t>(l) * row_words;
    const int64_t n = w[row_words - 4], k = w[row_words - 3];
    if (k < 1 || n < k || n > INT32_MAX || w[row_words - 1] != tiles) return -1;
    tab.tile0[l] = static_cast<int32_t>(tiles);
    fill(tab.leaf[l], w);
    tiles += (k + kTileCols - 1) / kTileCols;
    if (tiles > INT32_MAX) return -1;
  }
  tab.tile0[num_leaves] = static_cast<int32_t>(tiles);
  return tiles;
}

template <bool BF16>
cudaError_t launch_aggregate(const AggregateTable& tab, unsigned int grid,
                             size_t smem, cudaStream_t s, const void* vals,
                             const int32_t* idx, int64_t world, int64_t stride,
                             int wire_indices, int average) {
  if (smem > 48 * 1024) {          // past the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_aggregate_dense_kernel<BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chunk_aggregate_dense_kernel<BF16><<<grid, dim3(kTileCols, kAggRowGroups),
                                       smem, s>>>(
      tab, vals, idx, world, stride, wire_indices, average);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// leaves: num_leaves rows of kCompressWords int64 words
//   (g, r or 0, out_r, n, k, koff, first tile); each n >= 2k.
// vals/idx: the concatenated payload; idx receives wire indices win*k + c
// when wire_indices, else the winning rows.
// Returns a cudaError_t (0 = success) of the launch.
int grace_chunk_compress_feedback(const int64_t* leaves, int num_leaves,
                                  void* vals, int32_t* idx, float beta,
                                  float gamma, int wire_bf16, int wire_indices,
                                  void* stream) {
  CompressTable tab;               // copied into the launch's parameters
  const int64_t tiles = fill_table(
      tab, leaves, num_leaves, kCompressWords,
      [](CompressLeaf& leaf, const int64_t* w) {
        leaf.g = reinterpret_cast<const float*>(w[0]);
        leaf.r = reinterpret_cast<const float*>(w[1]);
        leaf.out_r = reinterpret_cast<float*>(w[2]);
        leaf.s = leaf_shape(w[3], w[4], w[5]);
      });
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < num_leaves; ++l) {     // at least two rows
    if (tab.leaf[l].s.main_rows < 2) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTileCols, kRowGroups);
  const unsigned int grid = static_cast<unsigned int>(tiles);
  if (wire_bf16) {
    chunk_compress_feedback_kernel<true><<<grid, block, 0, s>>>(
        tab, vals, idx, beta, gamma, wire_indices);
  } else {
    chunk_compress_feedback_kernel<false><<<grid, block, 0, s>>>(
        tab, vals, idx, beta, gamma, wire_indices);
  }
  return static_cast<int>(cudaGetLastError());
}

// leaves: num_leaves rows of kAggregateWords int64 words
//   (out, n, k, koff, first tile). vals/idx: (world, stride) row-major,
// idx holding wire indices when wire_indices, else winning rows.
int grace_chunk_aggregate_dense(const int64_t* leaves, int num_leaves,
                                const void* vals, const int32_t* idx,
                                int64_t world, int64_t stride, int vals_bf16,
                                int wire_indices, int average, void* stream) {
  AggregateTable tab;
  if (world < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = fill_table(
      tab, leaves, num_leaves, kAggregateWords,
      [](AggregateLeaf& leaf, const int64_t* w) {
        leaf.out = reinterpret_cast<float*>(w[0]);
        leaf.s = leaf_shape(w[1], w[2], w[3]);
      });
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t staged = world < kAggRankTile ? world : kAggRankTile;
  const size_t smem = static_cast<size_t>(kAggRows) * kTileCols * 4 +
                      static_cast<size_t>(staged) * kTileCols * 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(tiles);
  const cudaError_t err =
      vals_bf16 ? launch_aggregate<true>(tab, grid, smem, s, vals, idx, world,
                                         stride, wire_indices, average)
                : launch_aggregate<false>(tab, grid, smem, s, vals, idx, world,
                                          stride, wire_indices, average);
  return static_cast<int>(err);
}

}  // extern "C"

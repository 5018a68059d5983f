// Forest scoring for Hopper (sm_90a): the card's counterpart of the
// reference's fused forest scorer, h2o3_tpu/models/tree.py ::
// predict_forest_fused (:1057) over build_score_table (:1015), a jnp
// program, not a Pallas kernel. Entries h2o3_forest_score_resident and
// h2o3_forest_score_streamed.
//
// Computes out[r] = sum over trees t, in tree order from 0.0f, of
// value[t, leaf(t, r)] in float32, where leaf(t, r) walks the heap of tree
// t from the root for at most `depth` steps: at a split node i the row goes
// right (2i + 2) when its feature value is NaN or greater than the
// threshold, else left (2i + 1); a node that is not split holds the row.
// Depth 0 returns the root values. The sum order is the plain twin's,
// models/tree.py::predict_forest_ordered, so the result equals it bit for
// bit.
//
// Inputs: the packed score table, one 8-byte record {float thr; int32 feat}
// per node ((nt, T) int2, built once per model by
// ops/score_cuda.py::build_score_pack): feat is -1 where the node is not
// split and already clamped into [0, F) elsewhere (the reference's
// `take(..., mode="clip")`), so no read leaves X; the model's leaf values
// (nt, T) float32, read in place; X (N, F) float32 row-major; T >=
// 2^(depth+1) - 1.
//
// Bound. A walk reads, per step, one node's fields and one feature of its
// row, and at its end one leaf value. Counting each input byte once: X and
// the output ((4F + 4) N bytes) and the forest's fields as the model stores
// them that the walks must read: is_split (1 byte) of every reachable node
// above the last level, feat and thr (8 bytes) of every reachable split
// node, value (4 bytes) of every reachable leaf (a node is reachable when
// it is a root or a child of a reachable split node above the last level).
// The DRF forest (50 trees, depth 19) puts ~10^8 records behind ~10^9
// data-dependent steps, so latency, not that bound, sets the time.
//
// What bounded the first design (one thread per row over all trees, three
// node arrays read through __ldg): three scattered 32-byte sectors a step
// (is_split, feat, thr), a dependent load of the row's feature from global
// memory after each node load, and one serial chain of nt * depth steps a
// thread, so at small N a few threads walked 120 (GBM) to ~950 (DRF)
// dependent L2 round trips each.
//
// This design. One 8-byte record a step instead of three fields; the
// block's rows of X are staged in shared memory by coalesced asynchronous
// copies (row stride F | 1, so 32 rows at one feature fall in 32 banks)
// and every feature read is a shared-memory read; each thread keeps
// several trees' walks in flight as independent chains, their steps
// branch-free. Two launch plans, chosen by the wrapper from the
// staged sizes (score_cuda.score_plan), neither a fallback of the other:
//
// (a) resident, for forests whose records (levels < depth) and leaf values
//     (levels <= depth) fit a block's shared memory beside a tile of rows
//     (the GBM's 20 trees of depth 6: 20,240 bytes). Each block stages the
//     whole forest once, then walks tiles of kThreads rows (persistent
//     blocks, as many as fit the SMs at once): each thread walks its row
//     through kChains trees at a time and adds their leaf values in tree
//     order into one register. One launch, no scratch; every step is two
//     shared-memory reads.
// (b) streamed, for larger forests (the DRF's 50 trees of 2^20 - 1 nodes,
//     8 MB of records each). The grid is tree-major: block b takes the
//     chunk of C trees b / R and the row range b % R, so the blocks
//     resident at once share one or two chunks, whose deep records stay in
//     the 50 MB L2. A block stages its chunk's levels < S in shared memory
//     (8 (2^S - 1) bytes a tree), walks them there and the deeper levels
//     from global memory (one 8-byte load a step), C trees in flight per
//     thread, and writes each tree's leaf value into an (nt, N) scratch; a
//     second kernel folds the scratch over the trees in order. The scratch
//     costs 8 nt N bytes of traffic (written once, read once).
//
// C is kChunk = 2, fixed at compile time (SCORE_STREAM_CHUNK; the wrapper's
// score_cuda.STREAM_CHUNK names the same number); S and the rows per block
// are arguments the wrapper computes (STREAM_LEVELS = 12,
// stream_rows_per_block: as few rows a block as let one chunk fill the
// blocks the card holds at once, 3840 at 1M rows). tools/score_plans.py
// --sweep (C by -DSCORE_STREAM_CHUNK builds of its own) on an H100 80GB
// HBM3 at 700 W, on the smoke's 1M-row DRF forest, L2 warm: C = 2 with S
// in {10, 11, 12} and C = 4 with S in {10, 11}, each at half to twice
// those rows, all lie within 8 % of each other (2.80-3.02 ms; this plan
// 2.85 before the sweep and 2.86 after); S = 8 (3.88-5.01) and C = 1
// (3.07-4.34) are slower, and so is any plan of more than ~114 KB, one
// block an SM (C = 4 with S = 12, C = 2 with S = 13: 3.84-4.47). Reading
// the rows from global memory instead of staging them is 1.4-5.4x slower
// on both plans. A feature-major tile (conflict-free reads of x[f], each
// thread copying its own row) was tried, was slower on both plans for its
// uncoalesced staging, and was not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // one row per thread; a tile of rows
constexpr int kChains = 4;         // trees in flight per thread (resident)
#ifndef SCORE_STREAM_CHUNK
#define SCORE_STREAM_CHUNK 2
#endif
constexpr int kChunk = SCORE_STREAM_CHUNK;   // trees per streamed block
static_assert(kChunk >= 1 && kChunk <= 8, "a streamed chunk of 1 to 8 trees");
constexpr int kDefaultSmem = 48 * 1024;

// an asynchronous copy of kBytes (4 or 8) from global to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ceil(2^32 / F): j * fmagic >> 32 is j / F for every j < 2^32 / F (a
// tile's j < kThreads * F, and X is staged only for F < 4096)
__device__ __forceinline__ unsigned long long div_magic(int n) {
  return (0x100000000ull + n - 1) / n;
}

// issue the copies of rows [row0, row0 + nrows) of row-major X (N, F) into
// xs, row stride ldx: the tile is contiguous in X, so thread j copies float
// j (coalesced) to row j / F, column j % F
__device__ __forceinline__ void stage_rows(float* xs, const float* X,
                                           int row0, int nrows, int n_feat,
                                           int ldx,
                                           unsigned long long fmagic) {
  const float* src = X + (size_t)row0 * n_feat;
  const int total = nrows * n_feat;
  for (int j = threadIdx.x; j < total; j += kThreads) {
    const int r = (int)(((unsigned long long)j * fmagic) >> 32);
    cp_async<4>(xs + j + r * (ldx - n_feat), src + j);
  }
}

// one step of a walk from a record: to the child, or, where the node is
// not split, nowhere; true where it moved. Branch-free, so a thread's
// chains issue their loads together; a chain that holds reads its record
// again and stays.
__device__ __forceinline__ bool step(int2 rec, const float* x, int& node) {
  const bool go = rec.y >= 0;
  const float xv = x[go ? rec.y : 0];
  const int right = (isnan(xv) || xv > __int_as_float(rec.x)) ? 1 : 0;
  node = go ? 2 * node + 1 + right : node;
  return go;
}

template <bool kStageX>
__global__ void __launch_bounds__(kThreads)
forest_score_resident(const int2* __restrict__ pack,
                      const float* __restrict__ value,
                      const float* __restrict__ X, float* __restrict__ out,
                      int n_rows, int n_feat, int n_trees, long long n_nodes,
                      int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rec_nodes = (1 << depth) - 1;   // levels a walk reads records of
  const int val_nodes = (2 << depth) - 1;   // levels it may end on
  int2* recs = reinterpret_cast<int2*>(smem);
  float* vals = reinterpret_cast<float*>(recs + n_trees * rec_nodes);
  float* xs = vals + n_trees * val_nodes;
  const int ldx = n_feat | 1;

  const unsigned long long fmagic = div_magic(n_feat);

  for (int j = threadIdx.x; j < n_trees * rec_nodes; j += kThreads) {
    const int t = j / rec_nodes;
    cp_async<8>(recs + j, pack + (size_t)t * n_nodes + (j - t * rec_nodes));
  }
  for (int j = threadIdx.x; j < n_trees * val_nodes; j += kThreads) {
    const int t = j / val_nodes;
    cp_async<4>(vals + j, value + (size_t)t * n_nodes + (j - t * val_nodes));
  }

  const int n_tiles = (n_rows + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kThreads;
    const int nrows = min(kThreads, n_rows - row0);
    __syncthreads();   // the last tile's rows are read
    if (kStageX) stage_rows(xs, X, row0, nrows, n_feat, ldx, fmagic);
    cp_async_wait_all();   // this tile's rows (and, first, the forest)
    __syncthreads();
    const int r = threadIdx.x;
    if (r >= nrows) continue;
    const float* x = kStageX ? xs + r * ldx : X + (size_t)(row0 + r) * n_feat;
    float acc = 0.0f;
    for (int t0 = 0; t0 < n_trees; t0 += kChains) {
      // the chains past the last tree walk the last tree again, unread
      int node[kChains], base[kChains];
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        node[k] = 0;
        base[k] = min(t0 + k, n_trees - 1) * rec_nodes;
      }
      for (int d = 0; d < depth; ++d) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < kChains; ++k)
          any |= step(recs[base[k] + node[k]], x, node[k]);
        if (!any) break;
      }
#pragma unroll
      for (int k = 0; k < kChains; ++k)
        if (t0 + k < n_trees) acc += vals[(t0 + k) * val_nodes + node[k]];
    }
    out[row0 + r] = acc;
  }
}

template <bool kStageX>
__global__ void __launch_bounds__(kThreads)
forest_score_streamed(const int2* __restrict__ pack,
                      const float* __restrict__ value,
                      const float* __restrict__ X,
                      float* __restrict__ scratch, int n_rows, int n_feat,
                      int n_trees, long long n_nodes, int depth,
                      int staged_levels, int rows_per_block, int row_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x / row_blocks;
  const int rb = blockIdx.x - chunk * row_blocks;
  const int t0 = chunk * kChunk;
  const int nk = min(kChunk, n_trees - t0);
  const int sl = min(staged_levels, depth);
  const int snodes = (1 << sl) - 1;
  int2* recs = reinterpret_cast<int2*>(smem);
  float* xs = reinterpret_cast<float*>(recs + kChunk * snodes);
  const int ldx = n_feat | 1;

  const unsigned long long fmagic = div_magic(n_feat);

  for (int j = threadIdx.x; j < nk * snodes; j += kThreads) {
    const int k = j / snodes;
    cp_async<8>(recs + j, pack + (size_t)(t0 + k) * n_nodes + (j - k * snodes));
  }
  // the chains past the chunk's last tree walk that tree again, unwritten
  const int2* gpack[kChunk];
  const float* gval[kChunk];
  int sbase[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int kk = min(k, nk - 1);
    gpack[k] = pack + (size_t)(t0 + kk) * n_nodes;
    gval[k] = value + (size_t)(t0 + kk) * n_nodes;
    sbase[k] = kk * snodes;
  }

  const int row_lo = rb * rows_per_block;
  const int row_hi = min(n_rows, row_lo + rows_per_block);
  for (int row0 = row_lo; row0 < row_hi; row0 += kThreads) {
    const int nrows = min(kThreads, row_hi - row0);
    __syncthreads();   // the last tile's rows are read
    if (kStageX) stage_rows(xs, X, row0, nrows, n_feat, ldx, fmagic);
    cp_async_wait_all();   // this tile's rows (and, first, the chunk)
    __syncthreads();
    const int r = threadIdx.x;
    if (r >= nrows) continue;
    const float* x = kStageX ? xs + r * ldx : X + (size_t)(row0 + r) * n_feat;
    int node[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) node[k] = 0;
    for (int d = 0; d < depth; ++d) {
      // every walk that moves stands on level d, so the source is uniform
      bool any = false;
      if (d < sl) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          any |= step(recs[sbase[k] + node[k]], x, node[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          any |= step(__ldg(gpack[k] + node[k]), x, node[k]);
      }
      if (!any) break;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < nk)
        scratch[(size_t)(t0 + k) * n_rows + row0 + r] = __ldg(gval[k] + node[k]);
  }
}

// out[r] = sum over t in order, from 0.0f, of scratch[t, r]
__global__ void __launch_bounds__(kThreads)
forest_score_fold(const float* __restrict__ scratch, float* __restrict__ out,
                  int n_rows, int n_trees) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int t = 0; t < n_trees; ++t)
    acc += __ldg(scratch + (size_t)t * n_rows + row);
  out[row] = acc;
}

bool shape_ok(int n_rows, int n_feat, int n_trees, long long n_nodes,
              int depth) {
  return n_rows > 0 && n_feat > 0 && n_trees > 0 && depth >= 0 &&
         depth <= 30 && n_nodes >= (2LL << depth) - 1 &&
         n_nodes <= 0x7fffffffLL;
}

int x_tile_bytes(int n_feat, int stage_x) {
  return stage_x ? kThreads * (n_feat | 1) * (int)sizeof(float) : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// The resident plan: `blocks` persistent blocks of `smem` bytes of dynamic
// shared memory (at least the staged forest and, with stage_x, a tile of
// rows). Returns a cudaError_t.
extern "C" int h2o3_forest_score_resident(const void* pack, const void* value,
                                          const void* X, void* out,
                                          int n_rows, int n_feat, int n_trees,
                                          long long n_nodes, int depth,
                                          int stage_x, int blocks, int smem,
                                          void* stream) {
  if (!shape_ok(n_rows, n_feat, n_trees, n_nodes, depth) || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long need =
      (long long)n_trees * (8LL * ((1LL << depth) - 1) + 4LL * ((2LL << depth) - 1)) +
      x_tile_bytes(n_feat, stage_x);
  if (smem < need) return (int)cudaErrorInvalidValue;
  // every block takes at least one tile (and so waits for its copies)
  const int n_tiles = (n_rows + kThreads - 1) / kThreads;
  if (blocks > n_tiles) blocks = n_tiles;
  auto* kernel = stage_x ? forest_score_resident<true>
                         : forest_score_resident<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(pack), static_cast<const float*>(value),
      static_cast<const float*>(X), static_cast<float*>(out), n_rows, n_feat,
      n_trees, n_nodes, depth);
  return (int)cudaGetLastError();
}

// The streamed plan: the walk over chunks of kChunk trees and row ranges
// of `rows_per_block` rows into scratch (nt, N), then the fold into out
// (N). Returns a cudaError_t.
extern "C" int h2o3_forest_score_streamed(
    const void* pack, const void* value, const void* X, void* scratch,
    void* out, int n_rows, int n_feat, int n_trees, long long n_nodes,
    int depth, int staged_levels, int rows_per_block, int stage_x, int smem,
    void* stream) {
  if (!shape_ok(n_rows, n_feat, n_trees, n_nodes, depth) ||
      staged_levels < 0 || staged_levels > 15 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int sl = staged_levels < depth ? staged_levels : depth;
  const long long need =
      8LL * kChunk * ((1LL << sl) - 1) + x_tile_bytes(n_feat, stage_x);
  if (smem < need) return (int)cudaErrorInvalidValue;
  const int row_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const long long grid =
      (long long)((n_trees + kChunk - 1) / kChunk) * row_blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  auto* kernel = stage_x ? forest_score_streamed<true>
                         : forest_score_streamed<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(int)grid, kThreads, smem, s>>>(
      static_cast<const int2*>(pack), static_cast<const float*>(value),
      static_cast<const float*>(X), sc, n_rows, n_feat, n_trees, n_nodes,
      depth, staged_levels, rows_per_block, row_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  forest_score_fold<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      sc, static_cast<float*>(out), n_rows, n_trees);
  return (int)cudaGetLastError();
}

// The streamed plan's trees per block, as compiled.
extern "C" int h2o3_forest_score_stream_chunk() { return kChunk; }

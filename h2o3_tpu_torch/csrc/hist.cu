// Gradient histograms for Hopper (sm_90a): the ports of the two TPU kernels
// of h2o3_tpu/ops/hist_pallas.py. This part is build_histograms_pallas_factored
// (kernel body _hist_kernel_factored); the port of build_histograms_pallas
// (_hist_kernel), entry h2o3_hist_build_rows, follows further down.
//
// Computes out[l, f, b, c] = sum over rows r with node[r] == l and
// codes[f, r] == b of vals[c, r], for the channels c = {w, g*w, h*w}:
// the (L, F, B, 3) float32 histogram of one tree level.
//
// Inputs: codes (F, N) uint8 feature-major (a warp reads 32 neighbouring
// rows of one feature: one 32-byte sector), node (N,) int32, vals (3, N)
// float32. Rows whose node id or code is out of range match no bin (the
// TPU kernel pads with code -1 for the same effect).
//
// Bound: bytes. A pass reads N*F code bytes plus 16*N bytes of node and
// values and writes L*F*B*3 floats; it does about 3*N*F adds. At the bench
// shape (N = 1e6, F = 28) that is ~44 MB and ~84 M adds, far below the
// card's arithmetic rate, so device-memory bandwidth bounds it.
//
// Design. The TPU kernel builds a one-hot matrix and multiplies, because a
// TPU has no scatter atomics. Hopper has fast shared-memory atomics, so
// here each block keeps a private float32 histogram of nl*B*3 floats per
// feature, for a block of features and a slice of nl nodes, in shared
// memory and adds each row into it with atomicAdd (shared memory only).
// Grid = (row blocks, feature blocks, node slices): each block walks its
// row range once, skips the rows whose node lies outside its slice, and
// for the others loads the values once and the code once per feature of
// the block. A level whose L*B*3 histogram of one feature outgrows shared
// memory (deep trees, wide categorical bins) is split into node slices;
// at the bench shape there is one slice. The block then writes its
// histogram as one per-row-block partial to global memory, and a second
// kernel folds the partials over row blocks left to right, in a fixed
// order (the structure of the reference's n_shard_blocks fold).
// Accumulation is float32 throughout; the operands are not rounded to
// bf16 as on the TPU. The order of the shared-memory atomics varies from
// run to run, so the last bits of a sum can too; the fixed-point
// deterministic variant is left to the kernel's redesign (ROADMAP B1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hist_partial_kernel(const uint8_t* __restrict__ codes,
                                    const int32_t* __restrict__ node,
                                    const float* __restrict__ vals,
                                    float* __restrict__ partials,
                                    int n_rows, int n_feat, int n_nodes,
                                    int n_bins, int rows_per_block,
                                    int feats_per_block, int nodes_per_block) {
  extern __shared__ float hist[];  // (nf, nl, B, 3)
  const int f0 = blockIdx.y * feats_per_block;
  const int nf = min(feats_per_block, n_feat - f0);
  const int l0 = blockIdx.z * nodes_per_block;
  const int nl = min(nodes_per_block, n_nodes - l0);
  const int slab = nl * n_bins * 3;
  const int n_sh = nf * slab;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_rows);
  const size_t stride = (size_t)n_rows;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int l = node[r] - l0;
    if ((unsigned)l >= (unsigned)nl) continue;  // another slice's node
    const float v0 = vals[r];
    const float v1 = vals[stride + r];
    const float v2 = vals[2 * stride + r];
    // rows with all-zero values (zero weight: padding, the right-hand
    // siblings of a sibling-subtraction pass) add nothing
    if (v0 == 0.0f && v1 == 0.0f && v2 == 0.0f) continue;
    float* row_hist = hist + l * n_bins * 3;
    const uint8_t* c = codes + (size_t)f0 * stride + r;
    for (int j = 0; j < nf; ++j) {
      const int b = c[(size_t)j * stride];
      if (b >= n_bins) continue;
      float* h = row_hist + j * slab + b * 3;
      atomicAdd(h, v0);
      atomicAdd(h + 1, v1);
      atomicAdd(h + 2, v2);
    }
  }
  __syncthreads();

  // this row block's partial: partials[blockIdx.x, f0:f0+nf, l0:l0+nl, B, 3]
  const size_t full = (size_t)n_nodes * n_bins * 3;
  float* dst = partials + ((size_t)blockIdx.x * n_feat + f0) * full +
               (size_t)l0 * n_bins * 3;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x)
    dst[(size_t)(i / slab) * full + i % slab] = hist[i];
}

// out (L, F, B, 3) = left fold of partials (R, F, L, B, 3) over R.
__global__ void hist_fold_kernel(const float* __restrict__ partials,
                                 float* __restrict__ out, int n_parts,
                                 int n_feat, int n_nodes, int n_bins) {
  const int total = n_nodes * n_feat * n_bins * 3;
  const size_t part = (size_t)total;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int bc = i % (n_bins * 3);
    const int f = (i / (n_bins * 3)) % n_feat;
    const int l = i / (n_bins * 3 * n_feat);
    const size_t src = ((size_t)f * n_nodes + l) * n_bins * 3 + bc;
    float acc = partials[src];
    for (int p = 1; p < n_parts; ++p) acc += partials[src + p * part];
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// The port of the second TPU kernel, h2o3_tpu/ops/hist_pallas.py::
// build_histograms_pallas (kernel body _hist_kernel): the same (L, F, B, 3)
// histogram from ROW-MAJOR codes (N, F) uint8, the layout that kernel takes.
//
// Bound: bytes, as for the kernel above: the codes of the weighted rows,
// 16*N bytes of node ids and values, and the L*F*B*3 f32 output once; about
// 3 adds per weighted (row, feature) pair. At a dense rebuild's widest pass
// (L = 2^17 parents at F = 28, B = 21) the output alone is 924 MB.
//
// Design: node-bucketed. The TPU kernel one-hots each feature against
// node*B + code inside a VMEM tile. Here the rows are first put in node
// order by a counting sort, so that one block can keep the histograms of a
// group of G consecutive nodes in shared memory and write that group's slab
// of the output, which is contiguous in (L, F, B, 3), once. One memset of
// the node counters and four launches:
//  1. count: the rows with a nonzero value and a node id in [0, L) are
//     counted per node with warp-aggregated atomics (one per distinct node
//     of a warp), into per-block shared counters while L fits them, else
//     into the global counters; each row keeps its rank within its node.
//  2. scan (one block, tiles read and written coalesced through shared
//     memory): the exclusive prefix of the counts gives each node's first
//     position in node order; each group of G nodes gets its number of
//     chunks of C rows (at least one, so that a group without rows still
//     writes its zeros), their exclusive prefix, and a chunk-to-group map.
//  3. scatter: each counted row writes {row id, w, g*w, h*w} (16 bytes) to
//     its position, so the main kernel reads its rows in order; the last
//     blocks of the launch zero the slabs of the groups of several chunks.
//  4. main: one block per (chunk, feature block). The grid is sized on the
//     host from N, L and C alone (groups + N / C chunk slots at most), so
//     nothing is read back; spare blocks exit. A block reads its group from
//     the map, zeroes a (G, fb, B, 3) f32 histogram in shared memory and
//     walks the chunk's (row, feature) pairs in row order: neighbouring
//     threads take neighbouring code bytes of one row, so a warp's
//     shared-memory atomics spread over features. It writes the slab with
//     plain coalesced stores, zeros included, when its group has one chunk,
//     and adds its nonzero entries with atomicAdd into the zeroed slab when
//     the group has several. Chunks are what keep a node of 10^5 rows
//     (decided leaves flow left at dense levels) from holding one SM for
//     milliseconds.
// The output is never memset as a whole, and no (row, feature) pair touches
// a device-memory atomic. f32 atomicAdd on shared memory is a compare-and-
// swap loop on sm_90a (ATOMS.CAST.SPIN in the SASS), and its rate is what
// bounds a pass of 10^7 pairs (tools/hist_rows_routes.py --profile). Sums are
// f32; the order of the atomics varies from run to run, and so can the last
// bits of a sum.

constexpr int kBucketThreads = 512;  // count and scatter blocks
constexpr int kCountItems = 8;       // rows per thread of the count kernel
constexpr int kCountSmemNodes = 8192;  // per-block counters up to this L
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;        // counts per thread and tile
constexpr int kScanTile = kScanThreads * kScanItems;  // hist_cuda.SCAN_TILE
constexpr int kZeroBlocks = 1024;

template <bool kSharedCounts>
__global__ void hist_rows_count_kernel(const int32_t* __restrict__ node,
                                       const float* __restrict__ vals,
                                       int* __restrict__ counts,
                                       int* __restrict__ rank, int n_rows,
                                       int n_nodes) {
  extern __shared__ int scount[];  // (L,) this block's counts
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t stride = (size_t)n_rows;
  if (kSharedCounts) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) scount[i] = 0;
    __syncthreads();
  }
  const int r0 = blockIdx.x * blockDim.x * kCountItems + threadIdx.x;
  int key[kCountItems], pos[kCountItems];
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    const int r = r0 + k * blockDim.x;
    int l = -1;  // -1: the row is not bucketed
    if (r < n_rows) {
      const int nd = node[r];
      const float v0 = vals[r];
      const float v1 = vals[stride + r];
      const float v2 = vals[2 * stride + r];
      // zero-weight rows (padding, out-of-bag rows, the right-hand siblings
      // of a sibling-subtraction pass) and foreign node ids add nothing
      if ((unsigned)nd < (unsigned)n_nodes &&
          !(v0 == 0.0f && v1 == 0.0f && v2 == 0.0f))
        l = nd;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (l >= 0 && lane == leader)
      base = atomicAdd(kSharedCounts ? scount + l : counts + l,
                       __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    key[k] = l;
    pos[k] = base + __popc(peers & below);
  }
  if (kSharedCounts) {
    // the block's counts go to the global counters, and what those held
    // before becomes this block's base within each node
    __syncthreads();
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
      const int c = scount[i];
      if (c) scount[i] = atomicAdd(counts + i, c);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    const int r = r0 + k * blockDim.x;
    if (r < n_rows)
      rank[r] = key[k] < 0 ? -1
                           : pos[k] + (kSharedCounts ? scount[key[k]] : 0);
  }
}

// Exclusive prefix of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < n_warps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sum[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[n_warps - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return before + x - v;
}

// buf[0, n_tiles * kScanTile) becomes its exclusive prefix sum, in place, by
// the whole block (kScanThreads threads). Each tile is read and written with
// coalesced 16-byte accesses through shared memory (the next tile's loads
// are in flight meanwhile), and each thread scans kScanItems neighbours.
__device__ void block_scan_tiles(int* buf, int n_tiles) {
  constexpr int kVec = kScanItems / 4;  // int4 per thread
  __shared__ int4 tile[kScanTile / 4];
  int4* g4 = reinterpret_cast<int4*>(buf);
  const int t = threadIdx.x;
  int4 next[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) next[k] = g4[k * kScanThreads + t];
  int carry = 0, total;
  for (int tl = 0; tl < n_tiles; ++tl) {
    int4* at = g4 + (size_t)tl * (kScanTile / 4);
#pragma unroll
    for (int k = 0; k < kVec; ++k) tile[k * kScanThreads + t] = next[k];
    if (tl + 1 < n_tiles) {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        next[k] = at[kScanTile / 4 + k * kScanThreads + t];
    }
    __syncthreads();
    int4 q[kVec];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      q[k] = tile[kVec * t + k];
      sum += q[k].x + q[k].y + q[k].z + q[k].w;
    }
    int run = carry + block_exclusive_sum(sum, &total);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      int4 o;
      o.x = run;
      run += q[k].x;
      o.y = run;
      run += q[k].y;
      o.z = run;
      run += q[k].z;
      o.w = run;
      run += q[k].w;
      tile[kVec * t + k] = o;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      at[k * kScanThreads + t] = tile[k * kScanThreads + t];
    carry += total;
    __syncthreads();  // the tile is free for the next one
  }
}

// offs holds node_tiles * kScanTile counts, zero past L; they become their
// exclusive prefix in place, so offs[l] is node l's first position in node
// order and offs[L] the number of bucketed rows. chunk0 (group_tiles *
// kScanTile ints) gets the first chunk of each group g, so chunk0[groups]
// is the number of chunks; chunk_group[c] is the group of chunk c.
__global__ void hist_rows_scan_kernel(int* __restrict__ offs,
                                      int* __restrict__ chunk0,
                                      int* __restrict__ chunk_group,
                                      int node_tiles, int group_tiles,
                                      int n_nodes, int group_nodes,
                                      int chunk_rows) {
  block_scan_tiles(offs, node_tiles);  // ends with a barrier
  const int n_groups = (n_nodes + group_nodes - 1) / group_nodes;
  // each group's chunks of C rows: at least one, so that a group without
  // rows still writes its zeros
  for (int g = threadIdx.x; g < group_tiles * kScanTile; g += blockDim.x) {
    int c = 0;
    if (g < n_groups) {
      const int rows = offs[min((g + 1) * group_nodes, n_nodes)] -
                       offs[g * group_nodes];
      c = max(1, (rows + chunk_rows - 1) / chunk_rows);
    }
    chunk0[g] = c;
  }
  __syncthreads();
  block_scan_tiles(chunk0, group_tiles);
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x)
    for (int c = chunk0[g]; c < chunk0[g + 1]; ++c) chunk_group[c] = g;
}

// dst[0, n) = src[0, n) (src in shared memory), or zeros when src is null,
// by the whole block: 16-byte stores from the first 16-byte-aligned float
// of dst on.
__device__ void block_store(float* dst, const float* src, int n) {
  const int head = min(
      n, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    dst[i] = src ? src[i] : 0.0f;
  const int n4 = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const bool src16 =
      src && (reinterpret_cast<uintptr_t>(src + head) & 15) == 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (src16) {
      v = reinterpret_cast<const float4*>(src + head)[i];
    } else if (src) {
      const float* s = src + head + 4 * i;
      v = make_float4(s[0], s[1], s[2], s[3]);
    }
    d4[i] = v;
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src ? src[i] : 0.0f;
}

// dst[i] += src[i] for the nonzero src[i], i < n, by the whole block.
__device__ void block_add(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = src[i];
    if (v != 0.0f) atomicAdd(dst + i, v);
  }
}

// Blocks [0, row_blocks): each bucketed row's record {row id, w, g*w, h*w}
// goes to its position in node order. The blocks after them zero the output
// slabs of the groups that have several chunks.
__global__ void hist_rows_scatter_kernel(const int32_t* __restrict__ node,
                                         const float* __restrict__ vals,
                                         const int* __restrict__ rank,
                                         const int* __restrict__ offs,
                                         const int* __restrict__ chunk0,
                                         float4* __restrict__ recs,
                                         float* __restrict__ out, int n_rows,
                                         int row_blocks, int n_nodes,
                                         int group_nodes, int node_floats) {
  if ((int)blockIdx.x >= row_blocks) {
    const int n_groups = (n_nodes + group_nodes - 1) / group_nodes;
    for (int g = blockIdx.x - row_blocks; g < n_groups;
         g += gridDim.x - row_blocks) {
      if (chunk0[g + 1] - chunk0[g] < 2) continue;
      const int l0 = g * group_nodes;
      block_store(out + (size_t)l0 * node_floats, nullptr,
                  min(group_nodes, n_nodes - l0) * node_floats);
    }
    return;
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int k = rank[r];
  if (k < 0) return;
  const size_t stride = (size_t)n_rows;
  recs[offs[node[r]] + k] = make_float4(__int_as_float(r), vals[r],
                                        vals[stride + r],
                                        vals[2 * stride + r]);
}

__global__ void hist_rows_bucket_kernel(const uint8_t* __restrict__ codes,
                                        const float4* __restrict__ recs,
                                        const int* __restrict__ offs,
                                        const int* __restrict__ chunk0,
                                        const int* __restrict__ chunk_group,
                                        float* __restrict__ out, int n_feat,
                                        int n_nodes, int n_bins,
                                        int group_nodes, int feats_per_block,
                                        int chunk_rows) {
  // shared: (G + 1,) node offsets, then the (G, fb, B, 3) f32 histogram
  extern __shared__ __align__(16) int soff[];
  const int n_groups = (n_nodes + group_nodes - 1) / group_nodes;
  const int s = blockIdx.x;
  if (s >= chunk0[n_groups]) return;  // a spare block of the static grid
  const int g = chunk_group[s];
  const bool single = chunk0[g + 1] - chunk0[g] == 1;
  const int l0 = g * group_nodes;
  const int nl = min(group_nodes, n_nodes - l0);
  const int f0 = blockIdx.y * feats_per_block;
  const int nf = min(feats_per_block, n_feat - f0);
  const int per = n_bins * 3;  // floats of one (node, feature) histogram
  const int r0 = offs[l0] + (s - chunk0[g]) * chunk_rows;
  const int nr = min(chunk_rows, offs[l0 + nl] - r0);
  // the slab in the output: one run when the block has every feature, else
  // one run of nf features per node
  const bool whole = nf == n_feat;
  const int n_runs = whole ? 1 : nl;
  const int run = whole ? nl * nf * per : nf * per;
  auto dst = [&](int q) {
    return out + ((size_t)(l0 + q) * n_feat + f0) * per;
  };
  if (nr <= 0) {  // a group without rows: its one chunk writes zeros
    for (int q = 0; q < n_runs; ++q) block_store(dst(q), nullptr, run);
    return;
  }
  float* hist = reinterpret_cast<float*>(soff + ((group_nodes + 4) & ~3));
  const int slab4 = (nl * nf * per + 3) >> 2;
  for (int i = threadIdx.x; i < slab4; i += blockDim.x)
    reinterpret_cast<float4*>(hist)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i <= nl; i += blockDim.x) soff[i] = offs[l0 + i];
  __syncthreads();

  // the chunk's (row, feature) pairs in row order; the rows are in node
  // order, so a thread finds each row's node by walking soff forward
  const int n_pairs = nr * nf;
  const int di = blockDim.x / nf;
  const int dj = blockDim.x - di * nf;
  int i = threadIdx.x / nf;
  int j = threadIdx.x - i * nf;
  int n = 0;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int at = r0 + i;
    while (soff[n + 1] <= at) ++n;
    const float4 rec = __ldg(recs + at);
    const uint8_t* row = codes + (size_t)__float_as_int(rec.x) * n_feat;
    const int b = __ldg(row + f0 + j);
    if (b < n_bins) {
      float* h = hist + ((n * nf + j) * n_bins + b) * 3;
      atomicAdd(h, rec.y);
      atomicAdd(h + 1, rec.z);
      atomicAdd(h + 2, rec.w);
    }
    i += di;
    j += dj;
    if (j >= nf) {
      j -= nf;
      ++i;
    }
  }
  __syncthreads();
  for (int q = 0; q < n_runs; ++q) {
    if (single) block_store(dst(q), hist + q * run, run);
    else block_add(dst(q), hist + q * run, run);
  }
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int h2o3_hist_build(const void* codes, const void* node,
                               const void* vals, void* partials, void* out,
                               int n_rows, int n_feat, int n_nodes, int n_bins,
                               int rows_per_block, int feats_per_block,
                               int nodes_per_block, int n_row_blocks,
                               int threads, int smem_bytes,
                               int fold_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_feat_blocks = (n_feat + feats_per_block - 1) / feats_per_block;
  const int n_node_slices = (n_nodes + nodes_per_block - 1) / nodes_per_block;
  dim3 grid(n_row_blocks, n_feat_blocks, n_node_slices);
  hist_partial_kernel<<<grid, threads, smem_bytes, s>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(node),
      static_cast<const float*>(vals), static_cast<float*>(partials), n_rows,
      n_feat, n_nodes, n_bins, rows_per_block, feats_per_block,
      nodes_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hist_fold_kernel<<<fold_blocks, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out),
      n_row_blocks, n_feat, n_nodes, n_bins);
  return (int)cudaGetLastError();
}


// The row-major entry (B2): the node-bucketed histogram on `stream`, in
// one memset and four launches. Scratch: `offs` (node_tiles * kScanTile
// ints), `chunk0` (group_tiles * kScanTile ints), `chunk_group` (n_slots
// ints), `rank` (N ints) and `recs` (N float4). `out` is written whole.
// Returns the first CUDA error (0 = ok).
extern "C" int h2o3_hist_build_rows(
    const void* codes, const void* node, const void* vals, void* offs,
    void* chunk0, void* chunk_group, void* rank, void* recs, void* out,
    int n_rows, int n_feat, int n_nodes, int n_bins, int group_nodes,
    int feats_per_block, int chunk_rows, int node_tiles, int group_tiles,
    int n_slots, int threads, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int32_t* nd = static_cast<const int32_t*>(node);
  const float* v = static_cast<const float*>(vals);
  int* off = static_cast<int*>(offs);
  int* c0 = static_cast<int*>(chunk0);
  int* cg = static_cast<int*>(chunk_group);
  int* rk = static_cast<int*>(rank);
  float4* rc = static_cast<float4*>(recs);
  cudaError_t e = cudaMemsetAsync(
      off, 0, (size_t)node_tiles * kScanTile * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;

  const int per_block = kBucketThreads * kCountItems;
  const int count_blocks = (n_rows + per_block - 1) / per_block;
  if (n_nodes <= kCountSmemNodes)
    hist_rows_count_kernel<true><<<count_blocks, kBucketThreads,
                                   n_nodes * sizeof(int), s>>>(
        nd, v, off, rk, n_rows, n_nodes);
  else
    hist_rows_count_kernel<false><<<count_blocks, kBucketThreads, 0, s>>>(
        nd, v, off, rk, n_rows, n_nodes);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  hist_rows_scan_kernel<<<1, kScanThreads, 0, s>>>(
      off, c0, cg, node_tiles, group_tiles, n_nodes, group_nodes,
      chunk_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int row_blocks = (n_rows + kBucketThreads - 1) / kBucketThreads;
  const int n_groups = (n_nodes + group_nodes - 1) / group_nodes;
  const int zero_blocks = n_groups < kZeroBlocks ? n_groups : kZeroBlocks;
  float* o = static_cast<float*>(out);
  hist_rows_scatter_kernel<<<row_blocks + zero_blocks, kBucketThreads, 0,
                             s>>>(nd, v, rk, off, c0, rc, o, n_rows,
                                  row_blocks, n_nodes, group_nodes,
                                  n_feat * n_bins * 3);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(hist_rows_bucket_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_slots, (n_feat + feats_per_block - 1) / feats_per_block);
  hist_rows_bucket_kernel<<<grid, threads, smem_bytes, s>>>(
      c, rc, off, c0, cg, o, n_feat, n_nodes, n_bins, group_nodes,
      feats_per_block, chunk_rows);
  return (int)cudaGetLastError();
}

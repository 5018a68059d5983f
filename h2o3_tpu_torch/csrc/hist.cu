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
// Bound: bytes, as for the kernel above (N*F code bytes + 16*N bytes of node
// and values in, L*F*B*3 floats out; about 3*N*F adds).
//
// Design. In row-major codes the F codes of a row are F neighbouring bytes,
// so a tile of rows is one contiguous run of memory. Work is split into
// (row, feature) pairs in that order: neighbouring threads take
// neighbouring code bytes and, within one row, different features, so the
// atomics of a warp land in different features' histograms instead of all
// in the 21 bins of one feature. Two routes, chosen per pass by the wrapper:
//  * shared: a block stages a tile of rows (codes with 16-byte loads, node
//    ids and values) in shared memory and adds its pairs into a private
//    f32 histogram of a block of features of all L nodes; the per-row-block
//    partials are folded by hist_fold_kernel, in a fixed order. Taken while
//    at least two features' (L, B, 3) histograms fit the block's budget
//    (L <= 64 at B = 21).
//  * global: wider levels (L >= 128 at B = 21: the deeper dense levels, the
//    compaction passes, a dense rebuild's deepest levels) add each pair
//    straight into the zeroed (L, F, B, 3) output with global atomics,
//    which L2 resolves; one pass over the pairs, no partials and no fold.
//    With one feature per block the shared route would re-read every row
//    tile F times, and measured slower from L = 128 on.
// Sums are f32 in both; the order of the atomics varies from run to run.

__global__ void hist_rows_shared_kernel(const uint8_t* __restrict__ codes,
                                        const int32_t* __restrict__ node,
                                        const float* __restrict__ vals,
                                        float* __restrict__ partials,
                                        int n_rows, int n_feat, int n_nodes,
                                        int n_bins, int rows_per_block,
                                        int feats_per_block, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_bytes = (tile_rows * n_feat + 15) & ~15;
  uint8_t* tile = smem;                                          // (T, F)
  int32_t* tnode = reinterpret_cast<int32_t*>(smem + tile_bytes);  // (T,)
  float* tval = reinterpret_cast<float*>(tnode + tile_rows);     // (T, 3)
  float* hist = tval + 3 * tile_rows;                            // (nf, L, B, 3)
  const int f0 = blockIdx.y * feats_per_block;
  const int nf = min(feats_per_block, n_feat - f0);
  const int slab = n_nodes * n_bins * 3;
  const int n_sh = nf * slab;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) hist[i] = 0.0f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_rows);
  const size_t stride = (size_t)n_rows;
  for (int t0 = r0; t0 < r1; t0 += tile_rows) {
    const int nt = min(tile_rows, r1 - t0);
    __syncthreads();  // the previous tile is consumed (and hist zeroed)
    const uint8_t* src = codes + (size_t)t0 * n_feat;
    const int nbytes = nt * n_feat;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n16 = nbytes >> 4;
      for (int i = threadIdx.x; i < n16; i += blockDim.x)
        reinterpret_cast<uint4*>(tile)[i] =
            __ldg(reinterpret_cast<const uint4*>(src) + i);
      done = n16 << 4;
    }
    for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x)
      tile[i] = src[i];
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      tnode[i] = node[t0 + i];
      tval[3 * i] = vals[t0 + i];
      tval[3 * i + 1] = vals[stride + t0 + i];
      tval[3 * i + 2] = vals[2 * stride + t0 + i];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < nt * nf; p += blockDim.x) {
      const int i = p / nf;
      const int j = p - i * nf;
      const float v0 = tval[3 * i];
      const float v1 = tval[3 * i + 1];
      const float v2 = tval[3 * i + 2];
      // zero-weight rows (padding, out-of-bag rows, the right-hand siblings
      // of a sibling-subtraction pass) add nothing
      if (v0 == 0.0f && v1 == 0.0f && v2 == 0.0f) continue;
      const int l = tnode[i];
      if ((unsigned)l >= (unsigned)n_nodes) continue;
      const int b = tile[i * n_feat + f0 + j];
      if (b >= n_bins) continue;
      float* h = hist + ((size_t)j * n_nodes + l) * n_bins * 3 + b * 3;
      atomicAdd(h, v0);
      atomicAdd(h + 1, v1);
      atomicAdd(h + 2, v2);
    }
  }
  __syncthreads();

  // this row block's partial: partials[blockIdx.x, f0:f0+nf, L, B, 3]
  float* dst = partials + ((size_t)blockIdx.x * n_feat + f0) * slab;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) dst[i] = hist[i];
}

__global__ void hist_rows_global_kernel(const uint8_t* __restrict__ codes,
                                        const int32_t* __restrict__ node,
                                        const float* __restrict__ vals,
                                        float* __restrict__ out, int n_rows,
                                        int n_feat, int n_nodes, int n_bins) {
  const size_t total = (size_t)n_rows * n_feat;
  const size_t stride = (size_t)n_rows;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (size_t)gridDim.x * blockDim.x) {
    const size_t r = p / n_feat;
    const int f = (int)(p - r * n_feat);
    const float v0 = __ldg(vals + r);
    const float v1 = __ldg(vals + stride + r);
    const float v2 = __ldg(vals + 2 * stride + r);
    if (v0 == 0.0f && v1 == 0.0f && v2 == 0.0f) continue;
    const int l = __ldg(node + r);
    if ((unsigned)l >= (unsigned)n_nodes) continue;
    const int b = codes[p];
    if (b >= n_bins) continue;
    float* h = out + (((size_t)l * n_feat + f) * n_bins + b) * 3;
    atomicAdd(h, v0);
    atomicAdd(h + 1, v1);
    atomicAdd(h + 2, v2);
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

// The row-major entry (B2). route 0 = shared (kernel + fold; `partials` is
// (n_row_blocks, F, L, B, 3)), route 1 = global (`out` must be zeroed;
// `partials` is unused). Returns cudaGetLastError() (0 = ok).
extern "C" int h2o3_hist_build_rows(const void* codes, const void* node,
                                    const void* vals, void* partials,
                                    void* out, int n_rows, int n_feat,
                                    int n_nodes, int n_bins, int route,
                                    int rows_per_block, int feats_per_block,
                                    int tile_rows, int n_row_blocks,
                                    int threads, int smem_bytes, int blocks,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int32_t* nd = static_cast<const int32_t*>(node);
  const float* v = static_cast<const float*>(vals);
  if (route == 1) {
    hist_rows_global_kernel<<<blocks, threads, 0, s>>>(
        c, nd, v, static_cast<float*>(out), n_rows, n_feat, n_nodes, n_bins);
    return (int)cudaGetLastError();
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_rows_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_feat_blocks = (n_feat + feats_per_block - 1) / feats_per_block;
  dim3 grid(n_row_blocks, n_feat_blocks, 1);
  hist_rows_shared_kernel<<<grid, threads, smem_bytes, s>>>(
      c, nd, v, static_cast<float*>(partials), n_rows, n_feat, n_nodes,
      n_bins, rows_per_block, feats_per_block, tile_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hist_fold_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partials),
                                         static_cast<float*>(out),
                                         n_row_blocks, n_feat, n_nodes,
                                         n_bins);
  return (int)cudaGetLastError();
}

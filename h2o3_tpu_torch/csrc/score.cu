// Forest scoring for Hopper (sm_90a): the card's counterpart of the
// reference's fused forest scorer, h2o3_tpu/models/tree.py ::
// predict_forest_fused over build_score_table (a jnp program, not a Pallas
// kernel). Entry h2o3_forest_score.
//
// Computes out[r] = sum over trees t, in tree order, of value[t, leaf(t, r)]
// in float32, where leaf(t, r) walks the heap of tree t from the root for at
// most `depth` steps: at a split node i the row goes right (2i + 2) when its
// feature value is NaN or greater than the threshold, else left (2i + 1); a
// node that is not split holds the row (every later step keeps it there).
// Depth 0 returns the root values.
//
// Inputs: the stacked forest feat (nt, T) int32, thr (nt, T) float32,
// is_split (nt, T) bool (one byte), value (nt, T) float32, T >= 2^(depth+1)
// - 1; X (N, F) float32 row-major. A feature index outside [0, F) is clamped
// into it (the reference's `take(..., mode="clip")`), so no read leaves X.
//
// Bound. The work is a per-row dependent walk of gathers and compares, not
// a reduction: a row reads its F features (4F bytes) and the walk's node
// fields. Counting each input byte once, the bytes of X and the output,
// (4F + 4) N, over the memory rate are the bound; the node tables are read
// again by every row, and at deep levels a node's fields miss the cache (a
// depth-19 forest's tables are ~650 MB), so the walk's latency, not the
// bound, sets the time.
//
// Design (the simple, right first version): one thread per row, looping
// over the trees in order; the three node fields of a step are loaded
// together through the read-only path (__ldg) before the split flag is
// tested, so a step costs one round trip; the row's features are read from
// row-major X (a block's rows stay in L1 across its trees). The TPU layout
// (128-lane subtree rows, one-hot selects between fetches) answers a TPU's
// lack of a fast gather and is not carried over. Making it fast (tree tiles
// in shared memory, a warp per tree) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
forest_score_kernel(const int32_t* __restrict__ feat,
                    const float* __restrict__ thr,
                    const uint8_t* __restrict__ is_split,
                    const float* __restrict__ value,
                    const float* __restrict__ X, float* __restrict__ out,
                    int n_rows, int n_feat, int n_trees, long long n_nodes,
                    int depth) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const float* x = X + (size_t)row * n_feat;
  float acc = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const size_t base = (size_t)t * (size_t)n_nodes;
    long long node = 0;
    for (int d = 0; d < depth; ++d) {
      const size_t i = base + (size_t)node;
      const uint8_t s = __ldg(is_split + i);
      const int f = __ldg(feat + i);
      const float th = __ldg(thr + i);
      if (!s) break;
      const float xv = __ldg(x + min(max(f, 0), n_feat - 1));
      node = 2 * node + 1 + ((isnan(xv) || xv > th) ? 1 : 0);
    }
    acc += __ldg(value + base + (size_t)node);
  }
  out[row] = acc;
}

}  // namespace

extern "C" int h2o3_forest_score(const void* feat, const void* thr,
                                 const void* is_split, const void* value,
                                 const void* X, void* out, int n_rows,
                                 int n_feat, int n_trees, long long n_nodes,
                                 int depth, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (n_feat <= 0 || n_trees <= 0 || depth < 0 ||
      n_nodes < (2LL << depth) - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  forest_score_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(feat), static_cast<const float*>(thr),
      static_cast<const uint8_t*>(is_split), static_cast<const float*>(value),
      static_cast<const float*>(X), static_cast<float*>(out), n_rows, n_feat,
      n_trees, n_nodes, depth);
  return (int)cudaGetLastError();
}

// Gradient histograms for Hopper (sm_90a): the ports of the two TPU kernels
// of h2o3_tpu/ops/hist_pallas.py. This part is build_histograms_pallas_factored
// (kernel body _hist_kernel_factored), entry h2o3_hist_build; the port of
// build_histograms_pallas (_hist_kernel), entry h2o3_hist_build_rows,
// follows further down.
//
// Computes out[l, f, b, c] = sum over rows r with node[r] == l and
// codes[f, r] == b of vals[c, r], for the channels c = {w, g*w, h*w}:
// the (L, F, B, 3) float32 histogram of one tree level.
//
// Inputs: codes (F, N) uint8 feature-major, node (N,) int32, vals (3, N)
// float32. Rows whose node id or code is out of range match no bin (the
// TPU kernel pads with code -1 for the same effect).
//
// Bound: bytes. A pass reads the code bytes of the weighted rows, 16*N bytes
// of node and values and writes L*F*B*3 floats; it does 6 integer adds per
// weighted (row, feature) pair. At the bench shape (N = 1e6, F = 28) that is
// ~44 MB and ~170 M adds: device-memory bandwidth bounds it.
//
// Design. The TPU kernel one-hots an 8-feature block and multiplies, because
// a TPU has no scatter atomics. Here the histogram is a scatter into shared
// memory, in fixed point, because f32 atomicAdd on shared memory is a
// compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN in the SASS) while the
// int32 one is a native ATOMS.ADD. One memset and three launches:
//  1. scale: max|vals[c]| per channel, as the bits of a non-negative float,
//     reduced per block and combined by atomicMax into three zeroed words
//     (the largest bits are the largest float; a NaN or an inf lands above
//     every finite value).
//  2. main: one block per (row block, feature block, node slice); there are
//     just enough row blocks for two blocks per SM (hist_cuda.block_plan
//     sizes the grid, tiles and threads). The block zeroes an
//     (nl, fb, B, 3) histogram of int32 pairs {hi, lo} in shared memory and
//     walks its rows in tiles of up to kRowsMax rows (as many as the shared
//     memory left holds): it stages the tile's (fb, tile) codes in
//     shared memory with 16-byte loads, compacts the tile's weighted
//     in-slice rows into a list (warp ballot and popc, one shared atomic per
//     warp) and counts them per node (__match_any_sync), then walks the
//     list, a row per lane, each lane starting at its own feature, so that
//     the lanes of a warp add into different features' slabs. A node whose
//     slab would pass kRowsMax rows with this tile's is first added into an
//     int64 accumulator (native 64-bit global atomics) and zeroed; at its
//     end the block adds every node's slab there.
//  3. fold: out = float(the int64 sum) times 2^-s_c; a channel whose maximum
//     was not finite is NaN.
// Node slices: where one feature's (L, B, 3) histogram outgrows the block's
// shared memory, the nodes are split into slices, as many as fit; each slice
// re-reads every row's node id, so such a block takes the whole shared
// window (one block per SM, twice the threads) and the fewest slices.
//
// Fixed point. Channel c's values are quantized as q = rint(v * 2^s_c),
// rounding to nearest even, with s_c = T - floor(log2(max|vals[c]|)) (s_c = 0
// for an all-zero channel), T = min(kFixTop, 61 - ceil(log2 N)). With m =
// max|v| in [2^e, 2^(e+1)), |v| * 2^s <= m * 2^s < 2^(T + 1), so |q| <=
// 2^(T + 1) <= 2^36. Shared memory holds q as hi = q >> kLoBits (rounded
// down) and lo = q - hi * 2^kLoBits, so |hi| <= 2^18 and 0 <= lo < 2^18, each
// added with a native int32 atomic. A bin of node l holds rows of node l
// only, and a node's slab takes at most kRowsMax = 2^12 rows between two
// flushes (tiles are at most kRowsMax rows), so |sum hi| <= 2^30 and sum lo
// < 2^30: no int32 sum overflows. A flush adds hi * 2^kLoBits + lo, exactly
// the sum of the q, into int64, where a bin's sum is at most N * 2^(T + 1)
// <= 2^62. Denormal and tiny maxima take the same rule (the product is
// formed in double, where 2^s for s up to 35 + 149 is exact; so is the
// product). Integer sums do not depend on the order of the atomics, the row
// blocks or the grid: the output is a function of the inputs alone, bit for
// bit, and equals hist_cuda.hist_plain_fixed (the same rule in PyTorch).
// Precision: a row's quantization error is at most 2^-36 of the largest
// |value|, 2^-13 of that value's f32 ulp, so each output is, but for that,
// the exact sum rounded to f32 once. (One int32 per channel left 20 bits at
// 1024-row slabs, and the signed g*w channel came out farther from an f64
// sum than f32 atomics at 10^4-row bins.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsMax = 4096;  // hist_cuda.R_MAX: rows per slab at most
constexpr int kFixTop = 35;     // hist_cuda.FIX_TOP
constexpr int kLoBits = 18;     // hist_cuda.LO_BITS: q = hi * 2^kLoBits + lo
constexpr int kRowsPerThread = 4;  // hist_cuda.ROWS_PER_THREAD: tile rows

// T of the rule above for a pass over n_rows rows
__device__ __forceinline__ int fix_top(int n_rows) {
  const int ceil_log2 = n_rows > 1 ? 32 - __clz(n_rows - 1) : 0;
  return min(kFixTop, 61 - ceil_log2);
}

// s_c of the rule above from the bits of max|v| (sign clear); 0 for a
// zero maximum and for a NaN or an inf (bits >= 0x7f800000).
__device__ __forceinline__ int fix_shift(unsigned bits, int top) {
  if (bits >= 0x7f800000u || bits == 0) return 0;
  const int ex = bits >> 23;
  const int e = ex ? ex - 127 : (31 - __clz(bits & 0x7fffffu)) - 149;
  return top - e;
}

// maxbits[c] = atomicMax of the bits of |vals[c, r]| over the rows: each
// thread keeps 4 rows' loads in flight, and each block reduces through
// shared memory to one atomic per channel.
__global__ void hist_fixed_scale_kernel(const float* __restrict__ vals,
                                        unsigned* __restrict__ maxbits,
                                        int n_rows) {
  __shared__ unsigned wmax[32][3];
  unsigned m[3] = {0u, 0u, 0u};
  const size_t stride = (size_t)n_rows;
  for (int r0 = blockIdx.x * blockDim.x * 4 + threadIdx.x; r0 < n_rows;
       r0 += gridDim.x * blockDim.x * 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * blockDim.x;
      if (r < n_rows) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          m[c] = max(m[c], __float_as_uint(vals[c * stride + r]) & 0x7fffffffu);
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int o = 16; o; o >>= 1)
      m[c] = max(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
    if (lane == 0) wmax[warp][c] = m[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      unsigned v = lane < (int)(blockDim.x >> 5) ? wmax[lane][c] : 0u;
#pragma unroll
      for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0 && v) atomicMax(maxbits + c, v);
    }
  }
}

// The walk: each lane takes a weighted row of the list, loads and quantizes
// its three values once, and walks the block's features starting at its own
// lane's feature, so the 32 lanes of a warp add into up to 32 features'
// slabs at once, and the row's six words stay in registers for all its
// features.
__global__ void hist_fixed_kernel(const uint8_t* __restrict__ codes,
                                  const int32_t* __restrict__ node,
                                  const float* __restrict__ vals,
                                  const unsigned* __restrict__ maxbits,
                                  unsigned long long* __restrict__ acc,
                                  int n_rows, int n_feat, int n_nodes,
                                  int n_bins, int rows_per_block,
                                  int feats_per_block, int nodes_per_block,
                                  int tile_rows) {
  // shared: the (nl, fb, B) histogram of {hi0, hi1, hi2, lo0, lo1, lo2},
  // the tile's list of weighted rows (row in tile | slab offset << 12), its
  // (fb, S) codes, the list's length (one per tile parity: a thread may
  // still read the last tile's while thread 0 resets the next one's), the
  // number of nodes to flush, and per node of the slice: rows since its last
  // flush, rows of this tile, and the list of nodes to flush
  extern __shared__ __align__(16) int hist[];
  const int f0 = blockIdx.y * feats_per_block;
  const int nf = min(feats_per_block, n_feat - f0);
  const int l0 = blockIdx.z * nodes_per_block;
  const int nl = min(nodes_per_block, n_nodes - l0);
  const int b3 = n_bins * 3;
  const int per3 = nf * b3;         // a node's (fb, B, 3) entries
  const int per_node = 2 * per3;    // and its ints in shared memory
  const int n_sh = nl * per_node;
  int* list = hist + ((n_sh + 3) & ~3);
  const int S = tile_rows + 16;  // a staged feature's bytes (16-aligned)
  uint8_t* stile = reinterpret_cast<uint8_t*>(list + tile_rows);
  int* n_list = reinterpret_cast<int*>(stile + nf * S);
  int* n_flush = n_list + 2;
  int* cnt = n_flush + 1;
  int* tcnt = cnt + nl;
  int* flush = tcnt + nl;
  const size_t row_len = (size_t)n_feat * b3;
  unsigned long long* dst = acc + (size_t)l0 * row_len + (size_t)f0 * b3;

  const int top = fix_top(n_rows);
  bool fin[3];
  double scale[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned bits = maxbits[c];
    fin[c] = bits < 0x7f800000u;
    scale[c] = ldexp(1.0, fix_shift(bits, top));
  }

  // entry i = (j * B + b) * 3 + c of node l's slab: add hi * 2^kLoBits + lo
  // into acc and zero the pair
  auto drain = [&](int l, int i) {
    int* h = hist + l * per_node + (i / 3) * 6 + i % 3;
    const long long v = ((long long)h[0] << kLoBits) + h[3];
    if (v) atomicAdd(dst + l * row_len + i, (unsigned long long)v);
    h[0] = 0;
    h[3] = 0;
  };

  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < 3 + 2 * nl; i += blockDim.x) n_list[i] = 0;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t stride = (size_t)n_rows;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_rows);
  const int n_mod = n_rows & 15;
  const int units = tile_rows / 16 + 1;  // 16-byte loads per staged feature

  for (int t0 = r0, par = 0; t0 < r1; t0 += tile_rows, par ^= 1) {
    const int nt = min(tile_rows, r1 - t0);
    __syncthreads();  // the last tile's walk is done
    if (threadIdx.x == 0) {
      n_list[par ^ 1] = 0;
      *n_flush = 0;
    }
    // stage: feature j's bytes from the 16-byte boundary at or below its
    // row t0; that boundary and the last 16-byte word lie inside the
    // tensor's allocation (PyTorch's blocks are 512-byte aligned), and the
    // bytes outside [t0, t0 + nt) are never read back
    const uintptr_t g0 = reinterpret_cast<uintptr_t>(codes) +
                         (size_t)f0 * stride + t0;
    const int sh0 = (int)(g0 & 15);
    for (int i = threadIdx.x; i < nf * units; i += blockDim.x) {
      const int j = i / units;
      const int u = i - j * units;
      const uintptr_t g = g0 + (size_t)j * stride;
      const int sh = (int)(g & 15);
      if (u * 16 < sh + nt)
        reinterpret_cast<uint4*>(stile + j * S)[u] =
            __ldg(reinterpret_cast<const uint4*>((g & ~(uintptr_t)15)) + u);
    }
    // compact: the tile's weighted rows with a node in this slice, counted
    // per node. A thread takes rows k = u * blockDim.x + threadIdx.x, and
    // issues all its node loads, then all its value loads, before it uses
    // any: one round trip to device memory each, not one per row
    int lr[kRowsPerThread];
    float v[kRowsPerThread][3];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int k = u * blockDim.x + threadIdx.x;
      lr[u] = k < nt ? node[t0 + k] - l0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int k = u * blockDim.x + threadIdx.x;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[u][c] = (unsigned)lr[u] < (unsigned)nl ? vals[c * stride + t0 + k]
                                                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int k = u * blockDim.x + threadIdx.x;
      const int l = lr[u];
      // zero-weight rows (padding, the right-hand siblings of a
      // sibling-subtraction pass) add nothing
      const bool keep = (unsigned)l < (unsigned)nl &&
                        !(v[u][0] == 0.0f && v[u][1] == 0.0f && v[u][2] == 0.0f);
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      int base = 0;
      if (lane == 0 && ballot) base = atomicAdd(n_list + par, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      const unsigned peers = __match_any_sync(0xffffffffu, keep ? l : -1);
      if (keep && lane == __ffs(peers) - 1) atomicAdd(tcnt + l, __popc(peers));
      if (keep) list[base + __popc(ballot & below)] = k | (l * per_node) << 12;
    }
    __syncthreads();
    // a node whose rows since its last flush and this tile's would pass
    // kRowsMax has its slab added into acc and zeroed first
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      const int c = cnt[l] + tcnt[l];
      if (c > kRowsMax) {
        flush[atomicAdd(n_flush, 1)] = l;
        cnt[l] = tcnt[l];
      } else {
        cnt[l] = c;
      }
      tcnt[l] = 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < *n_flush * per3; i += blockDim.x)
      drain(flush[i / per3], i % per3);
    __syncthreads();
    const int n_w = n_list[par];
    const int rot = lane % nf;
    for (int e = threadIdx.x; e < n_w; e += blockDim.x) {
      const int en = list[e];
      const int k = en & 4095;
      int* hrow = hist + (en >> 12);
      int hi[3], lo[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // the value again (the compaction's load left it in cache)
        const float v = __ldg(vals + c * stride + t0 + k);
        const long long q =
            fin[c] ? __double2ll_rn((double)v * scale[c]) : 0;
        hi[c] = (int)(q >> kLoBits);
        lo[c] = (int)(q & ((1 << kLoBits) - 1));
      }
      int j = rot;
      for (int jj = 0; jj < nf; ++jj) {
        const int b = stile[j * S + ((sh0 + j * n_mod) & 15) + k];
        if (b < n_bins) {
          int* h = hrow + (j * n_bins + b) * 6;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            // a half that is zero in every lane (lo of 0/1 weights) costs
            // no atomic
            if (hi[c]) atomicAdd(h + c, hi[c]);
            if (lo[c]) atomicAdd(h + 3 + c, lo[c]);
          }
        }
        if (++j == nf) j = 0;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl * per3; i += blockDim.x)
    drain(i / per3, i % per3);
}

// out[i] = float(acc[i]) * 2^-s_c, c = i % 3; NaN where channel c's maximum
// was not finite.
__global__ void hist_fixed_fold_kernel(const long long* __restrict__ acc,
                                       const unsigned* __restrict__ maxbits,
                                       float* __restrict__ out,
                                       long long total, int n_rows) {
  const int top = fix_top(n_rows);
  unsigned bad = 0;  // bit c: channel c's maximum was not finite
  double inv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned bits = maxbits[c];
    bad |= (unsigned)(bits >= 0x7f800000u) << c;
    inv[c] = ldexp(1.0, -fix_shift(bits, top));
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % 3);
    // the channel's scale by a select, not by indexing a local array
    const double s = c == 0 ? inv[0] : c == 1 ? inv[1] : inv[2];
    out[i] = (bad >> c) & 1u
                 ? __int_as_float(0x7fc00000)
                 : __double2float_rn((double)__ll2float_rn(acc[i]) * s);
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

// The feature-major entry (B1): one memset of `scratch` (16 bytes of channel
// maxima, then the (L, F, B, 3) int64 accumulator), then the scale, main and
// fold launches on `stream`. Returns the first CUDA error (0 = ok).
extern "C" int h2o3_hist_build(const void* codes, const void* node,
                               const void* vals, void* scratch, void* out,
                               int n_rows, int n_feat, int n_nodes, int n_bins,
                               int rows_per_block, int feats_per_block,
                               int nodes_per_block, int n_row_blocks,
                               int tile_rows, int threads, int smem_bytes,
                               int scale_blocks, int fold_blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* mb = static_cast<unsigned*>(scratch);
  long long* acc = reinterpret_cast<long long*>(static_cast<char*>(scratch) + 16);
  const long long total = (long long)n_nodes * n_feat * n_bins * 3;
  // a tile takes at most kRowsMax rows and kRowsPerThread per thread
  if (tile_rows > kRowsMax || tile_rows > kRowsPerThread * threads)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 16 + total * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  hist_fixed_scale_kernel<<<scale_blocks, 512, 0, s>>>(
      static_cast<const float*>(vals), mb, n_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if (smem_bytes > 48 * 1024 &&
      (e = cudaFuncSetAttribute(hist_fixed_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes)) != cudaSuccess)
    return (int)e;
  dim3 grid(n_row_blocks, (n_feat + feats_per_block - 1) / feats_per_block,
            (n_nodes + nodes_per_block - 1) / nodes_per_block);
  hist_fixed_kernel<<<grid, threads, smem_bytes, s>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(node),
      static_cast<const float*>(vals), mb,
      reinterpret_cast<unsigned long long*>(acc), n_rows, n_feat, n_nodes,
      n_bins, rows_per_block, feats_per_block, nodes_per_block, tile_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  hist_fixed_fold_kernel<<<fold_blocks, 256, 0, s>>>(
      acc, mb, static_cast<float*>(out), total, n_rows);
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

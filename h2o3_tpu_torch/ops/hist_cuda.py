"""The gradient-histogram kernels for Hopper, their build, and their plain
twins.

Two entries replace the two TPU kernels of `h2o3_tpu/ops/hist_pallas.py`:

* `hist_build` — `build_histograms_pallas_factored` (B1, kernel body
  `_hist_kernel_factored`), on feature-major (F, N) codes;
* `hist_build_rows` — `build_histograms_pallas` (B2, kernel body
  `_hist_kernel`), on row-major (N, F) codes.

The CUDA source of both is `h2o3_tpu_torch/csrc/hist.cu`; its comments give
each design and bound (device-memory bytes). `nvcc` builds it at first use
into `h2o3_tpu_torch/_build/` (ignored by git) as a shared library with
plain C entry points, loaded through `ctypes`.

B1 sums in fixed point (`fixed_shifts`: one power-of-two scale per channel
from its largest magnitude, 36 bits below it; pairs of int32 shared-memory
sums, an int64 accumulator), so its output is a function of its inputs
alone, bit for bit; `hist_plain_fixed` is the same rule in PyTorch. B2 sums in f32, so the last bits of its sums
vary with the order of its atomics.

Each entry launches its kernel for tensors on a CUDA device and uses its
plain twin (`hist_plain`, `hist_plain_rows`: a per-feature `index_add_`,
the sequential f32 fold of the reference's `_hist_segment`) only for
tensors that lie on the CPU. A failed build or launch raises; nothing falls
back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hist.cu"
BUILD_DIR = _PKG / "_build"

# shared memory per block: Hopper's opt-in maximum
SMEM_MAX = 232448
# shared memory of one SM; a block that wants two of itself resident on an
# SM may take half of it less the 1 KB the card reserves per block
SMEM_SM = 233472
SMEM_PAIR = SMEM_SM // 2 - 1024

# B1 (fixed point): channel c's values are quantized as q = rint(v * 2^s_c)
# with s_c = fix_top(N) - floor(log2 max|v_c|), so |q| <= 2^(FIX_TOP + 1);
# shared memory holds q as the int32 pair hi = q >> LO_BITS, lo = q mod
# 2^LO_BITS, and a node's slab takes at most R_MAX rows between two flushes
# into the int64 accumulator, so no int32 sum passes R_MAX * 2^18 = 2^30
# (hist.cu kRowsMax, kFixTop, kLoBits: the proof). A block has THREADS
# threads and at most SMEM_PAIR bytes of shared memory, two blocks per SM;
# where not even one feature of every node fits (node slices), it has
# 2 * THREADS threads and the whole window, one block per SM, so that
# fewer slices re-read the rows. It splits the features and nodes so that
# its histogram fits beside tiles of TILE_ROWS rows, and then walks tiles
# of as many rows as the shared memory left holds, up to R_MAX and
# ROWS_PER_THREAD rows per thread. There are just enough row blocks for
# two blocks of THREADS per SM, never of fewer than MIN_ROWS_PER_BLOCK rows
# (tools/hist_factored.py chose these on an H100).
R_MAX = 4096
FIX_TOP = 35
LO_BITS = 18
ROWS_PER_THREAD = 4
TILE_ROWS = 1024
THREADS = 512
MIN_ROWS_PER_BLOCK = 1024

# B2 (node-bucketed): a block of ROWS_THREADS threads holds the
# (G, fb, B, 3) histograms of a group of G <= GROUP_NODES consecutive nodes
# and takes at most CHUNK_ROWS of the group's rows (tools/hist_rows_routes.py
# chose them on an H100)
GROUP_NODES = 8
CHUNK_ROWS = 512
ROWS_THREADS = 512
SCAN_TILE = 8192                     # hist.cu kScanTile: counts per scan tile

# kernel launches made by `hist_build` / `hist_build_rows` (one per call
# that reaches the card)
launches = 0
launches_rows = 0
# what nvcc printed for the last build (-Xptxas -v: registers, shared memory)
build_log = ""

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA histogram kernel is built "
                       "from csrc/hist.cu at first use and needs the CUDA "
                       "toolkit")


def library_path() -> Path:
    """Where `build` puts the library of the current source."""
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libh2o3hist_{tag}.so"


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        so.with_suffix(".log").write_text(build_log)
        os.replace(tmp, so)
    elif so.with_suffix(".log").exists():
        build_log = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    fn = lib.h2o3_hist_build
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.h2o3_hist_build_rows
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


class FactoredPlan(NamedTuple):
    """One B1 pass: features per block (fb), nodes per slice (nl), rows per
    block, rows per tile, the grid (row blocks, feature blocks, node
    slices), threads and shared bytes per block."""
    feats_per_block: int
    nodes_per_block: int
    rows_per_block: int
    tile_rows: int
    grid: tuple[int, int, int]
    threads: int
    smem: int


def block_plan(n_nodes: int, nbins: int, n_feat: int, n_rows: int,
               sms: int = 132) -> FactoredPlan:
    """The launch plan of one B1 pass (`hist_build`). A block holds the
    (nl, fb, B, 3) histogram of int32 pairs, a tile's list of weighted rows,
    its staged codes and three counters per node in at most SMEM_PAIR bytes:
    every feature of all L nodes where that fits beside a tile of TILE_ROWS
    rows, else the fewest balanced feature blocks that fit (28 = 10 + 10 +
    8), else (a block of 2 * THREADS threads in SMEM_MAX bytes) one feature
    of an even slice of the nodes; the tile then takes what shared memory
    is left, up to R_MAX rows and ROWS_PER_THREAD rows per thread. Row
    blocks: enough for two blocks of THREADS per SM, never of fewer than
    MIN_ROWS_PER_BLOCK rows. Raises only where one node's histogram of one
    feature does not fit."""
    per = nbins * 6 * 4                  # bytes of one (node, feature) histogram
    tile, threads, budget = TILE_ROWS, THREADS, SMEM_PAIR
    top = min(R_MAX, ROWS_PER_THREAD * threads)
    if not 16 <= tile <= top or tile % 16:
        raise ValueError(f"TILE_ROWS {tile}: a multiple of 16 up to {top}")

    def smem(fb: int, nl: int, tile: int = tile) -> int:
        # hist.cu: histogram, list, codes, counters
        return (16 * (-(-fb * nl * nbins * 6 // 4)) + 4 * tile
                + fb * (tile + 16) + 12 + 12 * nl)

    if smem(1, 1) > SMEM_MAX:
        raise ValueError(f"one node's histogram of {nbins} bins exceeds the "
                         "block's shared memory")
    L, F = max(n_nodes, 1), max(n_feat, 1)
    fb, nl = F, L
    if smem(F, L) > budget:
        k = next((k for k in range(2, F + 1)
                  if smem(-(-F // k), L) <= budget), None)
        if k is not None:
            fb = -(-F // k)
        else:
            # node slices: every slice re-reads the rows, so a block takes
            # the whole window and as many nodes as fit beside the longest
            # tiles (tools/hist_factored.py: 1.8x faster at L = 1024 than
            # two blocks per SM)
            threads, budget = min(2 * THREADS, 1024), SMEM_MAX
            top = min(R_MAX, ROWS_PER_THREAD * threads)
            fb, nl = 1, (budget - smem(1, 0, top)) // (per + 12)
            while smem(1, nl, top) > budget:
                nl -= 1
            nl = -(-L // -(-L // nl))        # even slices
    tile = min(top, (budget - smem(fb, nl, 0)) // (4 + fb) // 16 * 16)
    cols = -(-F // fb) * -(-L // nl)
    n_rb = max(1, min(-(-n_rows // MIN_ROWS_PER_BLOCK), -(-2 * sms // cols)))
    rows = max(16, -(-n_rows // (16 * n_rb)) * 16)
    n_rb = max(1, -(-n_rows // rows))
    return FactoredPlan(fb, nl, rows, tile, (n_rb, -(-F // fb), -(-L // nl)),
                        threads, smem(fb, nl, tile))


def hist_plain(codes: torch.Tensor, node: torch.Tensor, vals: torch.Tensor,
               n_nodes: int, nbins: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(L, F, B, 3) histogram by one `index_add_` per feature — the plain
    PyTorch version of the kernel, on its inputs: codes (F, N) feature-major,
    node (N,), vals (3, N). Sums in `dtype` (float32: the kernel's plain
    version; float64: an error reference; int64: `hist_plain_fixed`)."""
    F = codes.shape[0]
    base = node.to(torch.int64) * nbins
    src = vals.t().to(dtype)
    out = torch.zeros((F, n_nodes * nbins, 3), dtype=dtype, device=vals.device)
    for f in range(F):
        out[f].index_add_(0, base + codes[f].to(torch.int64), src)
    return out.view(F, n_nodes, nbins, 3).permute(1, 0, 2, 3).contiguous()


def fix_top(n_rows: int) -> int:
    """T of B1's scale rule for a pass over n_rows rows: FIX_TOP, less one
    for each doubling of n_rows past 2^26, so that no int64 sum of N
    quantized values passes 2^62."""
    return min(FIX_TOP, 61 - max(n_rows - 1, 0).bit_length())


def fixed_shifts(vals: torch.Tensor) -> list[Optional[int]]:
    """B1's scale rule: per channel c of vals (3, N), s_c = fix_top(N) -
    floor(log2 max|vals[c]|), 0 for an all-zero channel, None for a channel
    that holds a NaN or an inf."""
    top = fix_top(vals.shape[1])
    m = vals.abs().amax(dim=1).double().tolist() if vals.shape[1] else [0.0] * 3
    return [None if not math.isfinite(x) else
            0 if x == 0 else top - (math.frexp(x)[1] - 1) for x in m]


def hist_plain_fixed(codes: torch.Tensor, node: torch.Tensor,
                     vals: torch.Tensor, n_nodes: int,
                     nbins: int) -> torch.Tensor:
    """The B1 kernel's exact twin in plain PyTorch: the same scale rule
    (`fixed_shifts`), each value quantized as rint(v * 2^s_c) to nearest
    even, int64 sums (`hist_plain`), and each sum converted to f32 once and
    multiplied by 2^-s_c (in f64, then rounded to f32); a channel with a NaN
    or an inf is NaN. Equals `hist_build` on the card bit for bit. Inputs as
    `hist_plain`'s."""
    shifts = fixed_shifts(vals)
    scale = torch.tensor([0.0 if s is None else 2.0 ** s for s in shifts],
                         dtype=torch.float64, device=vals.device)
    # scale 0 for a non-finite channel: its NaN and inf products become 0
    q = torch.round(torch.nan_to_num(vals.double() * scale[:, None], nan=0.0)
                    ).to(torch.int64)
    acc = hist_plain(codes, node, q, n_nodes, nbins, torch.int64)
    inv = torch.tensor([math.nan if s is None else 2.0 ** -s for s in shifts],
                       dtype=torch.float64, device=vals.device)
    return (acc.to(torch.float32).double() * inv).to(torch.float32)


def hist_build(codes: torch.Tensor, node: torch.Tensor, vals: torch.Tensor,
               n_nodes: int, nbins: int) -> torch.Tensor:
    """(L, F, B, 3) f32 histogram of vals per (node, feature, bin).

    codes (F, N) uint8 feature-major, node (N,) int32, vals (3, N) f32, all
    contiguous on one device. On a CUDA device this launches the fixed-point
    kernels (`block_plan`) on the current stream, with no synchronisation:
    the result equals `hist_plain_fixed`. On the CPU it is `hist_plain`."""
    global launches
    if codes.device.type == "cpu":
        return hist_plain(codes, node, vals, n_nodes, nbins)
    F, N = codes.shape
    if codes.dtype != torch.uint8 or node.dtype != torch.int32 \
            or vals.dtype != torch.float32:
        raise TypeError(f"hist_build takes uint8 codes, int32 node, f32 vals; "
                        f"got {codes.dtype}, {node.dtype}, {vals.dtype}")
    if tuple(node.shape) != (N,) or tuple(vals.shape) != (3, N):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, node "
                         f"{tuple(node.shape)}, vals {tuple(vals.shape)}")
    if not (codes.is_contiguous() and node.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("hist_build takes contiguous tensors")
    if not (codes.device == node.device == vals.device):
        raise ValueError("hist_build inputs lie on different devices")
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    plan = block_plan(n_nodes, nbins, F, N, sms)
    out = torch.empty((n_nodes, F, nbins, 3), dtype=torch.float32,
                      device=codes.device)
    if N == 0 or out.numel() == 0:
        return out.zero_()
    lib = build()
    # 16 bytes of channel maxima, then the int64 (L, F, B, 3) accumulator
    scratch = torch.empty(2 + out.numel(), dtype=torch.int64,
                          device=codes.device)
    fold_blocks = max(1, min(-(-out.numel() // 256), 16 * sms))
    scale_blocks = max(1, min(-(-N // 4096), 2 * sms))
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.h2o3_hist_build(
            codes.data_ptr(), node.data_ptr(), vals.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), N, F, n_nodes, nbins,
            plan.rows_per_block, plan.feats_per_block, plan.nodes_per_block,
            plan.grid[0], plan.tile_rows, plan.threads, plan.smem, scale_blocks,
            fold_blocks, stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {rc}")
    launches += 1
    return out


class RowsPlan(NamedTuple):
    """One B2 pass: the main kernel's nodes per group (G), features per
    block (fb), rows per chunk (C), grid (chunk slots, feature blocks) and
    shared bytes; the scan tiles of the node counts
    and of the groups' chunk counts; the byte offsets in the scratch buffer
    of the node offsets, the chunk prefix, the chunk-to-group map, the row
    ranks and the row records in node order, and the buffer's size."""
    group_nodes: int
    feats_per_block: int
    chunk_rows: int
    grid: tuple[int, int]
    smem: int
    node_tiles: int
    group_tiles: int
    scratch: tuple[int, ...]
    scratch_bytes: int


def rows_plan(n_nodes: int, nbins: int, n_feat: int,
              n_rows: int) -> RowsPlan:
    """The launch plan of one B2 pass (`hist_build_rows`) over n_rows rows.
    A block keeps the histograms of G = min(GROUP_NODES, L) nodes of all
    features in shared memory, fewer where they do not fit; where one
    node's histograms of all features do not fit, a block takes one node
    and as many features as fit. Raises only where one node's histogram of
    one feature does not fit."""
    per = nbins * 3 * 4                  # bytes of one (node, feature) histogram

    def smem(G: int, fb: int) -> int:    # hist.cu: G + 1 offsets, (G, fb, B, 3)
        return 4 * ((G + 4) // 4 * 4) + 4 * (-(-G * fb * nbins * 3 // 4) * 4)

    if smem(1, 1) > SMEM_MAX:
        raise ValueError(f"one node's histogram of {nbins} bins exceeds the "
                         "block's shared memory")
    C = CHUNK_ROWS
    if smem(1, n_feat) <= SMEM_MAX:
        fb = n_feat
        G = max(1, min(GROUP_NODES, n_nodes))
        while smem(G, fb) > SMEM_MAX:
            G -= 1
    else:
        G, fb = 1, (SMEM_MAX - smem(1, 0)) // per
        while smem(1, fb) > SMEM_MAX:
            fb -= 1
    n_groups = -(-n_nodes // G)
    grid = (n_groups + -(-n_rows // C), -(-n_feat // fb))
    node_tiles = -(-(n_nodes + 1) // SCAN_TILE)
    group_tiles = -(-(n_groups + 1) // SCAN_TILE)
    offsets, at = [], 0
    for size in (4 * SCAN_TILE * node_tiles, 4 * SCAN_TILE * group_tiles,
                 4 * grid[0], 4 * n_rows, 16 * n_rows):
        offsets.append(at)
        at += -(-size // 16) * 16
    return RowsPlan(G, fb, C, grid, smem(G, fb), node_tiles, group_tiles,
                    tuple(offsets), at)


def hist_plain_rows(codes: torch.Tensor, node: torch.Tensor,
                    vals: torch.Tensor, n_nodes: int,
                    nbins: int) -> torch.Tensor:
    """`hist_plain` on row-major (N, F) codes — the plain PyTorch version of
    the B2 kernel (one `index_add_` per feature over node·B + code)."""
    return hist_plain(codes.t(), node, vals, n_nodes, nbins)


def hist_build_rows(codes: torch.Tensor, node: torch.Tensor,
                    vals: torch.Tensor, n_nodes: int,
                    nbins: int) -> torch.Tensor:
    """(L, F, B, 3) f32 histogram of vals per (node, feature, bin), from
    row-major codes (N, F) uint8, node (N,) int32 and vals (3, N) f32, all
    contiguous on one device. On a CUDA device this launches the B2 kernels
    (`rows_plan`) on the current stream, with no synchronisation; on the CPU
    it is `hist_plain_rows`."""
    global launches_rows
    if codes.device.type == "cpu":
        return hist_plain_rows(codes, node, vals, n_nodes, nbins)
    N, F = codes.shape
    if codes.dtype != torch.uint8 or node.dtype != torch.int32 \
            or vals.dtype != torch.float32:
        raise TypeError(f"hist_build_rows takes uint8 codes, int32 node, f32 "
                        f"vals; got {codes.dtype}, {node.dtype}, {vals.dtype}")
    if tuple(node.shape) != (N,) or tuple(vals.shape) != (3, N):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, node "
                         f"{tuple(node.shape)}, vals {tuple(vals.shape)}")
    if not (codes.is_contiguous() and node.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("hist_build_rows takes contiguous tensors")
    if not (codes.device == node.device == vals.device):
        raise ValueError("hist_build_rows inputs lie on different devices")
    plan = rows_plan(n_nodes, nbins, F, N)
    out = torch.empty((n_nodes, F, nbins, 3), dtype=torch.float32,
                      device=codes.device)
    if N == 0 or F == 0 or n_nodes == 0:
        return out.zero_()
    lib = build()
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=codes.device)
    parts = [scratch.data_ptr() + at for at in plan.scratch]
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.h2o3_hist_build_rows(
            codes.data_ptr(), node.data_ptr(), vals.data_ptr(), *parts,
            out.data_ptr(), N, F, n_nodes, nbins, plan.group_nodes,
            plan.feats_per_block, plan.chunk_rows, plan.node_tiles,
            plan.group_tiles, plan.grid[0], ROWS_THREADS, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"row-major histogram kernel launch failed: "
                           f"cudaError {rc}")
    launches_rows += 1
    return out

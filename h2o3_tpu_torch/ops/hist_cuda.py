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

# shared memory per block: the default window, and Hopper's opt-in maximum
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 232448
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.h2o3_hist_build_rows
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def block_plan(n_nodes: int, nbins: int, n_feat: int) -> tuple[int, int]:
    """(features per block, nodes per block) for one pass. A block holds
    the (nodes, B, 3) f32 histograms of its features in shared memory: as
    many features of all L nodes as fit the default 48 KB window, else one
    feature of all L nodes in the opt-in window, else one feature of an
    even slice of the nodes, as many as fit the opt-in window."""
    per_node = nbins * 3 * 4
    if per_node > SMEM_MAX:
        raise ValueError(f"one node's histogram of {nbins} bins exceeds the "
                         "block's shared memory")
    per = n_nodes * per_node
    if per <= SMEM_DEFAULT:
        return max(1, min(n_feat, SMEM_DEFAULT // per)), n_nodes
    if per <= SMEM_MAX:
        return 1, n_nodes
    n_slices = math.ceil(n_nodes / (SMEM_MAX // per_node))
    return 1, math.ceil(n_nodes / n_slices)


def hist_plain(codes: torch.Tensor, node: torch.Tensor, vals: torch.Tensor,
               n_nodes: int, nbins: int) -> torch.Tensor:
    """(L, F, B, 3) histogram by one `index_add_` per feature — the plain
    PyTorch version of the kernel, on its inputs: codes (F, N) feature-major,
    node (N,), vals (3, N)."""
    F = codes.shape[0]
    base = node.to(torch.int64) * nbins
    src = vals.t()
    out = torch.zeros((F, n_nodes * nbins, 3), dtype=torch.float32,
                      device=vals.device)
    for f in range(F):
        out[f].index_add_(0, base + codes[f].to(torch.int64), src)
    return out.view(F, n_nodes, nbins, 3).permute(1, 0, 2, 3).contiguous()


def hist_build(codes: torch.Tensor, node: torch.Tensor, vals: torch.Tensor,
               n_nodes: int, nbins: int) -> torch.Tensor:
    """(L, F, B, 3) f32 histogram of vals per (node, feature, bin).

    codes (F, N) uint8 feature-major, node (N,) int32, vals (3, N) f32, all
    contiguous on one device. On a CUDA device this launches the kernel on
    the current stream (no synchronisation); on the CPU it is `hist_plain`."""
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
    fpb, npb = block_plan(n_nodes, nbins, F)
    out = torch.empty((n_nodes, F, nbins, 3), dtype=torch.float32,
                      device=codes.device)
    if N == 0 or F == 0:
        return out.zero_()
    lib = build()
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    n_blocks = math.ceil(F / fpb) * math.ceil(n_nodes / npb)
    # about two blocks per SM in all, never blocks of fewer than
    # MIN_ROWS_PER_BLOCK rows
    n_rb = max(1, min(math.ceil(N / MIN_ROWS_PER_BLOCK),
                      math.ceil(2 * sms / n_blocks)))
    rows = math.ceil(N / n_rb)
    n_rb = math.ceil(N / rows)
    partials = torch.empty((n_rb, F, n_nodes, nbins, 3), dtype=torch.float32,
                           device=codes.device)
    smem = fpb * npb * nbins * 3 * 4
    fold_blocks = max(1, min(math.ceil(out.numel() / 256), 4 * sms))
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.h2o3_hist_build(
            codes.data_ptr(), node.data_ptr(), vals.data_ptr(),
            partials.data_ptr(), out.data_ptr(), N, F, n_nodes, nbins, rows,
            fpb, npb, n_rb, THREADS, smem, fold_blocks, stream)
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

"""The TreeSHAP kernel for Hopper, its build and its launch.

`tree_shap` is the card's counterpart of the reference's native TreeSHAP
(`h2o3_tpu/native/tree_shap.cpp::h2o3_tree_shap`, host C++ with OpenMP
over rows; no Pallas kernel computes it): the (N, F+1) f64 path-dependent
contributions of one stacked forest. Its CUDA source is
`h2o3_tpu_torch/csrc/tree_shap.cu` (its comments give the design and the
bound), built at first use by `hist_cuda.build_library` into
`h2o3_tpu_torch/_build/` and loaded through `ctypes`.

One thread walks one (row, tree) pair and writes its φ to an (nt, rows, F)
f64 scratch; a second kernel adds the trees in tree order. The rows go in
chunks that keep the scratch within SCRATCH_BYTES. The plain version is
`models/tree_shap.py::tree_shap_plain`, which `compute_contributions`
runs for tensors on the CPU; the two agree bit for bit on the card. For
tensors on a CUDA device a failed build or launch raises
`hist_cuda.KernelError`: nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..models.tree import Tree
from ..models.tree_shap import heap_depth
from . import hist_cuda

SOURCE = hist_cuda.SOURCE.with_name("tree_shap.cu")
# the partial-φ scratch of one chunk of rows stays within this many bytes
SCRATCH_BYTES = 256 << 20
MAX_DEPTH = 30                   # tree_shap.cu kMaxDepth

# chunks launched on the card (one walk and one fold each)
launches = 0
# the largest scratch one call allocated, in bytes
scratch_peak = 0
# what nvcc printed for the last build (-Xptxas -v: registers, stack, spills)
build_log = ""

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library; one
    thread builds, the others wait for it."""
    global _lib, build_log
    with _build_lock:
        if _lib is not None:
            return _lib
        lib, build_log = hist_cuda.build_library(SOURCE, "h2o3shap")
        fn = lib.h2o3_tree_shap
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
                          ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.h2o3_tree_shap_max_depth.argtypes = []
        lib.h2o3_tree_shap_max_depth.restype = ctypes.c_int
        if lib.h2o3_tree_shap_max_depth() != MAX_DEPTH:
            raise hist_cuda.KernelError(
                "tree_shap.cu takes another depth than the wrapper plans for")
        _lib = lib
        return lib


def chunk_rows(n_rows: int, n_trees: int, n_feat: int) -> int:
    """Rows per launch: as many as keep the (nt, rows, F) f64 scratch
    within SCRATCH_BYTES, at least one."""
    per_row = max(1, n_trees * n_feat * 8)
    return max(1, min(n_rows, SCRATCH_BYTES // per_row))


def tree_shap(forest: Tree, covers: torch.Tensor, X: torch.Tensor,
              scale: float, bias: float) -> torch.Tensor:
    """(N, F+1) f64: φ · scale of each feature summed over the stacked
    forest ((ntrees, T) fields: int32 feat, f32 thr, bool is_split, f32
    value; f32 covers) on f64 rows X (N, F) on a CUDA device, and `bias`
    in column F. Launches on the current stream with no synchronisation."""
    global launches, scratch_peak
    if X.device.type != "cuda":
        raise ValueError("shap_cuda.tree_shap runs on a CUDA device; "
                         "tree_shap.tree_shap_plain is the CPU version")
    nt, T = forest.feat.shape
    N, F = X.shape
    if (forest.feat.dtype != torch.int32 or forest.thr.dtype != torch.float32
            or forest.is_split.dtype != torch.bool
            or forest.value.dtype != torch.float32
            or covers.dtype != torch.float32 or X.dtype != torch.float64):
        raise TypeError("tree_shap takes int32 feat, f32 thr, bool is_split, "
                        "f32 value, f32 covers and f64 X; got "
                        f"{forest.feat.dtype}, {forest.thr.dtype}, "
                        f"{forest.is_split.dtype}, {forest.value.dtype}, "
                        f"{covers.dtype}, {X.dtype}")
    fields = (forest.feat, forest.thr, forest.is_split, forest.value, covers)
    if any(tuple(f.shape) != (nt, T) for f in fields):
        raise ValueError("forest fields differ in shape: "
                         f"{[tuple(f.shape) for f in fields]}")
    depth = heap_depth(T)
    if depth > MAX_DEPTH:
        raise ValueError(f"tree_shap takes heaps of depth ≤ {MAX_DEPTH}, "
                         f"not {depth}")
    if not all(t.is_contiguous() for t in fields + (X,)):
        raise ValueError("tree_shap takes contiguous tensors")
    if any(f.device != X.device for f in fields):
        raise ValueError("tree_shap inputs lie on different devices")
    out = torch.empty((N, F + 1), dtype=torch.float64, device=X.device)
    if N == 0:
        return out
    lib = build()
    rows = chunk_rows(N, nt, F)
    scratch = torch.empty(nt * rows * F, dtype=torch.float64, device=X.device)
    scratch_peak = max(scratch_peak, scratch.numel() * 8)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for r0 in range(0, N, rows):
            n = min(rows, N - r0)
            rc = lib.h2o3_tree_shap(
                forest.feat.data_ptr(), forest.thr.data_ptr(),
                forest.is_split.data_ptr(), forest.value.data_ptr(),
                covers.data_ptr(), X[r0:].data_ptr(), scratch.data_ptr(),
                out[r0:].data_ptr(), n, F, nt, T, depth, float(scale),
                float(bias), stream)
            hist_cuda.check_launch(rc, "TreeSHAP kernel")
            launches += 1
    return out

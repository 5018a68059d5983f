"""The TreeSHAP kernel for Hopper, its build and its launch.

`tree_shap` is the card's counterpart of the reference's native TreeSHAP
(`h2o3_tpu/native/tree_shap.cpp::h2o3_tree_shap`, host C++ with OpenMP
over rows; no Pallas kernel computes it): the (N, F+1) f64 path-dependent
contributions of one stacked forest. Its CUDA source is
`h2o3_tpu_torch/csrc/tree_shap.cu` (its comments give the design and the
bound), built at first use by `hist_cuda.build_library` into
`h2o3_tpu_torch/_build/` and loaded through `ctypes`.

The kernel reads the forest's path plan (`models/tree_shap.py::
build_shap_plan`, which a model keeps per forest), not its heaps: a block
takes one tree and a tile of rows, a thread one (row, tree) pair, and each
leaf's weights are rebuilt along its root path (from the root, or from the
weights kept at its common ancestor with the previous leaf); the tree's φ
goes to an (nt, rows, F) f64 scratch and a second kernel adds the trees in
tree order. The rows go in chunks that keep the scratch within SCRATCH_BYTES.
The plain version is `models/tree_shap.py::tree_shap_plain`, which
`compute_contributions` runs for tensors on the CPU; the two agree bit for
bit on the card. For tensors on a CUDA device a failed build or launch
raises `hist_cuda.KernelError`: nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..models.tree import Tree
from ..models.tree_shap import ShapPlan, build_shap_plan, heap_depth
from . import hist_cuda

SOURCE = hist_cuda.SOURCE.with_name("tree_shap.cu")
# the partial-φ scratch of one chunk of rows stays within this many bytes
SCRATCH_BYTES = 256 << 20
MAX_DEPTH = 30                   # tree_shap.cu kMaxDepth

# chunks launched on the card (one replay and one fold each)
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
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                       + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
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
              scale: float, bias: float,
              plan: Optional[ShapPlan] = None) -> torch.Tensor:
    """(N, F+1) f64: φ · scale of each feature summed over the stacked
    forest ((ntrees, T) fields: int32 feat, f32 thr, bool is_split, f32
    value; f32 covers) on f64 rows X (N, F) on a CUDA device, and `bias`
    in column F. `plan` is the forest's `build_shap_plan` for F features
    (built here where it is not given). Launches on the current stream
    with no synchronisation."""
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
    if not X.is_contiguous():
        raise ValueError("tree_shap takes contiguous rows")
    if any(f.device != X.device for f in fields):
        raise ValueError("tree_shap inputs lie on different devices")
    if plan is None:
        plan = build_shap_plan(forest, covers, F)
    tensors = [t for t in plan if isinstance(t, torch.Tensor)]
    if (plan.n_feat != F or plan.depth != depth
            or len(plan.tree_leaf) != nt + 1):
        raise ValueError(f"the plan is for {len(plan.tree_leaf) - 1} trees "
                         f"of depth {plan.depth} on {plan.n_feat} features, "
                         f"not {nt} of depth {depth} on {F}")
    if any(t.device != X.device or not t.is_contiguous() for t in tensors):
        raise ValueError("the plan's tensors must be contiguous on X's device")
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
                plan.tree_leaf.data_ptr(), plan.leaf_step.data_ptr(),
                plan.leaf_level.data_ptr(), plan.leaf_value.data_ptr(),
                plan.step_feat.data_ptr(), plan.step_thr.data_ptr(),
                plan.step_zin.data_ptr(), plan.step_ulev.data_ptr(),
                plan.step_right.data_ptr(), X[r0:].data_ptr(),
                scratch.data_ptr(), out[r0:].data_ptr(), n, F, nt, depth,
                float(scale), float(bias), stream)
            hist_cuda.check_launch(rc, "TreeSHAP kernel")
            launches += 1
    return out

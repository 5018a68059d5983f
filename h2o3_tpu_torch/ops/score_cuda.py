"""The forest-scoring kernel for Hopper, its build, and its plain version.

`forest_score` is the card's counterpart of the reference's fused forest
scorer (`h2o3_tpu/models/tree.py::predict_forest_fused` over
`build_score_table`): Σ over a stacked forest of leaf values on raw
features, NaN and x > thr going right. Its CUDA source is
`h2o3_tpu_torch/csrc/score.cu` (one thread per row, the trees in order;
its comments give the design and the bound), built at first use by
`hist_cuda.build_library` into `h2o3_tpu_torch/_build/` and loaded through
`ctypes`.

The plain version is `models/tree.py::predict_forest_raw`, the per-level
gather walk over all trees at once. `forest_score` takes it only for
tensors that lie on the CPU; for tensors on a CUDA device it launches the
kernel, and a failed build or launch raises `hist_cuda.KernelError`:
nothing falls back to the walk, and the serving failover does not serve
around it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..models.tree import Tree, heap_size, predict_forest_raw
from . import hist_cuda

SOURCE = hist_cuda.SOURCE.with_name("score.cu")

# kernel launches made by `forest_score` (one per call that reaches the
# card with at least one row and one tree)
launches = 0
# what nvcc printed for the last build (-Xptxas -v: registers, spills)
build_log = ""

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library; one
    thread builds (two serving workers may score first together), the
    others wait for it."""
    global _lib, build_log
    with _build_lock:
        if _lib is not None:
            return _lib
        lib, build_log = hist_cuda.build_library(SOURCE, "h2o3score")
        fn = lib.h2o3_forest_score
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def forest_score(forest: Tree, X: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(N,) f32: Σ over the stacked forest ((ntrees, T) fields, T ≥
    2^(max_depth+1) − 1) of each row's leaf value, on raw features X (N, F)
    f32. On a CUDA device this launches `h2o3_forest_score` on the current
    stream with no synchronisation, summing the trees in order in f32; on
    the CPU it is `predict_forest_raw`."""
    global launches
    if X.device.type == "cpu":
        return predict_forest_raw(forest, X, max_depth)
    nt, T = forest.feat.shape
    N, F = X.shape
    if (forest.feat.dtype != torch.int32 or forest.thr.dtype != torch.float32
            or forest.is_split.dtype != torch.bool
            or forest.value.dtype != torch.float32
            or X.dtype != torch.float32):
        raise TypeError("forest_score takes int32 feat, f32 thr, bool "
                        "is_split, f32 value and f32 X; got "
                        f"{forest.feat.dtype}, {forest.thr.dtype}, "
                        f"{forest.is_split.dtype}, {forest.value.dtype}, "
                        f"{X.dtype}")
    fields = (forest.feat, forest.thr, forest.is_split, forest.value)
    if any(tuple(f.shape) != (nt, T) for f in fields):
        raise ValueError("forest fields differ in shape: "
                         f"{[tuple(f.shape) for f in fields]}")
    if T < heap_size(max_depth):
        raise ValueError(f"a heap of {T} nodes is shallower than depth "
                         f"{max_depth}")
    if not all(t.is_contiguous() for t in fields + (X,)):
        raise ValueError("forest_score takes contiguous tensors")
    if any(f.device != X.device for f in fields):
        raise ValueError("forest_score inputs lie on different devices")
    out = torch.empty(N, dtype=torch.float32, device=X.device)
    if N == 0 or nt == 0:
        return out.zero_()
    if F == 0:
        raise ValueError("forest_score needs at least one feature column")
    lib = build()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.h2o3_forest_score(
            forest.feat.data_ptr(), forest.thr.data_ptr(),
            forest.is_split.data_ptr(), forest.value.data_ptr(),
            X.data_ptr(), out.data_ptr(), N, F, nt, T, max_depth, stream)
    hist_cuda.check_launch(rc, "forest scoring kernel")
    launches += 1
    return out

"""The forest-scoring kernels for Hopper, their build, launch plans and
packed score table, and their plain versions.

`forest_score` is the card's counterpart of the reference's fused forest
scorer (`h2o3_tpu/models/tree.py::predict_forest_fused` over
`build_score_table`): Σ over a stacked forest of leaf values on raw
features, NaN and x > thr going right, the trees added in order in f32
from 0.0. Its CUDA source is `h2o3_tpu_torch/csrc/score.cu` (its comments
give the design and the bound), built at first use by
`hist_cuda.build_library` into `h2o3_tpu_torch/_build/` and loaded through
`ctypes`.

The kernels walk a packed score table (`build_score_pack`): one 8-byte
record {thr, feat} a node, feat −1 where the node is not split, built once
per model with plain torch ops, as the reference builds its walk table
once. `score_plan` picks one of two launch plans by the forest's size
alone (the rows set only the plan's grid):

* resident — the forest's records and leaf values fit a block's shared
  memory (at most RESIDENT_BYTES): every block holds the whole forest and
  walks its tiles of rows there; one launch.
* streamed — any larger forest: a tree-major grid of (chunk of
  STREAM_CHUNK trees, a number compiled into score.cu, row range) blocks,
  each holding its chunk's top STREAM_LEVELS levels in shared memory,
  writing per-tree leaf values to an (nt, N) scratch that a second kernel
  folds over the trees in order.

The GBM's forest is resident at every row count, the served batches of 64
to 512 rows included, although the streamed plan measured faster there
(PERF.md §6): a few microseconds of a request that the host's frame work
holds for milliseconds.

The plain versions are `models/tree.py::predict_forest_raw` (the per-level
gather walk over all trees at once, what `forest_score` runs for tensors on
the CPU) and `predict_forest_ordered` (the same walk, the trees added in
the kernels' order: on the card the kernels equal it bit for bit). For
tensors on a CUDA device `forest_score` launches a plan, and a failed
build, a refused shared-memory size or a failed launch raises
`hist_cuda.KernelError`: nothing falls back to the walk, and the serving
failover does not serve around it.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ..models.tree import Tree, heap_size, predict_forest_raw
from . import hist_cuda

SOURCE = hist_cuda.SOURCE.with_name("score.cu")

THREADS = 256                    # score.cu kThreads: rows per tile, one a thread
MAX_THREADS_SM = 2048            # resident threads per SM (Hopper)
# the resident plan takes forests whose staged records and leaf values
# need at most this many bytes, which leaves a tile of rows room beside
# them in a block's shared memory (hist_cuda.SMEM_MAX)
RESIDENT_BYTES = 160 * 1024
# the streamed plan: trees per block (score.cu's kChunk, compiled in; each
# is a walk in flight per thread) and the levels of each tree a block
# stages; the row ranges are sized so that the blocks resident at once fill
# the card with one chunk (`stream_rows_per_block`). tools/score_plans.py
# --sweep chose them on an H100 (score.cu's note has the numbers).
STREAM_CHUNK = 2
STREAM_LEVELS = 12
RECORD_BYTES = 8

# calls that reached the card with at least one row and one tree (one per
# call, whatever the plan launches), and of those, the ones each plan served
launches = 0
launches_resident = 0
launches_streamed = 0
# score tables built by `build_score_pack`
pack_builds = 0
# what nvcc printed for the last build (-Xptxas -v: registers, spills)
build_log = ""

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


class ScorePack(NamedTuple):
    """A forest's packed score table: `nodes` (nt, T, 2) int32 holds each
    node's record {thr's f32 bits, feat}, feat −1 where the node is not
    split and clamped into [0, n_feat) elsewhere; `forest` is the stacked
    `Tree` it was built from (its `value` field is read in place)."""
    nodes: torch.Tensor
    n_feat: int
    forest: Tree


class ScorePlan(NamedTuple):
    """One `forest_score` launch: the plan's kind ('resident' or
    'streamed'), its grid and dynamic shared bytes per block, whether a
    block stages its rows of X in shared memory (where they fit beside the
    forest's records), and for the streamed plan the trees per chunk, the
    staged levels, the rows per block and the row blocks per chunk (0 for
    the resident plan)."""
    kind: str
    grid: int
    smem: int
    stage_x: bool
    chunk: int = 0
    staged_levels: int = 0
    rows_per_block: int = 0
    row_blocks: int = 0


def build_score_pack(forest: Tree, n_feat: int) -> ScorePack:
    """The packed score table of a stacked forest for rows of `n_feat`
    features, built with plain torch ops on the forest's device (8 bytes a
    node)."""
    global pack_builds
    if n_feat <= 0:
        raise ValueError("a score table needs at least one feature column")
    feat = torch.where(forest.is_split, forest.feat.clamp(0, n_feat - 1),
                       torch.full_like(forest.feat, -1))
    nodes = torch.stack([forest.thr.contiguous().view(torch.int32),
                         feat.to(torch.int32)], dim=-1).contiguous()
    pack_builds += 1
    return ScorePack(nodes, int(n_feat), forest)


def _x_tile_bytes(n_feat: int) -> int:
    return THREADS * (n_feat | 1) * 4


def _blocks_per_sm(smem: int) -> int:
    return max(1, min(MAX_THREADS_SM // THREADS,
                      hist_cuda.SMEM_SM // (smem + 1024)))


def resident_bytes(n_trees: int, depth: int) -> int:
    """Shared bytes of a forest's staged records (levels < depth) and leaf
    values (levels ≤ depth)."""
    return n_trees * (RECORD_BYTES * (2 ** depth - 1) + 4 * heap_size(depth))


def stream_rows_per_block(n_rows: int, resident_blocks: int) -> int:
    """Rows per streamed block: whole tiles, as few as let one chunk's row
    blocks fill the blocks the card holds at once."""
    tiles = -(-n_rows // THREADS)
    return THREADS * max(1, -(-tiles // max(1, resident_blocks)))


def score_plan(n_trees: int, depth: int, n_feat: int, n_rows: int,
               sms: int = 132, kind: Optional[str] = None) -> ScorePlan:
    """The launch plan of one `forest_score` call on a card of `sms` SMs, a
    pure function of its arguments. The kind is resident where the
    forest's staged bytes fit RESIDENT_BYTES, else streamed, whatever the
    rows (`kind` forces one; the tests run each plan on every shape); the
    rows set the grid, and a block stages its rows where they fit beside
    the forest's records."""
    staged = resident_bytes(n_trees, depth)
    kind = kind or ("resident" if staged <= RESIDENT_BYTES else "streamed")
    tiles = max(1, -(-n_rows // THREADS))
    if kind == "resident":
        if staged > hist_cuda.SMEM_MAX:
            raise ValueError(f"{n_trees} trees of depth {depth} need {staged} "
                             "bytes of shared memory")
        stage_x = staged + _x_tile_bytes(n_feat) <= hist_cuda.SMEM_MAX
        smem = staged + (_x_tile_bytes(n_feat) if stage_x else 0)
        grid = min(tiles, _blocks_per_sm(smem) * sms)
        return ScorePlan("resident", grid, smem, stage_x)
    if kind != "streamed":
        raise ValueError(f"unknown scoring plan {kind!r}")
    levels = min(STREAM_LEVELS, depth)
    recs = RECORD_BYTES * STREAM_CHUNK * (2 ** levels - 1)
    stage_x = recs + _x_tile_bytes(n_feat) <= hist_cuda.SMEM_MAX
    smem = recs + (_x_tile_bytes(n_feat) if stage_x else 0)
    rpb = stream_rows_per_block(n_rows, _blocks_per_sm(smem) * sms)
    row_blocks = -(-max(n_rows, 1) // rpb)
    grid = -(-n_trees // STREAM_CHUNK) * row_blocks
    return ScorePlan("streamed", grid, smem, stage_x, STREAM_CHUNK, levels,
                     rpb, row_blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a loaded score.cu library; returns it."""
    fn = lib.h2o3_forest_score_resident
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.h2o3_forest_score_streamed
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.h2o3_forest_score_stream_chunk.argtypes = []
    lib.h2o3_forest_score_stream_chunk.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library; one
    thread builds (two serving workers may score first together), the
    others wait for it."""
    global _lib, build_log
    with _build_lock:
        if _lib is not None:
            return _lib
        lib, build_log = hist_cuda.build_library(SOURCE, "h2o3score")
        chunk = bind(lib).h2o3_forest_score_stream_chunk()
        if chunk != STREAM_CHUNK:
            raise hist_cuda.KernelError(
                f"score.cu streams {chunk} trees a block, the wrapper plans "
                f"for {STREAM_CHUNK}")
        _lib = lib
        return lib


def forest_score(forest: Tree, X: torch.Tensor, max_depth: int,
                 pack: Optional[ScorePack] = None,
                 kind: Optional[str] = None) -> torch.Tensor:
    """(N,) f32: Σ over the stacked forest ((ntrees, T) fields, T ≥
    2^(max_depth+1) − 1) of each row's leaf value, on raw features X (N, F)
    f32. On a CUDA device this launches `score_plan`'s plan (of `kind`,
    where given) on the current stream with no synchronisation, over
    `pack` (the forest's score table, built here when not given), adding
    the trees in order in f32 from 0.0; on the CPU it is
    `predict_forest_raw`."""
    global launches, launches_resident, launches_streamed
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
    if max_depth > 30 or T >= 2 ** 31:
        raise ValueError(f"forest_score takes heaps of depth ≤ 30 and "
                         f"< 2^31 nodes, not depth {max_depth}, {T} nodes")
    if not all(t.is_contiguous() for t in fields + (X,)):
        raise ValueError("forest_score takes contiguous tensors")
    if any(f.device != X.device for f in fields):
        raise ValueError("forest_score inputs lie on different devices")
    out = torch.empty(N, dtype=torch.float32, device=X.device)
    if N == 0 or nt == 0:
        return out.zero_()
    if F == 0:
        raise ValueError("forest_score needs at least one feature column")
    if pack is None:
        pack = build_score_pack(forest, F)
    elif pack.forest is not forest or pack.n_feat != F:
        raise ValueError(f"the score table was built for another forest or "
                         f"for {pack.n_feat} features, not these {F}")
    lib = build()
    plan = score_plan(nt, max_depth, F, N, _sm_count(X.device.index or 0),
                      kind=kind)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if plan.kind == "resident":
            rc = lib.h2o3_forest_score_resident(
                pack.nodes.data_ptr(), forest.value.data_ptr(), X.data_ptr(),
                out.data_ptr(), N, F, nt, T, max_depth, int(plan.stage_x),
                plan.grid, plan.smem, stream)
        else:
            scratch = torch.empty((nt, N), dtype=torch.float32,
                                  device=X.device)
            rc = lib.h2o3_forest_score_streamed(
                pack.nodes.data_ptr(), forest.value.data_ptr(), X.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), N, F, nt, T, max_depth,
                plan.staged_levels, plan.rows_per_block,
                int(plan.stage_x), plan.smem, stream)
    hist_cuda.check_launch(rc, f"forest scoring kernel ({plan.kind} plan)")
    launches += 1
    if plan.kind == "resident":
        launches_resident += 1
    else:
        launches_streamed += 1
    return out

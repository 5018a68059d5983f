"""Dataset-artifact cache — bin, pack and upload a training frame once per
sweep.

Port of `h2o3_tpu/models/dataset_cache.py`. Every tree fit runs the same
preparation over its training frame: `frame_to_matrix` (Frame → f64
matrix), `build_bins` (bin codes), the sub-byte pack and the upload of the
code matrix. A grid, an AutoML run or a set of CV candidates repeats that
per candidate although every candidate shares one (frame, x) pair. This
cache keeps each artifact once, in five layers of one fingerprinted entry:

- **matrix**: key(frame, x) → (X f64, is_categorical, domains);
- **bins**: + (nbins, histogram_type[, seed for Random]) → `BinnedMatrix`;
- **device**: + (padded rows, pack mode, device) → the packed code matrix
  as a torch tensor on the fit's device, so repeat candidates skip the
  pack and the upload;
- **blocks**: + (padded rows, pack mode, block count, device) → the
  out-of-core `block_store.BlockStore` (host blocks, a bounded device
  set), accounted through this entry's ``dataset_cache:<fp>:blocks``
  ledger owner;
- **std**: + a key the estimator engine composes (`estimator_engine.py`)
  → the standardized design of the non-tree estimators (GLM, K-Means, PCA,
  GLRM, DeepLearning): the fitted `DataInfo` with its host matrix or its
  device tensor.

Fingerprint: frame identity (id, key, a weakref guard), row count, the
frame's mutation counter (`Frame._touch` bumps `_version`), the x column
list and each column's Vec and buffer identity: replacing a column or
assigning one in place invalidates, and new frames get new entries.

Eviction: LRU over entries with an entry cap (``H2O3_DATASET_CACHE_ENTRIES``,
default 4) and a byte cap (``H2O3_DATASET_CACHE_MB``, default 1024, host
and device bytes). Past the memory ledger's eviction threshold the cache
sheds block stores' device blocks first, then their host blocks to disk,
then LRU entries. Dead frames drop their entries through a weakref
callback. ``H2O3_DATASET_CACHE=0`` turns the cache off. `snapshot()`
gives hits, misses and evictions per layer.

The port keys the device, blocks and std layers by the torch device as
well: one process may fit on the CPU and on the card.

Pod fits (a tree fit on a multi-process cloud, `shared_tree`'s pod lane)
reuse the cache too. Their bins and device codes are this rank's
artifacts of a global layout: the bins carry the global column ranges
(and QuantilesGlobal edges), the device layer this rank's canonical slice
of the padded rows. Both keys carry the fit's `layout` — the cloud size,
the rank and a `digest` of the global facts (ranges, edges, per-rank row
counts) — so a pod never reads a one-rank entry or a stale one when
another rank's frame changed. The collectives that produce those facts
and the canonical row exchange run eagerly in every fit, before any
build callback, and the callbacks are collective-free: a hit on one rank and a
miss on another can never strand a rank inside a collective. The
estimator engine's pod and mesh layouts are ROADMAP queue A, item 9.
"""

from __future__ import annotations

import hashlib
import os
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from ..runtime import memory_ledger as _memory

_LOCK = threading.RLock()
_ENTRIES: "OrderedDict[tuple, _Entry]" = OrderedDict()
_STATS = dict(matrix_hits=0, matrix_misses=0, bins_hits=0, bins_misses=0,
              device_hits=0, device_misses=0, blocks_hits=0,
              blocks_misses=0, std_hits=0, std_misses=0, evictions=0)
_LAYERS = ("matrix", "bins", "device", "blocks", "std")


def enabled() -> bool:
    return os.environ.get("H2O3_DATASET_CACHE", "1") not in ("0", "false",
                                                             "no")


def _caps() -> Tuple[int, int]:
    """(max entries, max bytes), read per call so tests can tune them."""
    ents = int(os.environ.get("H2O3_DATASET_CACHE_ENTRIES", 4))
    mb = float(os.environ.get("H2O3_DATASET_CACHE_MB", 1024))
    return max(ents, 1), int(mb * 1e6)


def _arr_nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(arr.nbytes)


class _StdArtifact:
    """One cached standardized-design artifact: the value the engine wants
    back, its bytes, and the space (``host`` or ``device``) they lie in."""

    __slots__ = ("value", "_nbytes", "space")

    def __init__(self, value, nbytes: int, space: str = "host"):
        self.value = value
        self._nbytes = int(nbytes)
        self.space = space

    def nbytes(self) -> int:
        return self._nbytes


class _Entry:
    __slots__ = ("frame_ref", "key", "matrix", "bins", "device", "blocks",
                 "std", "lock", "owner_base", "__weakref__")

    def __init__(self, frame, key):
        self.frame_ref = weakref.ref(frame, lambda _: _drop(key))
        self.key = key
        self.matrix = None                      # (X, is_cat, doms)
        self.bins: Dict[tuple, object] = {}     # bkey -> BinnedMatrix
        self.device: Dict[tuple, object] = {}   # dkey -> torch tensor
        self.blocks: Dict[tuple, object] = {}   # dkey -> BlockStore
        self.std: Dict[tuple, _StdArtifact] = {}
        self.lock = threading.Lock()            # serializes builds per entry
        self.owner_base = ""                    # memory-ledger owner prefix

    def nbytes(self) -> int:
        total = 0
        if self.matrix is not None:
            total += int(self.matrix[0].nbytes)
        for bm in self.bins.values():
            total += int(bm.codes.nbytes)
        for arr in self.device.values():
            total += _arr_nbytes(arr)
        for st in self.blocks.values():
            total += int(st.nbytes_total())
        for art in self.std.values():
            total += art.nbytes()
        return total


def _register_ledger(e: _Entry, frame) -> None:
    """Ledger owners `dataset_cache:<fp>:<layer>`, one per layer, their
    byte callbacks through a weakref (the ledger never pins an evicted
    entry), the referent the owning frame."""
    e.owner_base = f"dataset_cache:{_memory.fingerprint(e.key)}"
    wr = weakref.ref(e)

    def _layer_fn(layer):
        def _bytes():
            ent = wr()
            if ent is None:
                return (0, 0)
            return _memory.measure(getattr(ent, layer))
        return _bytes

    for layer in _LAYERS:
        _memory.register(f"{e.owner_base}:{layer}", kind="dataset_cache",
                         bytes_fn=_layer_fn(layer), referent=frame,
                         type_name=layer)


def _release_entry(e: _Entry, trigger: str) -> None:
    """Unregister an entry's owners and record one eviction event with the
    bytes freed and why (cap, pressure, weakref, clear). Its block stores
    are closed, so their spill files go with the entry."""
    if not e.owner_base:
        return
    freed = e.nbytes()
    _memory.record_event("evict", e.owner_base, freed, trigger=trigger,
                         kind="dataset_cache",
                         space="device" if e.device else "host")
    for layer in _LAYERS:
        _memory.unregister(f"{e.owner_base}:{layer}")
    for st in list(e.blocks.values()):
        st.close()


def _drop(key) -> None:
    with _LOCK:
        e = _ENTRIES.pop(key, None)
    if e is not None:
        try:
            _release_entry(e, "weakref")
        except Exception:
            # interpreter teardown: a frame dying at exit fires this
            # callback after module globals are gone
            pass


def _frame_key(frame, x: Tuple[str, ...]) -> tuple:
    cols = tuple(
        (n, id(v), id(v.data) if getattr(v, "data", None) is not None else 0)
        for n, v in ((n, frame.vec(n)) for n in x))
    return (id(frame), frame.key, int(frame.nrow),
            int(getattr(frame, "_version", 0)), x, cols)


def _entry_for(frame, x: Tuple[str, ...]) -> _Entry:
    key = _frame_key(frame, x)
    with _LOCK:
        e = _ENTRIES.get(key)
        if e is not None and e.frame_ref() is frame:
            _ENTRIES.move_to_end(key)
            return e
        e = _ENTRIES[key] = _Entry(frame, key)
        _register_ledger(e, frame)
        _evict_locked(keep=key)
        return e


def _pop_entry_locked(key, trigger: str) -> None:
    e = _ENTRIES.pop(key, None)
    if e is None:
        return
    _STATS["evictions"] += 1
    _release_entry(e, trigger)


def _evict_locked(keep=None) -> None:
    """LRU-evict entries other than `keep` until both caps are met; then,
    past the ledger's eviction threshold, shed block stores' device blocks
    (a shed block keeps its host copy), then their host blocks to disk,
    then every other entry, oldest first."""
    # iterate snapshots: _LOCK is reentrant, so a frame's weakref death
    # callback fired by GC in this thread can pop from _ENTRIES meanwhile
    max_entries, max_bytes = _caps()
    victims = [k for k in list(_ENTRIES) if k != keep]
    while victims and len(_ENTRIES) > max_entries:
        _pop_entry_locked(victims.pop(0), "cap")
    while victims and sum(e.nbytes() for e in list(_ENTRIES.values())) \
            > max_bytes:
        _pop_entry_locked(victims.pop(0), "cap")
    if not (victims or any(e.blocks for e in list(_ENTRIES.values()))):
        return
    if _memory.pressure() < _memory.evict_threshold():
        return
    for e in list(_ENTRIES.values()):
        for st in list(e.blocks.values()):
            st.shed(trigger="pressure")
    for e in list(_ENTRIES.values()):
        for st in list(e.blocks.values()):
            st.shed_host(trigger="pressure")
    while victims:
        _pop_entry_locked(victims.pop(0), "pressure")


def digest(*facts) -> str:
    """A short fingerprint of host arrays (None, arrays or lists of them):
    the global facts a pod's layout key carries."""
    import numpy as np

    h = hashlib.blake2b(digest_size=12)

    def feed(v):
        if v is None:
            h.update(b"\0")
        elif isinstance(v, (list, tuple)):
            h.update(b"[%d" % len(v))
            for u in v:
                feed(u)
        else:
            a = np.ascontiguousarray(v)
            h.update(str((a.dtype, a.shape)).encode())
            h.update(a.tobytes())

    for f in facts:
        feed(f)
    return h.hexdigest()


def _bins_key(nbins: int, histogram_type: str, seed) -> tuple:
    ht = "UniformAdaptive" if histogram_type in ("AUTO", None) \
        else str(histogram_type)
    # only Random binning draws from the seed; other types share across seeds
    return (int(nbins), ht, int(seed) if ht == "Random" else None)


def _cached(frame, x, layer: str, key, build: Callable, nbytes_of,
            space="host"):
    """The one get-or-build of every layer but matrix: look `key` up in
    the entry's `layer` dict, build and publish it on a miss. `space` is
    the ledger space of the built value, or a function of it."""
    e = _entry_for(frame, tuple(x))
    with e.lock:
        table = getattr(e, layer)
        val = table.get(key)
        if val is not None:
            with _LOCK:
                _STATS[f"{layer}_hits"] += 1
            return val
        with _LOCK:
            _STATS[f"{layer}_misses"] += 1
        val = build()
        # publish under _LOCK: nbytes()/snapshot() iterate the entry's
        # dicts holding only _LOCK (lock order: entry.lock, then _LOCK)
        with _LOCK:
            table[key] = val
        _memory.record_event("alloc", f"{e.owner_base}:{layer}",
                             nbytes_of(val), trigger="miss",
                             kind="dataset_cache",
                             space=space(val) if callable(space) else space)
    with _LOCK:
        _evict_locked(keep=e.key)
    return val


def matrix(frame, x, build: Callable[[], tuple]):
    """(X, is_categorical, domains) for (frame, x)."""
    e = _entry_for(frame, tuple(x))
    with e.lock:
        if e.matrix is not None:
            with _LOCK:
                _STATS["matrix_hits"] += 1
            return e.matrix
        with _LOCK:
            _STATS["matrix_misses"] += 1
        built = build()
        with _LOCK:
            e.matrix = built
        _memory.record_event("alloc", f"{e.owner_base}:matrix",
                             int(built[0].nbytes), trigger="miss",
                             kind="dataset_cache")
    with _LOCK:
        _evict_locked(keep=e.key)
    return e.matrix


def bins(frame, x, nbins: int, histogram_type: str, seed,
         build: Callable[[], object], layout=None):
    """`BinnedMatrix` for (frame, x, nbins, histogram_type); a pod fit
    passes its `layout`."""
    return _cached(frame, x, "bins",
                   _bins_key(nbins, histogram_type, seed) + (layout,),
                   build, lambda bm: int(bm.codes.nbytes))


def device_codes(frame, x, nbins: int, histogram_type: str, seed, npad: int,
                 build: Callable[[], torch.Tensor], pack_bits: int,
                 device: torch.device, layout=None):
    """The padded code matrix on `device` (the packed words when
    `pack_bits`), so repeat candidates skip the pack and the upload; on a
    pod (`layout`) this rank's canonical slice of it. `build` packs and
    uploads on a miss."""
    key = (_bins_key(nbins, histogram_type, seed), int(npad), int(pack_bits),
           str(device), layout)
    return _cached(frame, x, "device", key, build, _arr_nbytes,
                   space="device" if torch.device(device).type == "cuda"
                   else "host")


def blocked_codes(frame, x, nbins: int, histogram_type: str, seed, npad: int,
                  build: Callable[[], object], pack_bits: int,
                  n_blocks: int, device: torch.device):
    """The out-of-core `BlockStore` of the padded code matrix: packed host
    blocks and a bounded device set, shared by a sweep's candidates. The
    store registers no ledger owner of its own: this entry's ``blocks``
    layer accounts it. `build` packs the blocks on a miss."""
    key = (_bins_key(nbins, histogram_type, seed), int(npad), int(pack_bits),
           int(n_blocks), str(device))
    return _cached(frame, x, "blocks", key, build,
                   lambda st: int(st.host_bytes()))


def std_artifact(frame, x, skey: tuple, build: Callable[[], tuple]):
    """The standardized-design artifact for (frame, x, skey). `skey`
    carries the standardization, expansion and layout parameters
    (composed by `estimator_engine.py`, the one place the key layout
    lives); `build` returns ``(value, nbytes, space)`` on a miss."""
    def make():
        value, nbytes, space = build()
        return _StdArtifact(value, nbytes, space)

    art = _cached(frame, x, "std", tuple(skey), make,
                  lambda a: a.nbytes(), space=lambda a: a.space)
    return art.value


def snapshot() -> Dict:
    with _LOCK:
        stats = dict(_STATS)
        entries = len(_ENTRIES)
        nbytes = sum(e.nbytes() for e in list(_ENTRIES.values()))
    stats.update(entries=entries, bytes=int(nbytes), enabled=enabled())
    return stats


def clear() -> None:
    """Drop every entry (tests, explicit memory release)."""
    with _LOCK:
        doomed = list(_ENTRIES.values())
        _ENTRIES.clear()
    for e in doomed:
        _release_entry(e, "clear")


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0

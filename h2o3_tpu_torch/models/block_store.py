"""BlockStore — the row-blocked packed code matrix of the out-of-core path.

Port of `h2o3_tpu/models/block_store.py` (after "Out-of-Core GPU Gradient
Boosting", arXiv 2005.09148): the sub-byte packed bin-code matrix lives on
the host as equal row blocks, and only a bounded resident set of blocks
lives on the device at a time. The streamed tree step
(`models/tree_stream.py`) walks the blocks in order; the block grid is
the in-core blocked reduction's (``H2O3_TREE_SHARD=1``), so a streamed
histogram folds the same per-block partials in the same order and the
fit equals the in-core blocks-lane fit bit for bit.

Three tiers, each an LRU:

- **device**: a resident set bounded by a byte budget
  (``H2O3_STREAM_BUDGET_MB``, default half the card's memory as the
  memory ledger sees it, `stream_budget_bytes`), floored at two blocks
  (the double buffer). Past the ledger's eviction threshold `get` sheds
  every device block but the double buffer first (`shed`): a shed block
  costs only a later upload.
- **host**: the packed blocks, each packed on its own with
  `ops.packing.pack_host_range` and, for a store on the card, pinned once
  when the store is built. A host budget (``H2O3_STREAM_HOST_BUDGET_MB``,
  default half the ledger's host budget; ``H2O3_TREE_OOC_DISK=0`` turns
  the tier off) spills the LRU host blocks past it.
- **disk**: spill files written through the persist layer
  (`runtime/persist.py`) as ``.part`` then renamed, read back through its
  resuming reader (a torn or injected ``persist.read`` failure resumes at
  its offset under the retry policy). A restored block is byte-identical
  to the packed one and uploads from pageable memory. Spill files live in
  ``H2O3_SPILL_DIR`` (default the temporary directory) and belong to a
  ``<owner>:spill`` ledger owner in the ``disk`` space whose bytes come
  from the filesystem: a store dropped without `close()` reads as a leak.

On the card `prefetch(b)` starts block b's copy on a side CUDA stream
while the caller's kernels run on the block before it; `get(b)` makes the
caller's stream wait on the copy's event and calls `record_stream` on the
block's tensor, so the caching allocator does not hand its memory to a
later copy while a kernel the caller enqueued still reads it. Once blocks
live on disk, `prefetch` runs the disk read and the copy on one
background thread (a strict double buffer).

Accounting: a store is a memory-ledger owner (``block_store:<id>``), or
is accounted by its dataset-cache entry's ``blocks`` layer when the cache
holds it (``register=False``). Every eviction, spill and restore is a
``memory`` event (owner, bytes, trigger, space) on the Timeline. Counters
(uploaded/evicted/reused blocks, streamed, spilled and restored bytes)
feed `stats()`, the fit's `_stream_stats` and the ``h2o3_tree_stream_*``
and ``h2o3_tree_spill_*`` registry families; transfers book the
``h2d_stream`` and ``disk_stream`` phases (`runtime/phases.py`).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import packing
from ..runtime import env_float
from ..runtime import memory_ledger as _ml
from ..runtime import persist as _persist
from ..runtime import phases as _phases

_TOTALS_LOCK = threading.Lock()
# process-lifetime stream totals
_TOTALS = {"streamed_bytes": 0, "resident_block_peak": 0,
           "spilled_bytes": 0, "restored_bytes": 0,
           "resident_host_peak": 0}

_REG: Dict = {}


def _registry() -> Dict:
    """Memoized registry families."""
    if not _REG:
        from ..runtime import metrics_registry as reg

        _REG["blocks"] = reg.counter(
            "h2o3_tree_stream_blocks",
            "out-of-core code blocks by lifecycle event "
            "(uploaded/evicted/reused)",
            labelnames=("event",))
        _REG["bytes"] = reg.counter(
            "h2o3_tree_stream_bytes",
            "bytes streamed host->device by the out-of-core tree path")
        _REG["resident_peak"] = reg.gauge(
            "h2o3_tree_stream_resident_peak_bytes",
            "high watermark of device-resident out-of-core block bytes")
        _REG["spill_blocks"] = reg.counter(
            "h2o3_tree_spill_blocks",
            "disk-tier block events (spilled: host->disk write or host "
            "drop with a disk copy kept; restored: disk->host read)",
            labelnames=("event",))
        _REG["spill_bytes"] = reg.counter(
            "h2o3_tree_spill_bytes",
            "disk-tier bytes by direction (spill: written host->disk; "
            "restore: read disk->host)",
            labelnames=("direction",))
        _REG["spill_host_peak"] = reg.gauge(
            "h2o3_tree_spill_resident_host_peak_bytes",
            "high watermark of host-resident out-of-core block bytes "
            "while the disk tier is active")
    return _REG


def stream_budget_bytes(device=None) -> int:
    """The resident-set byte budget: ``H2O3_STREAM_BUDGET_MB`` when set,
    else half the device capacity the memory ledger sees for `device`;
    the other half stays free for margins, histograms and the forest."""
    mb = env_float("H2O3_STREAM_BUDGET_MB", 0.0)
    if mb > 0:
        return int(mb * 1e6)
    return max(_ml.device_capacity_bytes(device) // 2, 1)


def stream_host_budget_bytes() -> int:
    """The host-resident byte budget of the disk tier:
    ``H2O3_STREAM_HOST_BUDGET_MB`` when set, else half the ledger's host
    budget; 0 (or ``H2O3_TREE_OOC_DISK=0``) turns the tier off."""
    if os.environ.get("H2O3_TREE_OOC_DISK", "") == "0":
        return 0
    mb = env_float("H2O3_STREAM_HOST_BUDGET_MB", 0.0)
    if mb > 0:
        return int(mb * 1e6)
    return max(_ml._host_budget_bytes() // 2, 1)


def process_totals() -> Dict:
    """Cumulative stream totals (0s when never used)."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def _account_totals(nbytes: int = 0, resident: int = 0) -> None:
    with _TOTALS_LOCK:
        _TOTALS["streamed_bytes"] += int(nbytes)
        if resident > _TOTALS["resident_block_peak"]:
            _TOTALS["resident_block_peak"] = int(resident)


def _account_spill_totals(spilled: int = 0, restored: int = 0,
                          host_peak: int = 0) -> None:
    with _TOTALS_LOCK:
        _TOTALS["spilled_bytes"] += int(spilled)
        _TOTALS["restored_bytes"] += int(restored)
        if host_peak > _TOTALS["resident_host_peak"]:
            _TOTALS["resident_host_peak"] = int(host_peak)


class BlockStore:
    """Packed row blocks across three LRU tiers: a bounded device resident
    set, a bounded host set and spill files on disk."""

    _IDS = iter(range(1 << 62))

    def __init__(self, host_blocks: List[np.ndarray], block_rows: int,
                 pack_bits: int, budget_bytes: Optional[int] = None,
                 host_budget_bytes: Optional[int] = None,
                 register: bool = True, device=None):
        self.device = torch.device(device or "cpu")
        self.n_blocks = len(host_blocks)
        self.block_rows = int(block_rows)
        self.pack_bits = int(pack_bits)
        self.owner = f"block_store:{next(self._IDS)}"
        on_card = self.device.type == "cuda"
        # pinned once, here: the numpy view keeps its pinned tensor alive,
        # and a copy from pinned memory can run on a side stream
        self.host_blocks = [
            torch.from_numpy(np.ascontiguousarray(hb)).pin_memory().numpy()
            if on_card else hb for hb in host_blocks]
        self._side = torch.cuda.Stream(self.device) if on_card else None
        # resolved once: the default asks the ledger for the card's size
        self._budget = (int(budget_bytes) if budget_bytes is not None
                        else stream_budget_bytes(self.device))
        self._host_budget = (int(host_budget_bytes)
                             if host_budget_bytes is not None
                             else stream_host_budget_bytes())
        # sizes and types pinned up front: a spilled slot holds None
        self._block_nbytes = [int(hb.nbytes) for hb in self.host_blocks]
        self._block_meta = [(hb.shape, hb.dtype) for hb in self.host_blocks]
        self._lock = threading.Lock()
        # block id -> (tensor, copy event or None), in LRU order
        self._resident: "OrderedDict[int, tuple]" = OrderedDict()
        self._resident_bytes = 0
        self._window_peak = 0
        # host LRU: block id -> None for host-resident blocks
        self._host_lru: "OrderedDict[int, None]" = OrderedDict(
            (b, None) for b in range(self.n_blocks))
        self._host_bytes_resident = sum(self._block_nbytes)
        self._host_window_peak = self._host_bytes_resident
        self._on_disk: set = set()          # blocks with a spill file
        self._spill_dir: Optional[str] = None
        self._spill_registered = False
        self._pending: set = set()          # asynchronous prefetches
        self._pool = None
        # serializes the restore path (evict, read, insert) so a prefetch
        # and the caller cannot both claim the same host headroom
        self._restore_lock = threading.Lock()
        self.counters = dict(uploaded=0, evicted=0, reused=0,
                             bytes_streamed=0, spilled=0, restored=0,
                             bytes_spilled=0, bytes_restored=0)
        self.resident_peak_bytes = 0
        self.host_resident_peak_bytes = self._host_bytes_resident
        self._registered = False
        if register:
            # standalone owner: a dropped store retires its owner
            wr = weakref.ref(self)

            def _bytes():
                st = wr()
                if st is None:
                    return (0, 0)
                return st.host_bytes(), st.resident_bytes()

            _ml.register(self.owner, kind="block_store", bytes_fn=_bytes,
                         referent=self, type_name="blocks")
            self._registered = True
        if self._host_budget > 0:
            self._enforce_host_budget(keep=())

    # -- construction ------------------------------------------------------

    @classmethod
    def from_codes(cls, codes: np.ndarray, n_blocks: int, pack_bits: int,
                   **kw) -> "BlockStore":
        """A store of `n_blocks` blocks of a padded full-width code matrix,
        each packed on its own (`pack_host_range`: O(block) transients);
        with ``pack_bits=0`` each block is a contiguous row copy."""
        n = codes.shape[0]
        if n % n_blocks:
            raise ValueError(f"{n} rows do not divide into {n_blocks} blocks")
        rows = n // n_blocks
        if pack_bits and rows % packing.GROUP_ROWS[pack_bits]:
            raise ValueError(
                f"block rows {rows} not aligned to the {pack_bits}-bit "
                "pack group")
        blocks = [packing.pack_host_range(codes, pack_bits, b * rows,
                                          (b + 1) * rows) if pack_bits
                  else np.ascontiguousarray(codes[b * rows:(b + 1) * rows])
                  for b in range(n_blocks)]
        return cls(blocks, rows, pack_bits, **kw)

    # -- sizes -------------------------------------------------------------

    def host_bytes(self) -> int:
        """Host-resident block bytes (spilled slots count as disk bytes)."""
        with self._lock:
            return self._host_bytes_resident

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def disk_bytes(self) -> int:
        """Bytes held by spill files (kept after a restore, so a later host
        shed of that block is free)."""
        with self._lock:
            return sum(self._block_nbytes[b] for b in self._on_disk)

    def nbytes_total(self) -> int:
        return self.host_bytes() + self.resident_bytes()

    def budget_bytes(self) -> int:
        """Resident budget, floored at two blocks (the double buffer)."""
        return max(self._budget, 2 * max(self._block_nbytes, default=0))

    def host_budget_bytes(self) -> int:
        """Host-tier budget (0: no disk tier), floored at two blocks."""
        if self._host_budget <= 0:
            return 0
        return max(self._host_budget, 2 * max(self._block_nbytes, default=0))

    def peak_window_start(self) -> None:
        """Reset the per-window peaks: a fit sharing a cached store reports
        its own watermark."""
        with self._lock:
            self._window_peak = self._resident_bytes
            self._host_window_peak = self._host_bytes_resident

    def peak_window_bytes(self) -> int:
        with self._lock:
            return self._window_peak

    def host_peak_window_bytes(self) -> int:
        with self._lock:
            return self._host_window_peak

    # -- disk tier ---------------------------------------------------------

    def _spill_dir_path(self) -> str:
        """The store's spill directory, made on first use, with its
        ``<owner>:spill`` ledger owner (bytes from the filesystem)."""
        if self._spill_dir is None:
            base = os.environ.get("H2O3_SPILL_DIR") or tempfile.gettempdir()
            safe = self.owner.replace(":", "_").replace("/", "_")
            d = os.path.join(base, f"h2o3_spill_{os.getpid()}_{safe}")
            os.makedirs(d, exist_ok=True)
            self._spill_dir = d
        if not self._spill_registered:
            self._spill_registered = True
            d = self._spill_dir

            def _disk():
                try:
                    with os.scandir(d) as it:
                        return (0, 0, sum(e.stat().st_size for e in it
                                          if e.is_file()))
                except OSError:
                    return (0, 0, 0)

            _ml.register(f"{self.owner}:spill", kind="block_store",
                         bytes_fn=_disk, referent=self, type_name="spill")
        return self._spill_dir

    def _spill_path(self, b: int) -> str:
        return os.path.join(self._spill_dir_path(), f"block{b}.bin")

    def _write_spill(self, b: int, hb: np.ndarray) -> None:
        """host→disk through the persist layer: ``.part``, fsync, atomic
        rename, so a crash mid-spill never leaves a torn file."""
        path = self._spill_path(b)
        part = path + ".part"
        t0 = time.perf_counter()
        fh = _persist.for_uri(path).open(part, "wb")
        try:
            fh.write(memoryview(np.ascontiguousarray(hb)).cast("B"))
            fh.flush()
            os.fsync(fh.fileno())
        finally:
            fh.close()
        os.replace(part, path)
        _phases.add("disk_stream", time.perf_counter() - t0, hb.nbytes)

    def _read_spill(self, b: int) -> np.ndarray:
        """disk→host through the persist layer's resuming reader."""
        path = self._spill_path(b)
        expected = self._block_nbytes[b]
        shape, dtype = self._block_meta[b]
        t0 = time.perf_counter()
        buf = bytearray()
        with _persist.for_uri(path).open_resuming(path) as src:
            while len(buf) < expected:
                chunk = src.read(min(1 << 20, expected - len(buf)))
                if not chunk:
                    break
                buf += chunk
        if len(buf) != expected:
            raise IOError(f"spill file {path} truncated: "
                          f"{len(buf)} of {expected} bytes")
        _phases.add("disk_stream", time.perf_counter() - t0, expected)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def _spill_one(self, keep, trigger: str) -> bool:
        """Spill the LRU host block not in `keep` (a block already on disk
        just drops its host copy); False when there is none. The file write
        runs outside the lock."""
        with self._lock:
            b = next((b for b in self._host_lru if b not in keep), None)
            if b is None:
                return False
            hb = self.host_blocks[b]
            on_disk = b in self._on_disk
        if hb is None:
            return True          # raced with another spiller
        if not on_disk:
            self._write_spill(b, hb)
        nbytes = self._block_nbytes[b]
        with self._lock:
            if self.host_blocks[b] is None:
                return True
            self.host_blocks[b] = None
            self._host_lru.pop(b, None)
            self._host_bytes_resident -= nbytes
            self._on_disk.add(b)
            self.counters["spilled"] += 1
            self.counters["bytes_spilled"] += nbytes
        reg = _registry()
        reg["spill_blocks"].inc(1, "spilled")
        reg["spill_bytes"].inc(nbytes, "spill")
        _account_spill_totals(spilled=nbytes)
        _ml.record_event("spill", f"{self.owner}:block{b}", nbytes,
                         trigger=trigger, space="disk", kind="block_store")
        return True

    def _enforce_host_budget(self, keep=(), trigger: str = "host_cap",
                             headroom: int = 0) -> None:
        """Spill LRU host blocks (except `keep`) until host-resident bytes
        plus `headroom` (bytes a restore is about to insert) fit."""
        budget = self.host_budget_bytes()
        if budget <= 0:
            return
        while True:
            with self._lock:
                if self._host_bytes_resident + headroom <= budget:
                    return
            if not self._spill_one(keep, trigger):
                return

    def shed_host(self, keep=(), trigger: str = "pressure") -> None:
        """Spill every host block except `keep`: the second stage of the
        pressure response, after `shed`. No-op without a disk tier."""
        if self._host_budget <= 0:
            return
        while self._spill_one(keep, trigger):
            pass

    def fetch_host(self, b: int) -> np.ndarray:
        """Host array of block `b`, restored from its spill file when the
        host copy was shed: the one host read path (uploads and GOSS's
        gathers), so restored bytes reach the device as they were packed.
        A restore makes room first, keeping `b` and `b + 1` (the disk
        double buffer), so the host watermark never passes the budget."""
        b = int(b)
        with self._lock:
            hb = self.host_blocks[b]
            if hb is not None:
                self._host_lru[b] = None
                self._host_lru.move_to_end(b)
                return hb
        nbytes = self._block_nbytes[b]
        with self._restore_lock:
            with self._lock:
                cur = self.host_blocks[b]
                if cur is not None:
                    return cur    # a concurrent restore won
            self._enforce_host_budget(keep={b, (b + 1) % self.n_blocks},
                                      headroom=nbytes)
            arr = self._read_spill(b)
            with self._lock:
                self.host_blocks[b] = arr
                self._host_lru[b] = None
                self._host_lru.move_to_end(b)
                self._host_bytes_resident += nbytes
                self.counters["restored"] += 1
                self.counters["bytes_restored"] += nbytes
                self.host_resident_peak_bytes = max(
                    self.host_resident_peak_bytes, self._host_bytes_resident)
                self._host_window_peak = max(self._host_window_peak,
                                             self._host_bytes_resident)
                host_peak = self._host_bytes_resident
        reg = _registry()
        reg["spill_blocks"].inc(1, "restored")
        reg["spill_bytes"].inc(nbytes, "restore")
        reg["spill_host_peak"].set(max(self.host_resident_peak_bytes,
                                       reg["spill_host_peak"].value()))
        _account_spill_totals(restored=nbytes, host_peak=host_peak)
        _ml.record_event("restore", f"{self.owner}:block{b}", nbytes,
                         trigger="stream", space="disk", kind="block_store")
        return arr

    # -- the device resident set -------------------------------------------

    def _evict_locked(self, b: int, trigger: str) -> None:
        if self._resident.pop(b, None) is None:
            return
        nbytes = self._block_nbytes[b]
        self._resident_bytes -= nbytes
        self.counters["evicted"] += 1
        _registry()["blocks"].inc(1, "evicted")
        _ml.record_event("evict", f"{self.owner}:block{b}", nbytes,
                         trigger=trigger, space="device", kind="block_store")

    def shed(self, keep=(), trigger: str = "pressure") -> int:
        """Drop device blocks (LRU first) except `keep`; the host copies
        remain, so a shed block costs only a later upload."""
        with self._lock:
            doomed = [b for b in self._resident if b not in keep]
            for b in doomed:
                self._evict_locked(b, trigger)
        return len(doomed)

    def _upload(self, b: int, side: bool):
        """(tensor, event) of block b on the device. On the card a copy on
        the side stream records an event the caller's stream waits on; a
        copy on the caller's stream needs none."""
        hb = self.fetch_host(b)
        src = torch.from_numpy(hb)
        if self._side is None:
            arr, ev = src, None
        elif side:
            with torch.cuda.stream(self._side):
                arr = src.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._side)
        else:
            arr, ev = src.to(self.device, non_blocking=True), None
        _phases.add("h2d_stream", 0.0, hb.nbytes)
        return arr, ev

    def _claim(self, b: int):
        """Block b's tensor for the caller's stream: wait for its copy and
        tell the allocator the stream uses it."""
        arr, ev = self._resident[b]
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            arr.record_stream(stream)
        return arr

    def get(self, b: int, side: bool = False):
        """Device tensor of block `b`: an LRU hit, or evict-then-upload.
        `side` (the prefetch path) copies on the side stream."""
        b = int(b)
        with self._lock:
            if b in self._resident:
                self._resident.move_to_end(b)
                self.counters["reused"] += 1
                _registry()["blocks"].inc(1, "reused")
                return self._claim(b) if not side else self._resident[b][0]
        # past the ledger's eviction threshold only the double buffer
        # stays resident: shed before growing the set
        if _ml.pressure() >= _ml.evict_threshold():
            self.shed(keep={b, (b + 1) % self.n_blocks}, trigger="pressure")
        nbytes = self._block_nbytes[b]
        with self._lock:
            budget = self.budget_bytes()
            while self._resident and self._resident_bytes + nbytes > budget:
                self._evict_locked(next(iter(self._resident)), "cap")
        entry = self._upload(b, side)
        with self._lock:
            self.counters["uploaded"] += 1
            self.counters["bytes_streamed"] += nbytes
            if b not in self._resident:
                self._resident[b] = entry
                self._resident_bytes += nbytes
                self.resident_peak_bytes = max(self.resident_peak_bytes,
                                               self._resident_bytes)
                self._window_peak = max(self._window_peak,
                                        self._resident_bytes)
            # else a concurrent miss won: the copy is counted, the entry
            # and its bytes stay singular
            self._resident.move_to_end(b)
            peak = self._resident_bytes
            arr = self._claim(b) if not side else self._resident[b][0]
        reg = _registry()
        reg["blocks"].inc(1, "uploaded")
        reg["bytes"].inc(nbytes)
        reg["resident_peak"].set(max(self.resident_peak_bytes,
                                     reg["resident_peak"].value()))
        _account_totals(nbytes, peak)
        return arr

    def _prefetch_pool(self):
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="h2o3-spill-prefetch")
            return self._pool

    def prefetch(self, b: int) -> None:
        """Start block `b`'s upload now, so it overlaps the caller's work
        on the block before it; `get(b)` then finds it resident. Once
        blocks live on disk the disk read and the copy move to one
        background thread, so the read overlaps the caller's compute too."""
        b = int(b)
        with self._lock:
            disk_active = bool(self._on_disk)
            if disk_active:
                if b in self._pending:
                    return
                self._pending.add(b)
        if not disk_active:
            self.get(b, side=True)
            return

        def _run():
            try:
                self.get(b, side=True)
            finally:
                with self._lock:
                    self._pending.discard(b)

        self._prefetch_pool().submit(_run)

    def account_external_bytes(self, nbytes: int) -> None:
        """Fold an upload made outside the store (GOSS's compact sample)
        into the stream byte counters."""
        with self._lock:
            self.counters["bytes_streamed"] += int(nbytes)
        _registry()["bytes"].inc(int(nbytes))
        _account_totals(int(nbytes))

    # -- stats / lifecycle -------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self.counters)
        out.update(n_blocks=self.n_blocks, block_rows=self.block_rows,
                   pack_bits=self.pack_bits,
                   host_bytes=self.host_bytes(),
                   resident_bytes=self.resident_bytes(),
                   disk_bytes=self.disk_bytes(),
                   resident_peak_bytes=self.resident_peak_bytes,
                   host_resident_peak_bytes=self.host_resident_peak_bytes,
                   budget_bytes=self.budget_bytes(),
                   host_budget_bytes=self.host_budget_bytes())
        return out

    def close(self) -> None:
        """Wait for the prefetch thread, drop the device blocks, remove
        the spill files and the spill directory, and retire the ledger
        owners."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        self.shed(trigger="clear")
        # remove the files before retiring the :spill owner: its bytes
        # come from the filesystem, and files left behind read as a leak
        with self._lock:
            on_disk = sorted(self._on_disk)
            self._on_disk.clear()
            sd = self._spill_dir
        freed = 0
        for b in on_disk:
            p = os.path.join(sd, f"block{b}.bin")
            if os.path.exists(p):
                freed += self._block_nbytes[b]
                os.remove(p)
        if sd and os.path.isdir(sd):
            os.rmdir(sd)
        if self._spill_registered:
            _ml.unregister(f"{self.owner}:spill",
                           event="free" if freed else None, nbytes=freed,
                           trigger="close", space="disk")
            self._spill_registered = False
        if self._registered:
            _ml.unregister(self.owner)
            self._registered = False

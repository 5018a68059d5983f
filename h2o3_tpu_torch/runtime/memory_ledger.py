"""Memory ledger — host + device byte accounting for the port's subsystems.

A copy of the parts of `h2o3_tpu/runtime/memory_ledger.py` that the
port's subsystems reach: owner registration (the DKV's `dkv:<key>` owners,
the scorer cache's `scorer:<model_key>:<kind>` owners, the dataset cache's
`dataset_cache:<fp>:<layer>` owners and the block store's
`block_store:<id>` owners with their `<owner>:spill` disk owners), the one
deep sizer `measure`, the refresh pass with its leak scan over the host,
device and disk spaces, watermarks and gauges, the `memory` lifecycle
events, and the `pressure()` signal that admission control and the
dataset cache shed on. The reference's job-leak check and ingest buffers
arrive with their modules (ROADMAP queue A, item 11).

Where the reference met the device, the port reads torch:

- `measure` counts a `torch.Tensor`'s bytes as device bytes when the tensor
  lies on a CUDA device and as host bytes when it lies on the CPU (no copy:
  the size comes from its shape and type);
- the device probe reads `torch.cuda.memory_allocated` (bytes the caching
  allocator holds for live tensors) and `torch.cuda.mem_get_info` (the
  card's capacity) for every device of an initialised CUDA context. It
  never initialises one: with no context there are no device buffers to
  probe. `device_capacity_bytes(device)` asks the card it is given, which
  the out-of-core stream budget is half of.

A byte callback returns (host, device) or (host, device, disk): the third
element is the bytes of files an owner keeps on disk (the block store's
spill files, counted from the filesystem, so a store dropped without
`close()` leaves a dead owner that still reports them: a leak).

Design — an *accountant*, not an allocator: owners register byte callbacks
and an optional weakref *referent* whose death marks the owner dead;
callbacks never strongly pin the accounted object. ``refresh()`` walks the
owners (rate-limited, callbacks run lock-free, one shared ``measure()``
dedup set per pass so a buffer reachable from two owners is attributed
once), reconciles attributed device bytes against what the allocator holds
(the rest is ``owner_kind="unaccounted"``), tracks watermarks and feeds the
``h2o3_memory_*`` registry families. A dead owner whose callbacks still
report bytes is a leak. The reference's `snapshot`/`peak` read surfaces
serve its REST layer (ROADMAP queue A, item 11); `peak` (the watermarks,
and the caching allocator's peak) is ported for the per-rank memory pins
of a multi-process fit, where each rank's ledger reads its own card.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import env_float, env_int

__all__ = ["register", "unregister", "unregister_prefix", "record_event",
           "measure", "refresh", "peak", "pressure", "owners", "clear",
           "evict_threshold", "device_capacity_bytes", "fingerprint"]

# how stale a cached refresh may be before a read recomputes (the
# admission-path pressure() rides this)
_REFRESH_S = env_float("H2O3_MEM_REFRESH_S", 0.5)
# pressure above this emits a threshold-crossing event (and below, a
# recovery event) — the observability signal, not an action threshold
_PRESS_THRESHOLD = env_float("H2O3_MEM_PRESSURE_THRESHOLD", 0.85)
# owners listed in a refresh result (the rest aggregate into by_kind)
_SNAPSHOT_OWNERS = env_int("H2O3_MEM_SNAPSHOT_OWNERS", 256)

_STR_SAMPLE = 256          # sampled string-column estimate
_MEASURE_DEPTH = 4         # object-graph walk bound
_LOCK_TYPE = type(threading.Lock())


class _Owner:
    __slots__ = ("owner", "kind", "type_name", "bytes_fn", "ref", "dead",
                 "leaked", "t_register", "last_host", "last_device",
                 "last_disk", "__weakref__")

    def __init__(self, owner: str, kind: str, type_name: str,
                 bytes_fn: Callable[[], Tuple[int, int]]):
        self.owner = owner
        self.kind = kind
        self.type_name = type_name
        self.bytes_fn = bytes_fn
        self.ref: Optional[weakref.ref] = None
        self.dead = False          # referent died (weakref callback fired)
        self.leaked = False        # leak event already emitted
        self.t_register = time.time()
        self.last_host = 0
        self.last_device = 0
        self.last_disk = 0


_REG_LOCK = threading.Lock()       # guards _OWNERS only
_OWNERS: Dict[str, _Owner] = {}

_REFRESH_LOCK = threading.Lock()   # one refresh pass at a time
_STATE_LOCK = threading.Lock()     # guards the cached-result REFERENCE
# the cached refresh result: REBOUND atomically, never mutated in place —
# readers got handed this dict lock-free
_STATE: Dict = dict(
    t=0.0, by_kind={}, totals=dict(host_bytes=0, device_bytes=0,
                                   disk_bytes=0, leaked_bytes=0,
                                   unaccounted_device_bytes=0,
                                   owner_count=0),
    owners=[], leaks=[], device={}, pressure={})
_HWM = dict(host=0, device=0, disk=0)
_PRESS_HIGH = [False]

_TLS = threading.local()           # .seen — per-refresh measure dedup set


# -- registry families ---------------------------------------------------------

_REG: Dict = {}


def _registry() -> Dict:
    """Memoized registry families + field bindings."""
    if not _REG:
        from . import metrics_registry as reg

        _REG["bytes"] = reg.gauge(
            "h2o3_memory_bytes",
            "ledger-attributed bytes per owner kind and memory space "
            "(owner_kind=unaccounted is the allocator's remainder)",
            labelnames=("owner_kind", "space"))
        _REG["hwm"] = reg.gauge(
            "h2o3_memory_high_watermark_bytes",
            "high watermark of ledger-attributed bytes per space",
            labelnames=("space",))
        _REG["leaked"] = reg.gauge(
            "h2o3_memory_leaked_bytes",
            "bytes held by dead owners (referent died, buffers persist)")
        _REG["owners"] = reg.gauge(
            "h2o3_memory_owners", "registered ledger owners")
        _REG["pressure"] = reg.gauge(
            "h2o3_memory_pressure",
            "memory pressure in [0,1]: max of host bytes vs "
            "H2O3_MEM_BUDGET_MB and device bytes vs device capacity")
        _REG["events"] = reg.counter(
            "h2o3_memory_events",
            "memory lifecycle events (alloc/evict/free/leak/leak_cleared/"
            "pressure_high/pressure_normal)",
            labelnames=("event", "owner_kind"))
        for f, m in (("host_bytes", "h2o3_memory_bytes"),
                     ("device_bytes", "h2o3_memory_bytes"),
                     ("disk_bytes", "h2o3_memory_bytes"),
                     ("unaccounted_device_bytes", "h2o3_memory_bytes"),
                     ("leaked_bytes", "h2o3_memory_leaked_bytes"),
                     ("owner_count", "h2o3_memory_owners")):
            reg.bind_rest_field("memory", f"totals.{f}", m)
    return _REG


# -- budgets / probes ----------------------------------------------------------

def _host_budget_bytes() -> int:
    mb = env_float("H2O3_MEM_BUDGET_MB", 0.0)
    if mb > 0:
        return int(mb * 1e6)
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 16 << 30


def evict_threshold() -> float:
    """Pressure above which byte caches (the dataset cache, the block
    store's device and host tiers) shed."""
    return env_float("H2O3_MEM_EVICT_PRESSURE", 0.9)


def device_capacity_bytes(device=None) -> int:
    """Device byte capacity as the ledger sees it: the card's total memory
    (`torch.cuda.mem_get_info`) for a CUDA `device`, else the probe's
    capacity, else ``H2O3_DEVICE_BUDGET_MB`` or the host budget (a CPU
    fit's "device" is host memory). The out-of-core stream budget derives
    from this one number."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    cap = int(_probe_device().get("capacity_bytes", 0))
    if cap:
        return cap
    mb = env_float("H2O3_DEVICE_BUDGET_MB", 0.0)
    return int(mb * 1e6) if mb > 0 else _host_budget_bytes()


def fingerprint(key) -> str:
    """Short stable digest for owner ids built from unhashable-ish keys."""
    return "%08x" % (zlib.crc32(repr(key).encode()) & 0xFFFFFFFF)


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            return 0


def _cards() -> List[int]:
    """The cards this process probes: a rank of a multi-process cloud reads
    its own card only (probing another would open a context there), a
    lone process every visible card."""
    from .. import device as devlib

    card = devlib.rank_device()
    if card is not None and card.index is not None:
        return [card.index]
    return list(range(torch.cuda.device_count()))


def _probe_device() -> Dict:
    """What the CUDA caching allocator holds for live tensors on each
    probed card (`_cards`), against its capacity. Never initialises CUDA:
    without a context there are no device buffers to probe."""
    if not torch.cuda.is_initialized():
        return dict(probe="unavailable", in_use_bytes=0, capacity_bytes=0,
                    devices=[])
    devices = []
    for i in _cards():
        used = int(torch.cuda.memory_allocated(i))
        cap = int(torch.cuda.mem_get_info(i)[1])
        devices.append(dict(id=str(i), platform="cuda", bytes_in_use=used,
                            bytes_limit=cap))
    return dict(probe="memory_stats",
                in_use_bytes=sum(d["bytes_in_use"] for d in devices),
                capacity_bytes=sum(d["bytes_limit"] for d in devices),
                devices=devices)


# -- the one deep sizer --------------------------------------------------------

def measure(value) -> Tuple[int, int]:
    """(host_bytes, device_bytes) of one object graph — the ONE sizing rule
    the DKV and the scorer cache share. numpy buffers are host; a
    `torch.Tensor` is device bytes on a CUDA device and host bytes on the
    CPU (sized from its shape, never copied); string columns use a sampled
    estimate; nested Frames/Vecs/BinnedMatrix/model ``__dict__`` graphs are
    walked to a bounded depth with a cycle/shared-buffer guard. Inside a
    ledger refresh pass the guard set is shared across owners, so a buffer
    reachable from two owners is attributed to the first."""
    seen = getattr(_TLS, "seen", None)
    if seen is None:
        seen = set()
    acc = [0, 0]
    _measure_into(value, acc, seen, 0)
    return acc[0], acc[1]


def _measure_into(x, acc, seen, depth) -> None:
    if x is None or isinstance(x, (bool, int, float, complex)):
        return
    if isinstance(x, (str, bytes, bytearray)):
        acc[0] += len(x)
        return
    i = id(x)
    if i in seen:
        return
    seen.add(i)
    import numpy as np

    if isinstance(x, np.ndarray):
        if x.dtype == object:
            # sampled estimate — a per-element loop would make a refresh
            # O(total string cells)
            import itertools

            flat = x.ravel()
            sample = list(itertools.islice(
                (s for s in flat if s is not None), _STR_SAMPLE))
            avg = (sum(len(str(s)) for s in sample) / len(sample)
                   if sample else 0.0)
            acc[0] += int(avg * flat.size)
        else:
            acc[0] += int(x.nbytes)
        return
    if isinstance(x, torch.Tensor):
        nbytes = x.numel() * x.element_size()
        acc[1 if x.device.type == "cuda" else 0] += int(nbytes)
        return
    if depth >= _MEASURE_DEPTH:
        return
    if isinstance(x, dict):
        for v in x.values():
            _measure_into(v, acc, seen, depth + 1)
        return
    if isinstance(x, (list, tuple, set, frozenset)):
        for v in x:
            _measure_into(v, acc, seen, depth + 1)
        return
    if isinstance(x, (type, threading.Thread, _LOCK_TYPE,
                      weakref.ref, torch.device)) or callable(x):
        return
    vecs = getattr(x, "_vecs", None)
    if isinstance(vecs, dict):                 # Frame
        for v in vecs.values():
            _measure_into(v, acc, seen, depth + 1)
        return
    d = getattr(x, "__dict__", None)
    if isinstance(d, dict):                    # models, BinnedMatrix, ...
        for v in d.values():
            _measure_into(v, acc, seen, depth + 1)
        return
    slots = getattr(type(x), "__slots__", None)
    if slots:                                  # Vec and friends
        for s in slots:
            if s == "__weakref__":
                continue
            try:
                _measure_into(getattr(x, s, None), acc, seen, depth + 1)
            except Exception:
                pass


# -- owner lifecycle -----------------------------------------------------------

def register(owner: str, kind: str, *,
             bytes_fn: Callable[[], Tuple[int, int]],
             referent=None, type_name: str = "") -> str:
    """Register (or replace) a byte owner. `bytes_fn` returns (host,
    device) or (host, device, disk). `referent` is the object whose death marks the owner dead
    (weakref-backed — never pinned); callbacks must not strongly hold the
    referent either, or the ledger itself becomes the leak it exists to
    find."""
    o = _Owner(owner, kind, type_name, bytes_fn)
    if referent is not None:
        try:
            o.ref = weakref.ref(referent, lambda _r, _o=weakref.ref(o):
                                _mark_dead(_o))
        except TypeError:
            o.ref = None
    with _REG_LOCK:
        _OWNERS[owner] = o
    _registry()
    return owner


def _mark_dead(owner_ref) -> None:
    o = owner_ref()
    if o is None:
        return
    with _REG_LOCK:
        if _OWNERS.get(o.owner) is o:
            o.dead = True


def unregister(owner: str, *, event: Optional[str] = None,
               nbytes: Optional[int] = None, trigger: str = "",
               space: str = "host") -> bool:
    """Remove an owner; optionally emit a lifecycle event sized by
    `nbytes` (default: the owner's last-refreshed bytes)."""
    with _REG_LOCK:
        o = _OWNERS.pop(owner, None)
    if o is None:
        return False
    if event:
        if nbytes is None:
            nbytes = o.last_host + o.last_device + o.last_disk
        record_event(event, owner, nbytes, trigger=trigger, space=space,
                     kind=o.kind)
    return True


def unregister_prefix(prefix: str) -> int:
    with _REG_LOCK:
        doomed = [k for k in _OWNERS if k.startswith(prefix)]
        for k in doomed:
            _OWNERS.pop(k, None)
    return len(doomed)


def owners(prefix: str = "") -> List[Dict]:
    """Registered owners (id, kind, last-refreshed bytes, dead flag)."""
    with _REG_LOCK:
        items = [o for k, o in _OWNERS.items() if k.startswith(prefix)]
    return [dict(owner=o.owner, kind=o.kind, type=o.type_name,
                 host_bytes=o.last_host, device_bytes=o.last_device,
                 disk_bytes=o.last_disk, dead=o.dead) for o in items]


def record_event(event: str, owner: str, nbytes: int = 0, *,
                 trigger: str = "", space: str = "host",
                 kind: Optional[str] = None) -> None:
    """One memory lifecycle event → registry counter + Timeline ring +
    an annotation on the open tracing span."""
    if kind is None:
        kind = owner.split(":", 1)[0]
    _registry()["events"].inc(1, event, kind)
    from . import tracing
    from .timeline import Timeline

    Timeline.record("memory", f"{event} {owner}", owner=owner,
                    bytes=int(nbytes), trigger=trigger, space=space)
    tracing.event(f"memory_{event}", owner=owner, bytes=int(nbytes),
                  trigger=trigger)


# -- refresh: the accounting pass ----------------------------------------------

def refresh(force: bool = False) -> Dict:
    """Recompute the ledger: per-owner bytes (one shared measure() dedup
    set), leak scan, device reconciliation, watermarks, pressure, gauges.
    Rate-limited (`H2O3_MEM_REFRESH_S`) unless `force`; concurrent callers
    get the cached result instead of a second pass. Callbacks run without
    any ledger lock held, so a callback may take its subsystem's lock."""
    now = time.time()
    with _STATE_LOCK:
        if not force and now - _STATE["t"] < _REFRESH_S:
            return _STATE
    if not _REFRESH_LOCK.acquire(blocking=False):
        with _STATE_LOCK:
            return _STATE
    try:
        return _refresh_locked(now)
    finally:
        _REFRESH_LOCK.release()


def _refresh_locked(now: float) -> Dict:
    reg = _registry()
    with _REG_LOCK:
        owner_objs = list(_OWNERS.values())
    _TLS.seen = set()
    try:
        by_kind: Dict[str, List[int]] = {}
        rows: List[Dict] = []
        leaks: List[Dict] = []
        retire: List[_Owner] = []
        host_total = dev_total = disk_total = leaked = 0
        for o in owner_objs:
            try:
                vals = o.bytes_fn()
                h, d = int(vals[0]), int(vals[1])
                k = int(vals[2]) if len(vals) > 2 else 0
            except Exception:
                h = d = k = 0
            o.last_host, o.last_device, o.last_disk = h, d, k
            if o.dead:
                if h + d + k <= 0:
                    if o.leaked:
                        record_event("leak_cleared", o.owner, 0,
                                     kind=o.kind)
                    retire.append(o)
                    continue
                leaked += h + d + k
                leaks.append(dict(owner=o.owner, kind=o.kind,
                                  bytes=h + d + k, reason="referent_dead"))
                if not o.leaked:
                    o.leaked = True
                    record_event("leak", o.owner, h + d + k,
                                 trigger="referent_dead", kind=o.kind,
                                 space="disk" if (k and not d and not h)
                                 else ("device" if d else "host"))
            host_total += h
            dev_total += d
            disk_total += k
            agg = by_kind.setdefault(o.kind, [0, 0, 0, 0])
            agg[0] += h
            agg[1] += d
            agg[2] += k
            agg[3] += 1
            rows.append(dict(owner=o.owner, kind=o.kind, host_bytes=h,
                             device_bytes=d, disk_bytes=k, dead=o.dead))
    finally:
        _TLS.seen = None
    with _REG_LOCK:
        for o in retire:
            if _OWNERS.get(o.owner) is o:
                _OWNERS.pop(o.owner, None)
        n_owners = len(_OWNERS)

    device = _probe_device()
    unaccounted = max(int(device.get("in_use_bytes", 0)) - dev_total, 0) \
        if device.get("probe") != "unavailable" else 0

    # pressure: host bytes vs budget, device bytes vs capacity
    host_budget = _host_budget_bytes()
    rss = _rss_bytes()
    host_press = max(rss, host_total) / max(host_budget, 1)
    dev_cap = int(device.get("capacity_bytes", 0))
    dev_used = max(int(device.get("in_use_bytes", 0)), dev_total)
    dev_press = dev_used / dev_cap if dev_cap > 0 else 0.0
    press = min(max(host_press, dev_press, 0.0), 1.0)
    if press >= _PRESS_THRESHOLD and not _PRESS_HIGH[0]:
        _PRESS_HIGH[0] = True
        record_event("pressure_high", "ledger", 0,
                     trigger=f"{press:.3f}", kind="ledger")
    elif press < _PRESS_THRESHOLD and _PRESS_HIGH[0]:
        _PRESS_HIGH[0] = False
        record_event("pressure_normal", "ledger", 0,
                     trigger=f"{press:.3f}", kind="ledger")

    # watermarks
    _HWM["host"] = max(_HWM["host"], host_total)
    _HWM["device"] = max(_HWM["device"], dev_total)
    _HWM["disk"] = max(_HWM["disk"], disk_total)

    # gauges (zero kinds that vanished so stale series don't lie)
    seen_labels = set()
    for kind, (h, d, k, _n) in by_kind.items():
        reg["bytes"].set(h, kind, "host")
        reg["bytes"].set(d, kind, "device")
        seen_labels.add((kind, "host"))
        seen_labels.add((kind, "device"))
        if k:
            reg["bytes"].set(k, kind, "disk")
            seen_labels.add((kind, "disk"))
    reg["bytes"].set(unaccounted, "unaccounted", "device")
    seen_labels.add(("unaccounted", "device"))
    for lv in reg["bytes"].children():
        if lv not in seen_labels and lv != ("_overflow", "_overflow"):
            reg["bytes"].set(0, *lv)
    reg["hwm"].set(_HWM["host"], "host")
    reg["hwm"].set(_HWM["device"], "device")
    reg["hwm"].set(_HWM["disk"], "disk")
    reg["leaked"].set(leaked)
    reg["owners"].set(n_owners)
    reg["pressure"].set(round(press, 4))

    rows.sort(key=lambda r: -(r["host_bytes"] + r["device_bytes"]
                              + r["disk_bytes"]))
    state = dict(
        t=now,
        totals=dict(host_bytes=host_total, device_bytes=dev_total,
                    disk_bytes=disk_total, leaked_bytes=leaked,
                    unaccounted_device_bytes=unaccounted,
                    owner_count=n_owners),
        by_kind={k: dict(host_bytes=v[0], device_bytes=v[1],
                         disk_bytes=v[2], owners=v[3])
                 for k, v in sorted(by_kind.items())},
        owners=rows[:_SNAPSHOT_OWNERS],
        leaks=leaks,
        device=device,
        pressure=dict(value=round(press, 4),
                      host=round(min(host_press, 1.0), 4),
                      device=round(min(dev_press, 1.0), 4),
                      threshold=_PRESS_THRESHOLD,
                      host_budget_bytes=host_budget,
                      device_capacity_bytes=dev_cap,
                      rss_bytes=rss),
    )
    global _STATE
    with _STATE_LOCK:
        _STATE = state
    return state


# -- read side -----------------------------------------------------------------

def peak() -> Dict:
    """High watermarks of the ledger-attributed bytes per space (host,
    device, disk) after a forced refresh, and the caching allocator's peak
    over the probed cards (`allocator_peak_bytes`, 0 without a CUDA
    context): on a rank, its own card's. The per-rank peaks a pod fit is
    held to."""
    refresh(force=True)
    alloc = (sum(int(torch.cuda.max_memory_allocated(i)) for i in _cards())
             if torch.cuda.is_initialized() else 0)
    return dict(host_bytes=_HWM["host"], device_bytes=_HWM["device"],
                disk_bytes=_HWM["disk"], allocator_peak_bytes=alloc)


def pressure() -> float:
    """The [0,1] pressure signal admission control consults — a cached
    read between refresh intervals."""
    return float(refresh()["pressure"].get("value", 0.0))


def clear() -> None:
    """Forget every owner and watermark (tests)."""
    global _STATE
    with _REG_LOCK:
        _OWNERS.clear()
    with _STATE_LOCK:
        _STATE = dict(_STATE, t=0.0)   # rebind: readers hold the old dict
    _HWM.update(host=0, device=0, disk=0)
    _PRESS_HIGH[0] = False

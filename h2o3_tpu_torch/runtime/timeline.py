"""Timeline — bounded event ring for debugging.

A copy of the ring of `h2o3_tpu/runtime/timeline.py` (reference parity:
`h2o-core/src/main/java/water/TimeLine.java`): the memory ledger records
its lifecycle events (alloc, evict, free, leak, pressure) here. One ring per
process, bounded (``H2O3_TIMELINE_EVENTS``, default 4096); every event
carries a monotone ``seq``. The reference's incremental tailing serves its
REST surface (ROADMAP queue A, item 11).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import env_int


class Timeline:
    _ring: deque = deque(maxlen=max(env_int("H2O3_TIMELINE_EVENTS", 4096),
                                    16))
    _lock = threading.Lock()
    _seq = 0

    @classmethod
    def record(cls, kind: str, detail: str = "", **extra):
        ev = dict(ts=time.time(), kind=kind, detail=detail)
        if extra:
            ev.update(extra)
        with cls._lock:
            cls._seq += 1
            ev["seq"] = cls._seq
            cls._ring.append(ev)

    @classmethod
    def snapshot(cls, n: int = 1000,
                 since: Optional[int] = None) -> List[Dict]:
        """Latest `n` events; with `since`, only events with seq > since
        (incremental tailing — each event's own ``seq`` is the cursor)."""
        with cls._lock:
            evs = list(cls._ring)
        if since is not None:
            evs = [e for e in evs if e["seq"] > since]
        return evs[-n:]

    @classmethod
    def clear(cls):
        with cls._lock:
            cls._ring.clear()

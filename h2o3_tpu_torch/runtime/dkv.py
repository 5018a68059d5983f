"""DKV — the keyed object store behind frames and models.

A copy of `h2o3_tpu/runtime/dkv.py`, rewired to the port's models.
Reference parity: `h2o-core/src/main/java/water/DKV.java`. One controller
process holds the store: a plain dict with a lock, not a distributed hash.
The key namespace and lifecycle (`put/get/remove`) match; every entry is a
memory-ledger owner (`dkv:<key>`), so the serving cache's ledger owner can
tell whether the DKV already accounts a model it wraps.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional


def _owner_kind(value) -> str:
    """Ledger owner kind for a DKV value — frames and models are first-
    class in the ledger's breakdown; everything else aggregates under
    `dkv`."""
    if getattr(value, "_vecs", None) is not None:
        return "frame"
    from ..models.model_base import H2OModel

    if isinstance(value, H2OModel):
        return "model"
    from ..mojo import MojoScorer

    if isinstance(value, MojoScorer):
        return "model"
    return "dkv"


class DKV:
    _store: Dict[str, object] = {}
    _lock = threading.Lock()

    @classmethod
    def put(cls, key: str, value) -> None:
        with cls._lock:
            cls._store[key] = value
        # ledger registration OUTSIDE the store lock: the ledger's refresh
        # pass calls byte callbacks that may take cls._lock (scorer-cache
        # owners call DKV.get), so put must never hold it while entering
        # the ledger
        from . import memory_ledger as ml

        try:
            wr = weakref.ref(value)
        except TypeError:
            wr = None

        def _bytes(_wr=wr, _v=(value if wr is None else None)):
            v = _wr() if _wr is not None else _v
            return ml.measure(v) if v is not None else (0, 0)

        ml.register(f"dkv:{key}", kind=_owner_kind(value), bytes_fn=_bytes,
                    referent=(value if wr is not None else None),
                    type_name=type(value).__name__)

    @classmethod
    def get(cls, key: str):
        with cls._lock:
            return cls._store.get(key)

    @classmethod
    def remove(cls, key: str) -> None:
        with cls._lock:
            existed = cls._store.pop(key, None) is not None
        if existed:
            from . import memory_ledger as ml

            ml.unregister(f"dkv:{key}", event="free", trigger="remove")

    @classmethod
    def keys(cls, kind: Optional[type] = None) -> List[str]:
        with cls._lock:
            if kind is None:
                return list(cls._store)
            return [k for k, v in cls._store.items() if isinstance(v, kind)]

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._store.clear()
        from . import memory_ledger as ml

        ml.unregister_prefix("dkv:")

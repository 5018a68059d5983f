"""Request/job tracing — the span engine of the observability spine.

A copy of the span engine of `h2o3_tpu/runtime/tracing.py`, as far as the
serving path reaches it: a serving batch opens a span (`batcher._score`)
that adopts the trace of the request that submitted it, and fired fault
injections and memory events annotate the open span as zero-duration
events. Spans parent through a THREAD-LOCAL stack; crossing a thread
boundary is explicit (the batcher's `_Pending` carries the submitting
thread's ids). Finished spans land in one bounded ring
(``H2O3_TRACE_SPANS``, default 4096), and
``h2o3_trace_spans_total{kind}`` counts them in the metrics registry. The
reference's Chrome-trace export, summaries and retroactive spans serve its
REST surface (ROADMAP queue A, item 11).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from . import env_int

__all__ = ["Span", "span", "current", "new_trace_id", "event", "spans",
           "clear"]

_MAX_SPANS = env_int("H2O3_TRACE_SPANS", 4096)
_MAX_EVENTS_PER_SPAN = 64

_LOCK = threading.Lock()
_SPANS: deque = deque(maxlen=_MAX_SPANS)
_TLS = threading.local()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return uuid.uuid4().hex[:8]


class Span:
    """One timed operation. Mutable while open; immutable once recorded."""

    __slots__ = ("name", "kind", "trace_id", "span_id", "parent_id",
                 "t_wall", "t0", "duration_s", "attrs", "events", "thread")

    def __init__(self, name: str, kind: str = "span",
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 attrs: Optional[Dict] = None):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id or new_trace_id()
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.t_wall = time.time()
        self.t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.attrs: Dict = dict(attrs or {})
        self.events: List[Dict] = []
        self.thread = threading.current_thread().name

    def add_event(self, name: str, **attrs) -> None:
        if len(self.events) < _MAX_EVENTS_PER_SPAN:
            ev = dict(name=name, ts=time.time())
            if attrs:
                ev.update(attrs)
            self.events.append(ev)

    def to_dict(self) -> Dict:
        return dict(name=self.name, kind=self.kind, trace_id=self.trace_id,
                    span_id=self.span_id, parent_id=self.parent_id,
                    ts=self.t_wall,
                    duration_s=(round(self.duration_s, 6)
                                if self.duration_s is not None else None),
                    thread=self.thread, attrs=dict(self.attrs),
                    events=list(self.events))


def _stack() -> List[Span]:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def current() -> Optional[Span]:
    """The innermost open span on this thread, or None."""
    s = getattr(_TLS, "stack", None)
    return s[-1] if s else None


_SPAN_COUNTER = None


def _record(sp: Span) -> None:
    global _SPAN_COUNTER
    with _LOCK:
        _SPANS.append(sp)
    # registry fold; the family is memoized so ending a span never takes
    # the registry's registration lock (deferred first resolve: tracing
    # must stay importable before metrics_registry)
    c = _SPAN_COUNTER
    if c is None:
        from . import metrics_registry as _reg

        c = _SPAN_COUNTER = _reg.counter(
            "h2o3_trace_spans", "completed trace spans",
            labelnames=("kind",))
    c.inc(1, sp.kind)


@contextmanager
def span(name: str, kind: str = "span", trace_id: Optional[str] = None,
         parent_id: Optional[str] = None, **attrs):
    """Open a span as a child of this thread's current span (or of the
    explicit trace_id/parent_id for cross-thread hops); record it on exit.
    Exceptions mark the span ``error`` and propagate."""
    cur = current()
    if trace_id is None and cur is not None:
        trace_id = cur.trace_id
        if parent_id is None:
            parent_id = cur.span_id
    sp = Span(name, kind=kind, trace_id=trace_id, parent_id=parent_id,
              attrs=attrs)
    st = _stack()
    st.append(sp)
    try:
        yield sp
    except BaseException as e:
        sp.attrs["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        st.pop()
        sp.duration_s = time.perf_counter() - sp.t0
        _record(sp)


def event(name: str, **attrs) -> None:
    """Annotate the current span with a zero-duration event (retry
    attempts, fired fault injections). Silently dropped when no span is
    open — hardening paths run identically traced or not."""
    sp = current()
    if sp is not None:
        sp.add_event(name, **attrs)


# -- read side ----------------------------------------------------------------

def _snapshot_spans() -> List[Span]:
    with _LOCK:
        return list(_SPANS)


def spans(trace_id: Optional[str] = None, n: Optional[int] = None
          ) -> List[Dict]:
    """Recorded spans (oldest first), optionally filtered to one trace."""
    out = [s for s in _snapshot_spans()
           if trace_id is None or s.trace_id == trace_id]
    if n is not None:
        out = out[-n:]
    return [s.to_dict() for s in out]


def clear() -> None:
    """Drop recorded spans (tests). Open spans on live threads are
    unaffected — they record on exit as usual."""
    with _LOCK:
        _SPANS.clear()

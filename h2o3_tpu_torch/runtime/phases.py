"""Per-candidate phase accounting.

A copy of the part of `h2o3_tpu/runtime/phases.py` that the train pool
reads: the thread-local sink a pool worker installs around one
candidate's fit (`candidate_sink`), into which every `add` made from that
thread books seconds by phase. The port's fits book the phases the
reference's fit loops book: ``host_prep`` (frame to matrix, binning, the
design's host pack), ``h2d`` (uploads and the design's expansion on the
device), ``compute`` (the tree, step or solver loop) and ``metrics``
(scoring events on the host, training and validation metrics):
`book_fit` folds a fit's `fit_timings` into them. Outside a sink `add`
books no candidate seconds.

Every `add` also lands in the process-wide totals that `snapshot` reads:
seconds and bytes per phase. The out-of-core tree path books its
transfers there: ``h2d_stream`` (packed code blocks uploaded by the block
store, bytes; an upload on the card is asynchronous, so it books 0 s and
its time shows in the streamed step's wall) and ``disk_stream`` (the
disk tier's spill writes and restores, host-clock seconds and bytes).

The reference's `timed` context, its XLA compile/retrace tracker and its
jax monitoring listener have no reader in the port yet: they wait for the
profiler work of ROADMAP queue A, item 9.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

# per-candidate attribution: a training worker (runtime/trainpool.py)
# installs a thread-local sink around one candidate's fit, and every add()
# from that thread lands in it, so the pool can report each candidate's
# split even when several candidates train at once
_TLS = threading.local()
_LOCK = threading.Lock()
_TOTALS: dict = {}          # phase -> [seconds, bytes]


@contextmanager
def candidate_sink():
    """Install a thread-local phase sink; yields {phase: seconds}."""
    d: dict = {}
    prev = getattr(_TLS, "sink", None)
    _TLS.sink = d
    try:
        yield d
    finally:
        _TLS.sink = prev


def add(phase: str, secs: float, nbytes: int = 0) -> None:
    sink = getattr(_TLS, "sink", None)
    if sink is not None:   # thread-local — no lock needed
        sink[phase] = sink.get(phase, 0.0) + secs
    with _LOCK:
        t = _TOTALS.setdefault(phase, [0.0, 0])
        t[0] += secs
        t[1] += int(nbytes)


def snapshot() -> dict:
    """Process-wide totals: ``<phase>`` seconds and ``bytes_<phase>``."""
    with _LOCK:
        out = {k: v[0] for k, v in _TOTALS.items()}
        out.update({f"bytes_{k}": v[1] for k, v in _TOTALS.items() if v[1]})
    return out


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()


# a fit's `fit_timings` keys (the host-clock splits the port's fit loops
# keep) → the phase each books to
_FIT_PHASE = dict(
    bins_s="host_prep", pack_s="host_prep", tables_s="host_prep",
    basis_s="host_prep", design_s="host_prep", host_loop_s="host_prep",
    vocab_pairs_s="host_prep", draws_s="host_prep",
    upload_s="h2d", h2d_s="h2d", expand_s="h2d", yw_h2d_s="h2d",
    trees_s="compute", score_s="compute", init_s="compute",
    steps_s="compute", irls_s="compute", lbfgs_s="compute",
    rounds_s="compute", pvalues_s="compute", moments_s="compute",
    pav_s="compute", levels_s="compute", block_s="compute",
    scoring_s="metrics", metrics_s="metrics")


def book_fit(timings) -> None:
    """Book one fit's `fit_timings` split to the phases (model_base.train
    and its CV folds call this after every `_fit`)."""
    for k, secs in (timings or {}).items():
        phase = _FIT_PHASE.get(k)
        if phase is not None:
            add(phase, float(secs))

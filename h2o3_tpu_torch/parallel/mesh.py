"""Cloud management — the port of `h2o3_tpu/parallel/mesh.py`.

Reference parity: `h2o-core/src/main/java/water/H2O.java` (node bootstrap),
`water/Paxos.java` + `water/HeartBeatThread.java` (cloud membership). A
cloud here is a `torch.distributed` process group with one device a rank:
`init(coordinator_address, num_processes, process_id)` plays the role of
Paxos (one process per rank ≡ one H2O node) and membership is fixed at
init, H2O's "cloud locks at first job" semantics. A process that never
calls `init` with a coordinator runs a one-rank cloud and no group.

The backend of the group:

- gloo on the CPU, and where ranks share a card (NCCL refuses two ranks
  on one device);
- NCCL where every rank of the host owns a distinct card.

The host transports of `distdata` always run on a gloo group of their own
(`Cloud.host_group`), whatever the device backend is.

A rank's card is its local rank (``LOCAL_RANK``, else its rank) modulo
`torch.cuda.device_count()`; `init` selects it before any other CUDA call,
and `device.resolve` returns it from then on.

The row axis is named ``"hosts"`` (`ROWS_AXIS`), as in the reference: rows
of a frame are spread over it, and every deterministic row reduction
gathers its block partials over it in rank order and folds them
(`gather_blocks`, `ops.histogram.ordered_axis_fold`). The reference's
`shard_call` has no counterpart: a rank runs the body on its own rows.
The lane-timing registry and the `mesh.rank_kill` fault point come with
the supervisor (ROADMAP queue A, item 9).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .. import device as devlib

ROWS_AXIS = "hosts"  # the one inter-node axis H2O has: row/data parallelism

_lock = threading.Lock()
_cloud: Optional["Cloud"] = None
# the (coordinator_address, num_processes, process_id) the process group
# was formed with: a repeat init() with the same topology answers with the
# live cloud, a conflicting one raises instead of re-forming mid-run
_dist_topology: Optional[tuple] = None
_groups: dict = {}

# bytes and seconds of the block gathers (`gather_blocks`): the histogram
# merge of every level, the leaf totals and the scoring-event sums
GATHER_STATS = dict(calls=0, bytes=0, seconds=0.0)


@dataclass
class Cloud:
    """A locked set of ranks, one device each. Mirrors `water.H2O.CLOUD`:
    `size` ≡ `H2O.CLOUD.size()`, `self_idx` ≡ `H2O.SELF.index()`."""

    size: int = 1
    self_idx: int = 0
    backend: str = "none"            # "gloo" | "nccl" | "none" (one rank)
    device: Optional[torch.device] = None   # this rank's card, if any
    name: str = "h2o-tpu"
    host_group: object = field(default=None, repr=False)

    @property
    def devices(self):
        return [self.device] if self.device is not None else []


def _local_rank(process_id: int) -> int:
    v = os.environ.get("LOCAL_RANK", "")
    return int(v) if v != "" else int(process_id)


def _local_world(num_processes: int) -> int:
    v = os.environ.get("LOCAL_WORLD_SIZE", "")
    return int(v) if v != "" else int(num_processes)


def _init_method(coordinator_address: str) -> str:
    """``host:port`` → ``tcp://host:port``; a URL (``tcp://…``,
    ``file://…``) passes as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _rank_device(num_processes: int, process_id: int):
    """(this rank's card or None, the group backend). The card is chosen
    before any other CUDA call; no card, or the CPU asked for with
    `device.set_device`, gives gloo and no card."""
    wants_cpu = devlib.default_device() is not None \
        and devlib.default_device().type == "cpu"
    if wants_cpu or not torch.cuda.is_available():
        return None, "gloo"
    ncard = torch.cuda.device_count()
    idx = _local_rank(process_id) % ncard
    torch.cuda.set_device(idx)
    backend = "nccl" if _local_world(num_processes) <= ncard else "gloo"
    return torch.device("cuda", idx), backend


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         name: str = "h2o-tpu", timeout_s: float = 600.0) -> Cloud:
    """Form the cloud. With a coordinator and more than one process: join
    the process group (`init_process_group` with an explicit `timeout_s`,
    replacing `water/init/NetworkInit.java`). Without: adopt a process
    group the caller already formed, else a one-rank cloud.

    Re-init is IDEMPOTENT for the same topology (the live cloud comes
    back) and a CONFLICTING topology raises naming both, as the
    reference's `init` does."""
    import torch.distributed as dist

    global _cloud, _dist_topology
    with _lock:
        if coordinator_address is not None and num_processes \
                and int(num_processes) > 1:
            if process_id is None:
                raise ValueError("a multi-process cloud needs process_id")
            topo = (coordinator_address, int(num_processes), int(process_id))
            if _dist_topology is not None:
                if topo != _dist_topology:
                    raise RuntimeError(
                        "cloud already initialized with coordinator "
                        f"topology {_dist_topology}; re-init with {topo} "
                        "conflicts — shut the process down to re-cloud "
                        "(membership is fixed at init, water/Paxos.java "
                        "'cloud locks' semantics)")
                if _cloud is not None:
                    return _cloud
            else:
                card, backend = _rank_device(int(num_processes),
                                             int(process_id))
                timeout = datetime.timedelta(seconds=float(timeout_s))
                dist.init_process_group(
                    backend, init_method=_init_method(coordinator_address),
                    world_size=int(num_processes), rank=int(process_id),
                    timeout=timeout)
                # the host transports' own gloo group (collective: every
                # rank forms it here, in the same order)
                _groups["host"] = dist.new_group(backend="gloo",
                                                 timeout=timeout)
                _groups["backend"] = backend
                _groups["card"] = card
                devlib.set_rank_device(card)
                _dist_topology = topo
        if dist.is_available() and dist.is_initialized():
            if "host" not in _groups:
                # a group the caller formed: adopt it (a launcher that
                # exports RANK/WORLD_SIZE and called init_process_group)
                _groups["backend"] = dist.get_backend()
                _groups["host"] = (None if _groups["backend"] == "gloo"
                                   else dist.new_group(backend="gloo"))
                _groups["card"] = (torch.device("cuda",
                                                torch.cuda.current_device())
                                   if _groups["backend"] == "nccl" else None)
                devlib.set_rank_device(_groups["card"])
            _cloud = Cloud(size=dist.get_world_size(), self_idx=dist.get_rank(),
                           backend=str(_groups["backend"]),
                           device=_groups["card"], name=name,
                           host_group=_groups["host"])
        else:
            _cloud = Cloud(name=name)
        return _cloud


def cloud() -> Cloud:
    """The current cloud, forming a local one lazily (like `H2O.main`
    being auto-started by the Python client)."""
    if _cloud is None:
        init()
    return _cloud


def reset() -> None:
    """Forget the cloud object; the process group (if any) stays up, so a
    repeat `init` with the same topology rebuilds the same cloud."""
    global _cloud
    with _lock:
        _cloud = None


def shutdown() -> None:
    """Leave the process group (the launcher calls this after its
    script): the group's sockets close with it."""
    import torch.distributed as dist

    global _cloud, _dist_topology
    with _lock:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        _groups.clear()
        _cloud = None
        _dist_topology = None
        devlib.set_rank_device(None)


def gather_blocks(parts: torch.Tensor) -> torch.Tensor:
    """(size·b, ...) stack of every rank's (b, ...) block partials in rank
    order — the global block order of the canonical row layout. Under
    NCCL a card tensor gathers on the device (`all_gather_into_tensor`);
    otherwise it stages through host tensors on the gloo group (gloo's
    CUDA support does not cover an all-gather). Bytes are copied, never
    summed: the caller's left fold then gives the one-device bits."""
    import torch.distributed as dist

    c = cloud()
    if c.size == 1:
        return parts
    collective_fence(parts)
    t0 = time.perf_counter()
    parts = parts.contiguous()
    if parts.is_cuda and c.backend == "nccl":
        out = torch.empty((c.size * parts.shape[0],) + tuple(parts.shape[1:]),
                          dtype=parts.dtype, device=parts.device)
        dist.all_gather_into_tensor(out, parts)
    else:
        host = parts.cpu()
        bufs = [torch.empty_like(host) for _ in range(c.size)]
        dist.all_gather(bufs, host, group=c.host_group)
        out = torch.cat(bufs).to(parts.device)
    dt = time.perf_counter() - t0
    GATHER_STATS["calls"] += 1
    GATHER_STATS["bytes"] += int(parts.numel() * parts.element_size()
                                 * c.size)
    GATHER_STATS["seconds"] += dt
    from ..runtime import phases as _phases

    _phases.add("collective", dt)
    return out


def collective_fence(x) -> None:
    """Block until the device work behind `x` is done before a collective
    starts, so every rank enters the gather with finished partials and the
    gather's clock (`GATHER_STATS`) holds the exchange alone. On the CPU,
    and on a one-rank cloud, it is a no-op."""
    c = _cloud
    if c is not None and c.size > 1 and isinstance(x, torch.Tensor) \
            and x.is_cuda:
        torch.cuda.synchronize(x.device)


_training_lock = threading.RLock()


def training_guard():
    """Context manager serializing whole training jobs across threads on a
    multi-process cloud: collective launch order must be identical on
    every rank. This lock serializes jobs WITHIN each process; across
    ranks it is the SPMD contract — every rank runs the same training
    script, so jobs are submitted in the same program order everywhere.
    A one-rank cloud returns a no-op context."""
    if must_serialize_training():
        return _training_lock
    return contextlib.nullcontext()


def must_serialize_training() -> bool:
    """True when `training_guard()` would hand out the real lock: the
    cloud has more than one rank."""
    c = _cloud
    return bool(c is not None and c.size > 1)


def pad_to_multiple(n: int, k: int) -> int:
    """Rows are padded so every rank's slice and every block is
    equal-sized."""
    return ((n + k - 1) // k) * k

"""Multi-process launcher — cluster bring-up, the port of
`h2o3_tpu/parallel/launcher.py`.

Reference parity: `h2o-hadoop-common`'s Hadoop launcher and the `h2o-k8s`
launcher, plus `H2O.main`'s clouding handshake (SURVEY.md §3.1). One
Python process per rank joins a `torch.distributed` process group: the
coordinator address is the flatfile, the rank the node index, and the
cloud "locks" when every process has connected (`mesh.init`).

Usage (one command per rank):

    python -m h2o3_tpu_torch.parallel.launcher \\
        --coordinator ${HOST0}:29500 --nprocs 2 --rank ${RANK} \\
        train_script.py [script args...]

``--coordinator`` also takes a URL (``tcp://host:port``, or
``file:///shared/path`` for a rendezvous through a file every rank can
reach). With no flags the launcher reads the rendezvous that
`torch.distributed` launchers export (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), which stands in for JAX's
auto-detection from TPU metadata; without them it forms a one-rank cloud.
Programmatically: `initialize_multihost(...)`, then train.
"""

from __future__ import annotations

import os
import runpy
import sys
from typing import Optional


def _env_rendezvous():
    """(coordinator, nprocs, rank) from a torch launcher's environment, or
    None when it exports no multi-rank rendezvous."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "") or 0)
        rank = int(os.environ.get("RANK", "") or 0)
    except ValueError:
        return None
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if world > 1 and addr and port:
        return f"{addr}:{port}", world, rank
    return None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Join (or form) the multi-process cloud. Returns cloud facts.

    With no arguments, uses a torch launcher's environment (the analog of
    multicast discovery), else a one-rank cloud; with explicit arguments it
    behaves like flatfile clouding."""
    from . import mesh

    if not (coordinator_address or num_processes or process_id is not None):
        env = _env_rendezvous()
        if env is not None:
            coordinator_address, num_processes, process_id = env
    if num_processes and int(num_processes) > 1 and process_id is None:
        process_id = int(os.environ.get("RANK", "0") or 0)
    c = mesh.init(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    facts = dict(
        process_index=c.self_idx,
        process_count=c.size,
        local_devices=len(c.devices),
        global_devices=len(c.devices) * c.size,
        backend=c.backend,
    )
    # the reference's two hooks: fleet registration with a metrics
    # aggregator and the supervisor watcher under a fence deadline
    if os.environ.get("H2O3_FLEET_AGGREGATOR") \
            and os.environ.get("H2O3_FLEET_SELF_URL"):
        raise NotImplementedError(
            "fleet registration (H2O3_FLEET_AGGREGATOR) needs the REST "
            "server, which is not ported (ROADMAP queue A, item 11)")
    fence = os.environ.get("H2O3_FENCE_DEADLINE_S", "")
    if facts["process_count"] > 1 and fence not in ("", "0") \
            and float(fence) > 0:
        raise NotImplementedError(
            "the supervisor watcher (H2O3_FENCE_DEADLINE_S) is not ported "
            "(ROADMAP queue A, item 9: the supervisor)")
    return facts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="h2o3_tpu_torch multi-process launcher (one process "
                    "a rank)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (the 'flatfile' head), or a "
                         "tcp:// or file:// URL")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("script", help="training script to run after clouding")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    facts = initialize_multihost(args.coordinator, args.nprocs, args.rank)
    from ..runtime.log import Log
    from . import mesh

    Log.info(f"cloud up: process {facts['process_index']}/"
             f"{facts['process_count']} with {facts['local_devices']} local "
             f"device(s), backend {facts['backend']}")
    sys.argv = [args.script] + list(args.script_args)
    try:
        runpy.run_path(args.script, run_name="__main__")
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()

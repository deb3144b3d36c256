"""GatewayWorker: one shard of the sharded gateway's data plane, the port
of ``blendjax.serve.gateway_worker``.

``python -m blendjax_torch.serve.gateway_worker`` runs a
:class:`~blendjax_torch.serve.gateway.ServeGateway` in worker mode
(``worker_index`` of ``n_workers``): a full gateway with its own client
address, shm front, leases, reply cache and replica DEALERs, except that

- its lease ids are congruent to ``worker_index`` mod ``n_workers`` (never
  colliding with a sibling; the owner is computable from the id alone),
  and
- it does not scrape, quarantine or canary the replica fleet: the control
  plane (:class:`~blendjax_torch.serve.gateway.ShardedGateway`) does, and
  its verdicts arrive as versioned ``gw_snapshot`` publications.

Workers are spawned, supervised and shm-swept by the
:class:`~blendjax_torch.serve.gateway.ShardedGateway` front; running one
alone is only useful to debug a shard.  Imports no torch.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from blendjax_torch.serve.gateway import ServeGateway

logger = logging.getLogger("blendjax_torch")


class GatewayWorker(ServeGateway):
    """A worker-mode :class:`ServeGateway` (see module docstring).
    Construction requires the shard identity; everything else is the
    plain gateway."""

    def __init__(self, address, replicas, *, worker_index, n_workers,
                 **kwargs):
        if worker_index is None:
            raise ValueError("a GatewayWorker needs worker_index")
        if not 0 <= int(worker_index) < int(n_workers):
            raise ValueError(
                f"worker_index {worker_index} out of range for "
                f"{n_workers} workers"
            )
        super().__init__(address, replicas, worker_index=int(worker_index),
                         n_workers=int(n_workers), **kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One shard of a sharded blendjax_torch serve gateway."
    )
    ap.add_argument("--address", required=True,
                    help="this worker's own client-facing address")
    ap.add_argument("--replica", action="append", required=True,
                    help="backend replica address (repeatable)")
    ap.add_argument("--worker-index", type=int, required=True)
    ap.add_argument("--workers", type=int, required=True,
                    help="total workers in the shard set")
    ap.add_argument("--scrape-interval", type=float, default=0.25)
    ap.add_argument("--shm-base", default=None,
                    help="parent-pinned shm base prefix (the front "
                         "sweeps it around respawns)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    worker = GatewayWorker(
        args.address, args.replica,
        worker_index=args.worker_index, n_workers=args.workers,
        scrape_interval_s=args.scrape_interval,
        shm_base=args.shm_base,
    )
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info("gateway worker gw%d/%d at %s over %d replicas",
                args.worker_index, args.workers, worker.address,
                len(args.replica))
    try:
        worker.serve_forever(stop_event=stop)
    finally:
        worker.close()


if __name__ == "__main__":
    main()

"""``python -m blendjax_torch.parallel.stage``: one MPMD pipeline stage
process; the port of ``blendjax.parallel.stage``.

:class:`~blendjax_torch.parallel.mpmd.StageFleet` spawns N of these (the
parent picks the addresses and ``/dev/shm`` name prefixes, on the command
line), ``FleetWatchdog(restart=True)`` respawns one that dies with the same
command line, and the respawned stage restores its params from its latest
checkpoint cut, so the driver's reconcile and replay resume training
exactly.  The stage computes on ``--device``: the card unless ``cpu`` is
asked for; without a card ``cuda`` exits with an error.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading


def main(argv=None):
    parser = argparse.ArgumentParser(description="blendjax_torch MPMD pipeline stage process")
    parser.add_argument("--address", required=True, help="ZMQ REP bind address for this stage")
    parser.add_argument("--proc-index", type=int, required=True)
    parser.add_argument("--spec", required=True, help="pipeline spec as a JSON object")
    parser.add_argument("--prev-address", default=None)
    parser.add_argument("--next-address", default=None)
    parser.add_argument("--shm-base", default=None,
                        help="parent-allocated /dev/shm name prefix")
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--ckpt-every", type=int, default=1)
    parser.add_argument("--work-us", type=int, default=0,
                        help="benchmark compute stand-in: sleep this many microseconds per "
                             "owned layer unit per direction")
    parser.add_argument("--device", default="cuda",
                        help="the stage's device (default: the card; 'cpu' on the host)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=args.log_level,
        format=f"%(asctime)s stage{args.proc_index} %(levelname)s %(message)s",
    )

    from blendjax_torch.parallel.mpmd import MpmdStage

    stage = MpmdStage(
        args.address, json.loads(args.spec), args.proc_index,
        prev_address=args.prev_address, next_address=args.next_address,
        shm_base=args.shm_base, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        work_us=args.work_us, device=args.device,
    )
    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    logging.getLogger("blendjax_torch").info(
        "pipe stage %d/%d serving at %s on %s (applied=%d)",
        stage.proc_index, stage.n_procs, stage.address, stage.device, stage._applied,
    )
    try:
        stage.serve_forever(stop_event=stop)
    finally:
        stage.close()


if __name__ == "__main__":
    main()

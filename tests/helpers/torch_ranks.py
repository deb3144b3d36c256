"""Real ``torch.distributed`` ranks over gloo on the CPU, for the port's
mesh and sharding tests.

``Ranks(program, world, args)`` spawns ``world`` processes (the ``spawn``
start method: a fresh interpreter each, torch limited to one thread), joins
them in a gloo process group at ``tcp://127.0.0.1:<free port>`` and runs
``program(rank, world, args, report)`` in each.  The program calls
``report(case, value)`` as each case finishes; ``result(case, timeout)``
returns ``{rank: value}`` once every rank has reported the case, so each
test waits for its own case under its own limit while the ranks run every
case once.  A rank that raises reports its traceback as the case
``"error"``, and ``result`` raises it.  ``close()`` joins the ranks and
kills any still running.

A set of ``EXCLUSIVE_WORLD`` ranks or more first takes an exclusive lock on
one file under the temporary directory, held until its ranks have exited:
under ``pytest -n`` one such set runs at a time, so the 8-rank modules do
not stack their processes up beside the other workers' live-fleet tests.

The programs import torch and the port only, never JAX: the test process
holds the JAX side.
"""

from __future__ import annotations

import fcntl
import multiprocessing as mp
import os
import queue
import socket
import tempfile
import time
import traceback

#: rank sets this large run one at a time on a host
EXCLUSIVE_WORLD = 4
LOCK_PATH = os.path.join(tempfile.gettempdir(), "blendjax-torch-ranks.lock")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(program, rank, world, port, args, out):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        try:
            program(rank, world, args, lambda case, value: out.put((case, rank, value)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the test process
        out.put(("error", rank, traceback.format_exc()))


class Ranks:
    def __init__(self, program, world, args=None):
        ctx = mp.get_context("spawn")
        self.world = world
        self._lock = None
        if world >= EXCLUSIVE_WORLD:
            self._lock = open(LOCK_PATH, "a")  # noqa: SIM115 - held until the ranks exit
            fcntl.flock(self._lock, fcntl.LOCK_EX)
        self._out = ctx.Queue()
        self._seen = {}
        port = _free_port()
        self._procs = [ctx.Process(target=_entry, args=(program, r, world, port, args,
                                                        self._out), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def result(self, case, timeout):
        """``{rank: value}`` of ``case`` once every rank reported it."""
        deadline = time.monotonic() + timeout
        while len(self._seen.get(case, {})) < self.world:
            if "error" in self._seen:
                rank, tb = next(iter(self._seen["error"].items()))
                raise RuntimeError(f"rank {rank} failed:\n{tb}")
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"case {case!r}: {len(self._seen.get(case, {}))} of "
                                   f"{self.world} ranks reported within {timeout} s")
            try:
                name, rank, value = self._out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if not any(p.is_alive() for p in self._procs) and self._out.empty():
                    self._release()
                    raise RuntimeError(f"case {case!r}: the ranks exited without reporting "
                                       f"it (exit codes {[p.exitcode for p in self._procs]})")
                continue
            self._seen.setdefault(name, {})[rank] = value
        if not any(p.is_alive() for p in self._procs):
            self._release()
        return self._seen[case]

    def close(self):
        # drain before joining: a rank blocks at exit until its queue is read
        deadline = time.monotonic() + 30
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:
                name, rank, value = self._out.get(timeout=0.2)
                self._seen.setdefault(name, {})[rank] = value
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        self._release()

    def _release(self):
        if self._lock is not None:
            self._lock.close()  # closing the file drops its lock
            self._lock = None

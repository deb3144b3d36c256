"""Deterministic fault injection for fleet testing, the port of
``blendjax.btt.chaos``.

The failure paths in :mod:`blendjax_torch.btt.faults`, :mod:`.envpool`,
:mod:`.supervise` and the replay service are only trustworthy if they can
be exercised on demand, not by hoping a sleep lines up with a crash.  This
module provides:

- :class:`ChaosProxy` — a TCP relay to park between a client and one
  endpoint.  It can **stall** (stop forwarding: the client sees silence,
  like a hung peer), **cut** (close live connections mid-message: a
  crashed peer at the TCP layer), and **drop** or **duplicate** the next
  chunk of one direction (the gateway's wire-fault tests).  The
  reference's garble, close-next and delay have no caller in the port's
  tests and are not ported.
- :func:`wait_env_ready` — the startup barrier: every env endpoint
  answers a ``reset``.
- :func:`kill_instance` — SIGKILL a launched process's whole group (no
  cleanup runs: shm rings linger, sockets die mid-message — the honest
  crash).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import threading
import time

logger = logging.getLogger("blendjax_torch")

def _parse_endpoint(endpoint):
    """'tcp://host:port' | (host, port) | port -> (host, port)."""
    if isinstance(endpoint, int):
        return "127.0.0.1", endpoint
    if isinstance(endpoint, (tuple, list)):
        return endpoint[0], int(endpoint[1])
    addr = endpoint
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://"):]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class ChaosProxy:
    """TCP relay with programmatic fault injection.

    Point the client at :attr:`address` instead of the endpoint; the proxy
    accepts any number of connections and pipes each to its own upstream
    connection.

    Params
    ------
    upstream: str | int | (host, port)
        The real endpoint (``tcp://host:port`` form accepted).
    listen_host: str
        Interface to listen on (an ephemeral port is chosen).
    """

    def __init__(self, upstream, listen_host="127.0.0.1"):
        self._up_host, self._up_port = _parse_endpoint(upstream)
        self._stop = threading.Event()
        self._open = threading.Event()
        self._open.set()
        self._lock = threading.Lock()
        self._conns = []  # live (client, upstream) socket pairs
        self._sched = {"up": {}, "down": {}}  # chunk index -> action
        self.chunks = {"up": 0, "down": 0}
        self.dropped = 0
        self.duplicated = 0
        self.cuts = 0

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()[:2]
        self.address = f"tcp://{self.host}:{self.port}"
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="bjx-chaos-accept")
        ]
        self._threads[0].start()

    # -- control ---------------------------------------------------------------

    def _next(self, action, direction):
        with self._lock:
            self._sched[direction][self.chunks[direction]] = action

    def drop_next(self, direction="down"):
        """Discard the next chunk of ``direction`` ('up' = client to
        endpoint, 'down' = endpoint to client): a lost reply or request."""
        self._next("drop", direction)

    def dup_next(self, direction="down"):
        """Forward the next chunk of ``direction`` twice (duplicated
        delivery)."""
        self._next("dup", direction)

    def stall(self):
        """Stop forwarding in both directions (hung peer): the client sees
        silence until :meth:`resume`, not a disconnect."""
        self._open.clear()

    def resume(self):
        self._open.set()

    def cut(self):
        """Close every live connection now (crashed peer).  The listener
        stays up, so ZMQ's automatic reconnect comes back through the
        proxy."""
        with self._lock:
            conns, self._conns = self._conns, []
        for pair in conns:
            self._close_pair(pair)
        if conns:
            self.cuts += 1

    # -- plumbing ------------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            try:
                up = socket.create_connection(
                    (self._up_host, self._up_port), timeout=10
                )
            except OSError:
                client.close()
                time.sleep(0.05)  # upstream down: shed and let ZMQ redial
                continue
            for s in (client, up):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pair = (client, up)
            with self._lock:
                self._conns.append(pair)
            for src, dst, direction in (
                (client, up, "up"), (up, client, "down"),
            ):
                t = threading.Thread(
                    target=self._pump, args=(src, dst, direction, pair),
                    daemon=True, name=f"bjx-chaos-{direction}",
                )
                t.start()
                self._threads.append(t)

    def _close_pair(self, pair):
        for s in pair:
            # shutdown first: close() alone would not terminate the
            # connection while the sibling pump thread is blocked in
            # recv() on the fd (the kernel keeps the open file
            # description alive under the in-flight syscall — no FIN
            # would ever reach the peer)
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def _pump(self, src, dst, direction, pair):
        try:
            while not self._stop.is_set():
                try:
                    data = src.recv(65536)
                except OSError:
                    return
                if not data:
                    return
                # stall gate: hold the chunk (and everything behind it)
                while not self._open.wait(0.05):
                    if self._stop.is_set():
                        return
                with self._lock:
                    idx = self.chunks[direction]
                    self.chunks[direction] = idx + 1
                    action = self._sched[direction].pop(idx, None)
                if action == "drop":
                    self.dropped += 1
                    continue
                try:
                    dst.sendall(data)
                    if action == "dup":
                        # counted before the second send: a reader that
                        # sees the duplicate has already seen the count
                        self.duplicated += 1
                        dst.sendall(data)
                except OSError:
                    return
        finally:
            self._close_pair(pair)

    def close(self):
        self._stop.set()
        self._open.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.cut()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def wait_env_ready(addresses, timeout_s=30.0):
    """Block until every GYM endpoint answers a ``reset`` handshake —
    the deterministic startup barrier for fault tests: counters measured
    after it reflect injected faults only, never producer boot time.
    Each attempt uses a throwaway REQ socket (no strict-alternation
    lockup on timeout).  Raises TimeoutError naming the silent endpoint.
    """
    import zmq

    from blendjax_torch import wire

    ctx = zmq.Context.instance()
    deadline = time.monotonic() + timeout_s
    for addr in addresses:
        while True:
            remaining_ms = int((deadline - time.monotonic()) * 1000)
            if remaining_ms <= 0:
                raise TimeoutError(
                    f"environment at {addr} not ready within {timeout_s}s"
                )
            s = ctx.socket(zmq.REQ)
            s.setsockopt(zmq.LINGER, 0)
            s.connect(addr)
            try:
                wire.send_message(s, {"cmd": "reset", "time": None})
                if s.poll(min(1000, remaining_ms), zmq.POLLIN):
                    wire.recv_message(s)
                    break
            except zmq.Again:
                pass
            finally:
                s.close(0)


def kill_instance(launcher, idx, sig=signal.SIGKILL):
    """Kill producer ``idx``'s whole process group with no cleanup — the
    honest crash (shm rings linger, REQ/REP peers die mid-conversation).
    Returns the killed process object; pair with
    :class:`~blendjax_torch.btt.watchdog.FleetWatchdog` / ``FleetSupervisor``
    restarts to exercise the respawn-and-resync path."""
    proc = launcher.launch_info.processes[idx]
    try:
        if os.name == "posix":
            os.killpg(os.getpgid(proc.pid), sig)
        else:  # pragma: no cover - windows CI
            proc.kill()
    except (ProcessLookupError, PermissionError):
        proc.kill()
    return proc

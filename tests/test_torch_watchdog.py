"""The port's ``FleetWatchdog`` (``blendjax_torch.btt.watchdog``) on the
port's ``BlenderLauncher``: ``tests/test_watchdog.py``'s first three cases
(prompt death detection reported once, a raising ``on_death`` callback that
does not kill the watchdog, restart with the original command line), with
``tests/blender/torch_exit.blend.py`` (publishes once, exits) under the fake
Blender.  The shm respawn case is ``tests/test_torch_launcher.py``'s."""

import time

import pytest
import zmq

from blendjax_torch import wire
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.watchdog import FleetWatchdog
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _free_block

EXIT_SCRIPT = f"{BLEND_SCRIPTS}/torch_exit.blend.py"


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)


def _launcher():
    return BlenderLauncher(scene="", script=EXIT_SCRIPT, num_instances=1,
                           named_sockets=["DATA"], start_port=_free_block(1),
                           background=True)


def _drain(addresses, n, timeoutms=30000):
    ctx = zmq.Context()
    try:
        sock = ctx.socket(zmq.PULL)
        for a in addresses:
            sock.connect(a)
        out = []
        for _ in range(n):
            assert sock.poll(timeoutms)
            out.append(wire.recv_message(sock))
        return out
    finally:
        ctx.destroy(linger=0)


def test_detects_death_once(fake_blender):
    deaths = []
    with _launcher() as bl:
        with FleetWatchdog(bl, interval=0.2, on_death=lambda i, c: deaths.append((i, c))) as wd:
            _drain(bl.launch_info.addresses["DATA"], 1)
            bl.launch_info.processes[0].wait(timeout=30)  # publishes once, then exits
            deadline = time.time() + 10
            while not deaths and time.time() < deadline:
                time.sleep(0.1)
            assert deaths and deaths[0][0] == 0
            time.sleep(0.6)  # more polls must not duplicate the report
            assert len(deaths) == 1
            assert wd.alive == 0


def test_on_death_exception_does_not_kill_watchdog(fake_blender):
    deaths = []

    def bad_callback(idx, code):
        deaths.append((idx, code))
        raise RuntimeError("user callback bug")

    with _launcher() as bl:
        with FleetWatchdog(bl, interval=0.2, on_death=bad_callback, restart=True) as wd:
            # each (re)spawned producer publishes once and exits once drained
            for expected in (1, 2):
                _drain(bl.launch_info.addresses["DATA"], 1)
                deadline = time.time() + 30
                while len(deaths) < expected and time.time() < deadline:
                    time.sleep(0.1)
                assert len(deaths) >= expected
            assert wd._thread.is_alive()
            assert all(d[2] for d in wd.deaths)


def test_restart_respawns_instance(fake_blender):
    with _launcher() as bl:
        with FleetWatchdog(bl, interval=0.2, restart=True) as wd:
            _drain(bl.launch_info.addresses["DATA"], 1)
            # the instance exits; the watchdog respawns it, and the respawn
            # publishes again on the same (re-bound) address
            msgs = _drain(bl.launch_info.addresses["DATA"], 1)
            assert msgs[0]["btid"] == 0
            assert wd.deaths and wd.deaths[0][2] is True

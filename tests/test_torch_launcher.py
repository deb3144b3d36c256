"""The port's ``BlenderLauncher`` transports and its launch CLI, under the
fake Blender.

- ``proto='ipc'`` and ``proto='shm'`` addresses: the reference's names for
  the same launch (shm under the per-launch nonce, ipc under the temporary
  directory), and a stream over each;
- the sweep at exit: nothing under the launch's ``/dev/shm`` prefix;
- a SIGKILLed shm producer under ``FleetWatchdog(restart=True)``: the
  respawn's sweep removes the dead ring, the reader reopens the new
  generation, the stream goes on, and ``/dev/shm`` is empty after exit;
- ``python -m blendjax_torch.btt.apps.launch``, after
  ``tests/test_launcher.py::test_launch_cli_app``.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from blendjax_torch import datagen
from blendjax_torch.btt import shm_rpc
from blendjax_torch.btt.dataset import RemoteIterableDataset
from blendjax_torch.btt.launch_info import LaunchInfo
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.watchdog import FleetWatchdog
from blendjax_torch.utils.timing import EventCounters
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _free_block
from test_torch_watchdog import _drain

REPO = Path(__file__).resolve().parent.parent
EXIT_SCRIPT = f"{BLEND_SCRIPTS}/torch_exit.blend.py"
SMALL = ["--height", "16", "--width", "24", "--keypoints", "2"]


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)


def _bare(proto, nonce="cafe0123"):
    bl = BlenderLauncher.__new__(BlenderLauncher)
    bl.bind_addr, bl.proto, bl.start_port = "127.0.0.1", proto, 13000
    bl.num_instances, bl.named_sockets = 2, ["DATA", "CTRL"]
    bl._nonce = nonce
    bl._shm_base = f"blendjax-{nonce}"
    return bl


@pytest.mark.parametrize("proto", ["tcp", "ipc", "shm"])
def test_addresses_match_the_reference(proto):
    from blendjax.btt.launcher import BlenderLauncher as JLauncher

    port = _bare(proto)
    ref = JLauncher.__new__(JLauncher)
    ref.__dict__.update(port.__dict__)
    got = port._addresses()
    if proto == "ipc":
        tmp = tempfile.gettempdir()
        assert got["DATA"] == [f"ipc://{tmp}/blendjax-DATA-13000.ipc",
                               f"ipc://{tmp}/blendjax-DATA-13001.ipc"]
        assert got["CTRL"][0] == f"ipc://{tmp}/blendjax-CTRL-13002.ipc"
    if proto == "shm":
        assert got["DATA"] == ["shm://blendjax-cafe0123-DATA-13000",
                               "shm://blendjax-cafe0123-DATA-13001"]
    if tempfile.gettempdir() == "/tmp" or proto != "ipc":
        assert got == ref._addresses()


def test_unknown_proto_refused(fake_blender):
    with pytest.raises(ValueError, match="proto"):
        BlenderLauncher(scene="", script=EXIT_SCRIPT, proto="udp")


@pytest.mark.parametrize("proto", ["ipc", "shm"])
def test_stream_over_proto_and_sweep_at_exit(fake_blender, proto):
    counters = EventCounters()
    with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=2,
                         named_sockets=["DATA"], start_port=_free_block(2), seed=3,
                         background=True, proto=proto, instance_args=[SMALL] * 2) as bl:
        base = bl._shm_base
        addrs = bl.launch_info.addresses["DATA"]
        assert all(a.startswith(f"{proto}://") for a in addrs)
        if proto == "shm":
            # the worker rotates over both rings, but the first ring can fill
            # 16 items before the second producer publishes: read on until
            # both producers' items have come (a rotation stuck on one ring
            # runs into the limit and fails)
            ds = RemoteIterableDataset(addrs, max_items=10**6, timeoutms=20000,
                                       counters=counters)
            batches, btids, deadline = [], set(), time.monotonic() + 60
            with contextlib.closing(ds.stream_batches(4)) as stream:
                for b in stream:
                    batches.append(b)
                    btids |= {int(v) for v in b["btid"]}
                    if (len(batches) >= 4 and btids == {0, 1}) or time.monotonic() > deadline:
                        break
        else:
            ds = RemoteIterableDataset(addrs, max_items=16, timeoutms=20000, counters=counters)
            batches = list(ds.stream_batches(4))
            assert len(batches) == 4
        assert all(b["image"].shape == (4, 16, 24, 3) for b in batches)
        btids = {int(v) for b in batches for v in b["btid"]}
        assert btids <= {0, 1}
        if proto == "shm":
            assert btids == {0, 1}  # the worker rotates over both rings
            assert counters.get("stream_shm_rings") == 2
            assert len(shm_rpc.leaked_objects(base)) == 2  # the two live rings
    assert shm_rpc.leaked_objects(base) == []


def test_sigkilled_shm_producer_respawned_stream_goes_on(fake_blender):
    counters = EventCounters()
    with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=2,
                         named_sockets=["DATA"], start_port=_free_block(2), seed=0,
                         background=True, proto="shm", instance_args=[SMALL] * 2) as bl:
        base = bl._shm_base
        with FleetWatchdog(bl, interval=0.2, restart=True) as wd:
            ds = RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=10**6,
                                       timeoutms=30000, counters=counters)
            stream = ds.stream()
            last, restarted = {}, False
            t_end = time.monotonic() + 60
            for n, item in enumerate(stream):
                btid, fid = int(item["btid"]), int(item["frameid"])
                if btid == 0 and fid < last.get(0, -1):
                    restarted = True  # the respawned incarnation counts from 0
                    break
                last[btid] = fid
                if n == 20:
                    pid = bl.launch_info.processes[0].pid
                    os.killpg(os.getpgid(pid), signal.SIGKILL)
                assert time.monotonic() < t_end, "the respawned producer never streamed"
            stream.close()
            assert restarted
            assert any(d[0] == 0 and d[2] for d in wd.deaths)  # restarted by the watchdog
    assert shm_rpc.leaked_objects(base) == []


def test_launch_cli_app(fake_blender, tmp_path):
    jsonargs = tmp_path / "args.json"
    jsonargs.write_text(json.dumps({
        "scene": "", "script": EXIT_SCRIPT, "num_instances": 2, "named_sockets": ["DATA"],
        "start_port": _free_block(2), "seed": 1, "background": True}))
    out_info = tmp_path / "launch_info.json"
    proc = subprocess.Popen([sys.executable, "-m", "blendjax_torch.btt.apps.launch",
                             "--out-launch-info", str(out_info), str(jsonargs)], cwd=REPO)
    try:
        deadline = time.time() + 30
        while not out_info.exists() and time.time() < deadline:
            time.sleep(0.1)
        assert out_info.exists(), "the launch CLI never wrote its launch info"
        time.sleep(0.2)  # the file is written in one dump; let it land
        info = LaunchInfo.load_json(str(out_info))
        msgs = _drain(info.addresses["DATA"], 2)
        assert {m["btid"] for m in msgs} == {0, 1}
        assert proc.wait(timeout=30) == 0  # producers exit -> the CLI exits
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_assert_alive_detects_death(fake_blender):
    """``tests/test_launcher.py::test_assert_alive_detects_death``: a
    producer that publishes once and exits fails ``assert_alive``, a live
    one passes it."""
    with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=1,
                         named_sockets=["DATA"], start_port=_free_block(1), seed=0,
                         background=True, instance_args=[SMALL]) as bl:
        _drain(bl.launch_info.addresses["DATA"], 1)
        bl.assert_alive()
    with BlenderLauncher(scene="", script=EXIT_SCRIPT, num_instances=1,
                         named_sockets=["DATA"], start_port=_free_block(1), seed=0,
                         background=True) as bl:
        _drain(bl.launch_info.addresses["DATA"], 1)
        bl.wait()  # the producer publishes once, then exits
        with pytest.raises(RuntimeError, match="exit codes"):
            bl.assert_alive()

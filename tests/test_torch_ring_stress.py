"""The twins of ``tests/test_ring_stress.py`` on the port's shm transport
(``blendjax_torch/native/ringbuf.cpp``), under the same skip condition
(the native ring must build).

1. ``test_churn_kill_respawn``: 3 producer processes (the port's
   ``DataPublisher``, ``helpers/torch_churn_producer.py``), the port's
   2-worker ``BatchLoader`` fan-in, and a killer that SIGKILLs a producer
   round-robin and respawns it at the same address with a bumped
   generation.  The stream never stalls past its timeout, per-(btid, gen)
   frame ids rise strictly, and no stale-generation frame arrives after a
   newer generation of that producer was seen.
2. ``test_tsan_stress_binary``: ``blendjax_torch/native/tsan_stress.cpp``
   (writer, reader and generation churn over the port's ring code compiled
   ``-fsanitize=thread`` in one process), built under a temporary
   directory; skipped where no compiler builds it.
"""

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from blendjax_torch.native import native_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers",
                        "torch_churn_producer.py")
HARNESS = os.path.join(REPO, "blendjax_torch", "native", "tsan_stress.cpp")

pytestmark = pytest.mark.skipif(not native_available(), reason="native ring not built")


def _spawn(addr, btid, gen, env):
    return subprocess.Popen(
        [sys.executable, PRODUCER, "--addr", addr, "--btid", str(btid), "--gen", str(gen),
         "--rate-hz", "800"],
        env=env, stderr=subprocess.PIPE, text=True)


def _ring_ino(addr):
    try:
        return os.stat(os.path.join("/dev/shm", addr[len("shm://"):])).st_ino
    except OSError:
        return None


def test_churn_kill_respawn():
    """As the reference's: the killer paces itself on each respawn (the
    replacement's ring inode), and the consume loop runs until every
    producer's post-respawn generation has been delivered or 45 s."""
    from blendjax_torch.btt.dataset import RemoteIterableDataset
    from blendjax_torch.btt.loader import BatchLoader
    from blendjax_torch.native import unlink_address

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    n_producers, max_seconds = 3, 45.0
    addrs = [f"shm://bjx-test-tchurn-{os.getpid()}-{i}" for i in range(n_producers)]
    gens = [0] * n_producers
    procs = [_spawn(addrs[i], i, 0, env) for i in range(n_producers)]
    stop = threading.Event()

    def killer():
        k = 0
        while not stop.is_set():
            i = k % n_producers
            k += 1
            old_ino = _ring_ino(addrs[i])
            try:
                os.kill(procs[i].pid, signal.SIGKILL)
            except OSError:
                pass
            procs[i].communicate()
            gens[i] += 1
            procs[i] = _spawn(addrs[i], i, gens[i], env)
            deadline = time.monotonic() + 20
            while (not stop.is_set() and time.monotonic() < deadline
                   and _ring_ino(addrs[i]) == old_ino):
                time.sleep(0.05)
            stop.wait(0.3)

    kt = threading.Thread(target=killer, daemon=True)
    last_frame = {}  # btid -> (gen, frameid)
    n = 0
    ds = RemoteIterableDataset(addrs, max_items=10**9, timeoutms=60000)
    loader = BatchLoader(ds, batch_size=8, num_workers=2)
    try:
        deadline = time.monotonic() + 90
        while any(_ring_ino(a) is None for a in addrs) and time.monotonic() < deadline:
            time.sleep(0.1)
        it = iter(loader)
        next(it)  # every ring up before the killing starts
        kt.start()
        t0 = time.monotonic()
        while (time.monotonic() - t0 < max_seconds
               and not all(last_frame.get(b, (0,))[0] >= 1 for b in range(n_producers))):
            batch = next(it)  # a stall past timeoutms raises
            for btid, gen, frameid in zip(batch["btid"], batch["gen"], batch["frameid"]):
                btid, gen, frameid = int(btid), int(gen), int(frameid)
                prev = last_frame.get(btid)
                if prev is not None:
                    assert gen >= prev[0], (f"stale generation delivered: btid {btid} "
                                            f"gen {gen} after gen {prev[0]}")
                    if gen == prev[0]:
                        assert frameid > prev[1], (f"non-monotonic frameid within btid "
                                                   f"{btid} gen {gen}: {frameid} after "
                                                   f"{prev[1]}")
                last_frame[btid] = (gen, frameid)
                n += 1
    finally:
        stop.set()
        if kt.ident is not None:
            kt.join(timeout=5)
        loader.close()
        for p in procs:
            p.kill()
        for p in procs:
            try:
                p.communicate(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        for a in addrs:
            unlink_address(a)
    assert n > 100, f"churn harness consumed only {n} messages"
    assert all(g >= 1 for g in gens), "killer never cycled some producer"
    for btid in range(n_producers):
        assert btid in last_frame, f"producer {btid} never delivered"
        assert last_frame[btid][0] >= 1, (f"producer {btid}: no post-respawn generation "
                                          "was delivered (the reader did not heal)")


def test_tsan_stress_binary():
    """The port's ring under ThreadSanitizer: writer, reader and
    generation churn in one process.  Built under a temporary directory
    (never next to the sources); skipped where the build is unavailable."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        pytest.skip(f"{cxx} not available")
    with tempfile.TemporaryDirectory(prefix="bjx-tsan-") as tmp:
        binary = os.path.join(tmp, "tsan_stress")
        r = subprocess.run([cxx, "-O1", "-g", "-std=c++17", "-Wall", "-fsanitize=thread",
                            HARNESS, "-o", binary, "-lrt", "-pthread"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"TSAN build unavailable: {r.stderr[-300:]}")
        r = subprocess.run([binary], capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, f"tsan_stress failed:\n{r.stderr[-4000:]}"
    assert "WARNING: ThreadSanitizer" not in r.stderr, (
        f"data race in the ring:\n{r.stderr[-4000:]}")
    assert "tsan stress ok" in r.stdout

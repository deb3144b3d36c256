#!/usr/bin/env python3
"""Where the shm datagen stream's per-frame copy loses its rate: the
native ``copy_into`` of one 480 x 640 x 3 uint8 frame (0.92 MB), timed
from two sources into three destinations.

    python3 probes/ring_copy.py            # on a machine with a CUDA card
    python3 probes/ring_copy.py --cpu      # pageable destinations only

Sources: a record of a ``shm://`` ring written by a producer in another
process (the stream's path: the copy runs while the record is held, then
the record is released) and an anonymous ndarray in this process.
Destinations: one slot of a batch in page-locked memory
(``torch.empty(pin_memory=True)``), in pageable memory touched once
before (the stream's pooled arenas), and in pageable memory allocated
fresh for every batch (first-touch page faults included).  Seven batches
of eight slots rotate, as the arena pool does.  A last case gathers eight
anonymous frames into one pageable batch with ``gather_into``, as the tcp
stream's scatter does.  Prints the card's name and power limit, the host
name, then one JSON line per case: median and mean ms per frame, GB/s
at the median, and the mean over the first ring's worth of frames (64
MiB: a new ring's pages are touched there for the first time) beside the
mean over the rest.
"""

import argparse
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from blendjax_torch.native import ring  # noqa: E402

FRAME = (480, 640, 3)
BATCH, ARENAS = 8, 7

#: the producer: one header frame and one image frame per record, as
#: ``frames.blend.py`` publishes them; blocks on a full ring
_WRITER = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from blendjax_torch.native.ring import ShmRingWriter
w = ShmRingWriter({addr!r}, capacity_bytes=64 << 20)
img = np.random.default_rng(0).integers(0, 255, {shape!r}, np.uint8)
for i in range({n}):
    img[0, 0, 0] = i % 251
    assert w.send_frames([b"head%08d" % i, img], timeout_ms=30000)
w.close(unlink=False)
"""


def _slots(kind, torch):
    """ARENAS batches of BATCH frame slots in ``kind`` memory."""
    shape = (BATCH,) + FRAME
    if kind == "pinned":
        return [torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
                for _ in range(ARENAS)]
    bufs = [np.empty(shape, np.uint8) for _ in range(ARENAS)]
    for b in bufs:
        b.fill(1)  # touched once, as a recycled arena is
    return bufs


def _dst_iter(kind, torch, n):
    """The n destination slots of one case, in the pool's rotation."""
    if kind == "fresh":
        for i in range(n):
            if i % BATCH == 0:
                batch = np.empty((BATCH,) + FRAME, np.uint8)
            yield batch[i % BATCH]
        return
    bufs = _slots(kind, torch)
    for i in range(n):
        yield bufs[(i // BATCH) % ARENAS][i % BATCH]


def _summary(case, times_s, per_copy=1):
    p50 = statistics.median(times_s)
    nbytes = int(np.prod(FRAME))
    wrap = max(1, (64 << 20) // nbytes // per_copy)
    return {"case": case, "frames": len(times_s) * per_copy, "p50_ms": p50 * 1e3,
            "mean_ms": statistics.fmean(times_s) * 1e3, "gb_s_at_p50": nbytes / p50 / 1e9,
            "first_wrap_mean_ms": statistics.fmean(times_s[:wrap]) * 1e3,
            "later_mean_ms": statistics.fmean(times_s[wrap:] or times_s) * 1e3}


def from_ring(kind, torch, n):
    """Copy n frames out of a ring fed by a producer process into ``kind``
    slots; the copy alone is timed, the record held across it."""
    addr = f"shm://bjtprobe.{os.getpid()}.{kind}"
    code = _WRITER.format(root=ROOT, addr=addr, shape=FRAME, n=n)
    child = subprocess.Popen([sys.executable, "-c", code])
    reader = None
    try:
        reader = ring.ShmRingReader(addr, open_timeout_ms=30000, auto_reopen=False)
        times = []
        for dst in _dst_iter(kind, torch, n):
            frames = reader.recv_frames_view(timeout_ms=30000)
            if frames is None:
                raise SystemExit("ring_copy: the producer stalled")
            try:
                src = np.frombuffer(frames[1], np.uint8).reshape(FRAME)
                t0 = time.perf_counter()
                ring.copy_into(dst, src)
                times.append(time.perf_counter() - t0)
            finally:
                del src
                reader.release_record()
        if child.wait(timeout=60) != 0:
            raise SystemExit("ring_copy: the producer failed")
        return _summary(f"shm_ring->{kind}", times)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if reader is not None:
            reader.close(unlink=True)
        ring.unlink_address(addr)


def from_anon(kind, torch, n):
    """Copy n frames from anonymous memory into ``kind`` slots (sources
    rotate over as many frames as a ring of 64 MiB holds)."""
    rng = np.random.default_rng(1)
    srcs = [rng.integers(0, 255, FRAME, np.uint8) for _ in range(64)]
    times = []
    for i, dst in enumerate(_dst_iter(kind, torch, n)):
        t0 = time.perf_counter()
        ring.copy_into(dst, srcs[i % len(srcs)])
        times.append(time.perf_counter() - t0)
    return _summary(f"anon->{kind}", times)


def gather_anon(n):
    """gather_into of BATCH anonymous frames into a recycled pageable
    batch (the tcp stream's one gather a leaf), per frame."""
    rng = np.random.default_rng(2)
    srcs = [rng.integers(0, 255, FRAME, np.uint8) for _ in range(64)]
    bufs = _slots("pageable", None)
    times = []
    for b in range(n // BATCH):
        batch = [srcs[(b * BATCH + j) % len(srcs)] for j in range(BATCH)]
        t0 = time.perf_counter()
        ring.gather_into(bufs[b % ARENAS], batch)
        times.append((time.perf_counter() - t0) / BATCH)
    return _summary("anon_gather->pageable", times, BATCH)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="no card: pageable destinations only")
    ap.add_argument("--frames", type=int, default=448, help="frames copied in each case")
    args = ap.parse_args()
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("ring_copy: CUDA is not available (pass --cpu for the pageable cases)",
              file=sys.stderr)
        return 2
    ring.build_library()
    if not ring.native_available():
        print(f"ring_copy: the native ring did not build: {ring.load_error()}", file=sys.stderr)
        return 2
    card = "none"
    if not args.cpu:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    chip_smoke.emit({"card": card, "host": socket.gethostname(), "cpus": os.cpu_count()})
    kinds = ["pageable", "fresh"] if args.cpu else ["pinned", "pageable", "fresh"]
    for kind in kinds:
        chip_smoke.emit(from_ring(kind, torch, args.frames))
        chip_smoke.emit(from_anon(kind, torch, args.frames))
    chip_smoke.emit(gather_anon(args.frames))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host-to-card copy rate of one datagen batch's image (8 x 480 x 640 x 3
uint8, 7.4 MB) from page-locked memory.  Needs one CUDA card.

    python3 probes/h2d.py

Times, with CUDA events on a side stream, the copy from pinned tensors
allocated in this thread and in another thread, each written just before
by this thread or by another one, and from a rotation over 1, 2, 4, 7 or
16 pinned tensors (the feed's staging ring holds 2, the datagen stream's
arena pool 7).  Prints the card's name and power limit, then one JSON line
per case: median ms and GB/s.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("h2d: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    chip_smoke.emit({"card": card, "cpus": os.cpu_count()})
    return h2d(torch)


def h2d(torch, reps=20):
    """Median ms and GB/s of one image-sized host-to-card copy from a
    pinned tensor, by the thread that allocated it and the thread that
    last wrote it, then over a rotation of pinned tensors."""
    import statistics
    import threading

    import numpy as np

    shape = chip_smoke.MAIN_SHAPE
    out = torch.empty(shape, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()

    def pinned():
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True)

    def elsewhere(fn):
        box = []
        t = threading.Thread(target=lambda: box.append(fn()))
        t.start()
        t.join()
        return box[0]

    def timed_copy(src):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        with torch.cuda.stream(side):
            start.record()
            out.copy_(src, non_blocking=True)
            end.record()
        end.synchronize()
        return start.elapsed_time(end)

    tensors = {"main": pinned(), "thread": elsewhere(pinned)}
    for alloc, src in tensors.items():
        for writer in ("main", "thread"):
            times = []
            for i in range(reps):
                def fill():
                    np.copyto(src.numpy(), i % 251)

                fill() if writer == "main" else elsewhere(fill)
                times.append(timed_copy(src))
            ms = statistics.median(times)
            chip_smoke.emit({"phase": "h2d", "allocated_by": alloc, "written_by": writer,
                             "pinned": src.is_pinned(), "ms": ms,
                             "gb_per_s": src.numel() / (ms * 1e-3) / 1e9})
    for count in (1, 2, 4, 7, 16):
        ring = [pinned() for _ in range(count)]
        times = []
        for i in range(max(reps, 3 * count)):
            src = ring[i % count]
            np.copyto(src.numpy(), i % 251)
            times.append(timed_copy(src))
        ms = statistics.median(times[count:])  # each buffer's first copy left out
        chip_smoke.emit({"phase": "h2d_rotation", "buffers": count, "ms": ms,
                         "gb_per_s": out.numel() / (ms * 1e-3) / 1e9})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The traced slice: a few steps under ``torch.profiler`` (CPU and CUDA
activity), read back into what the per-layer readers need.

The slice opens with a long device spin and a guard step, then a short
marker spin, the recorded steps, and a second marker: only device events
between the two markers (on the card's own clock) count.  The profiler has
been seen to drop a prefix of a window's device records, so the counted
steps are never the window's first.
"""

from __future__ import annotations

import json
from pathlib import Path

ABSORB_CYCLES = 50_000_000  # about 30 ms on an H100: the guard's lead
MARK_CYCLES = 20_000  # a marker spin, microseconds long

_CLASSES = json.loads((Path(__file__).with_name("kernel_classes.json")).read_text())["classes"]


def kernel_class(name):
    for cls, needles in _CLASSES:
        if any(n in name for n in needles):
            return cls
    return "other"


def _union_seconds(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def _gaps(intervals, lo, hi):
    """Idle stretches ``(start, end)`` in us between ``lo`` and ``hi``."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def _host_at(host, gap):
    """Name of the host operation that covers most of ``gap``."""
    best, name = 0.0, "no host operation"
    for a, b, n in host:
        over = min(b, gap[1]) - max(a, gap[0])
        if over > best:
            best, name = over, n
    return name


def traced_slice(torch, run_step, steps):
    """Run ``steps`` steps under the profiler; returns ``{'steps', 'window_s',
    'busy_s', 'by_class': {class: [seconds, calls]}, 'device_ops': [[name,
    seconds]] (top 10), 'idle_gaps': [[host op, seconds]] (longest 10)}``,
    or None when the profiler kept no device event between the markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(ABSORB_CYCLES)
        run_step()
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(steps):
            run_step()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    marks = sorted((e.time_range.start, e.time_range.end) for e in device
                   if "spin_kernel" in e.name and e.time_range.elapsed_us() < 1e3)
    if len(marks) < 2:
        return None
    lo, hi = marks[-2][1], marks[-1][0]
    inside = [e for e in device if e.time_range.start >= lo and e.time_range.end <= hi
              and kernel_class(e.name) != "marker"]
    if not inside:
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in inside]
    by_class, by_name = {}, {}
    for e in inside:
        s = e.time_range.elapsed_us() / 1e6
        c = by_class.setdefault(kernel_class(e.name), [0.0, 0])
        c[0] += s
        c[1] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + s
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.time_range.end > lo
            and e.time_range.start < hi]
    gaps = sorted(_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "steps": steps,
        "window_s": (hi - lo) / 1e6,
        "busy_s": _union_seconds(spans),
        "by_class": by_class,
        "device_ops": [[n[:160], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_host_at(host, g)[:160], (g[1] - g[0]) / 1e6] for g in gaps],
    }

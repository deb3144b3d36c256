"""One run of one training cell: set-up, the first steps the reference
follows, the measured window, the traced slice, the check.

Set-up makes the weights and the traffic from the seed, builds the
program's train step over them, and drives it through its first
:data:`FIRST_STEPS` steps (its eager warm-ups and its capture among them)
on distinct batches (the configuration's ``program`` module,
``programs/<program>.py``, makes the weights, the step and the
reference), keeping each loss, each leaf's first gradient as the
optimizer holds it after step 1, and each leaf's change after the last of
them.  :data:`SETTLE_STEPS` more replays, then the window: steps for
``seconds`` by the host's clock, a CUDA event recorded after each on the
step's stream, the host kept at most :data:`LEAD` steps ahead of the card
by waiting on an older step's event (never on the newest), and the window
closed by ``torch.cuda.synchronize()``.  With ``trace`` a profiled slice of
:data:`TRACE_STEPS` steps follows.  Then the program's state is freed and
the reference runs the same first steps from the same weights and batches
in float32 on the device.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from portbench.harness import correct as correct_mod
from portbench.harness import profile, traffic as traffic_mod
from portbench.harness.spec import program as load_program

FIRST_STEPS = 3
SETTLE_STEPS = 2
LEAD = 3
TRACE_STEPS = 10
FORBIDDEN = ("jax", "jaxlib", "flax", "blendjax")


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Clock:
    """Step completions: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
            if len(self.marks) > LEAD + 1:
                self.marks[-LEAD - 2].synchronize()
        else:
            self.marks.append(time.perf_counter())

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def intervals_ms(self):
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _first_steps(prog, feed, start):
    losses, grads = [], None
    for i in range(FIRST_STEPS):
        losses.append(prog.step(next(feed)))
        if i == 0:
            grads = prog.first_grads()
    return {"losses": [float(x) for x in losses], "first_grads": grads,
            "grad_norms": correct_mod.norms(grads), "change_norms": prog.change_norms(start)}


def set_up(torch, cfg, traffic, seed, device, fault=None):
    """The weights and the traffic from the seed, the program over them,
    driven through its first steps: ``(program, feed, readings)``."""
    program = load_program(cfg["program"])
    params = program.make_weights(cfg, seed, device)
    start = {k: v.to("cpu", copy=True) for k, v in params.items()}
    feed = traffic_mod.make_feed(torch, traffic, cfg, seed, device)
    prog = program.Program(torch, cfg, traffic, params, device, fault=fault)
    del params
    return prog, feed, _first_steps(prog, feed, start)


def free(torch, prog, feed):
    prog.close()
    feed.close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _window(torch, prog, feed, seconds, device):
    """The measured window."""
    clock = Clock(torch, device)
    clock.sync()
    losses = []
    t0 = time.perf_counter()
    clock.mark()
    while True:
        losses.append(prog.step(next(feed)))
        clock.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    t1 = time.perf_counter()
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    return {"t0": t0, "seconds": t1 - t0, "steps": len(losses),
            "intervals_ms": clock.intervals_ms(), "failed": int((~finite).sum())}


def run(spec, workload, seed, seconds, trace, device="cuda", fault=None, t_start=None,
        overrides=None):
    """One run; returns what :mod:`portbench.run` reports.  ``overrides``
    replaces the cell's ``config`` and ``traffic`` (the tests' small
    sizes)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = spec.cell(workload)
    cfg = (overrides or {}).get("config") or spec.config(cell["config"])
    traffic = (overrides or {}).get("traffic") or spec.traffic(cell["traffic"])
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    phases = {"start": time.perf_counter() - t_start}
    prog, feed, prog_readings = set_up(torch, cfg, traffic, seed, device, fault)
    try:
        phases["first_steps"] = time.perf_counter() - t_start
        for _ in range(SETTLE_STEPS):
            prog.step(next(feed))
        win = _window(torch, prog, feed, seconds, device)
        setup_s = win["t0"] - t_start
        peak_bytes = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        traced = None
        if trace and device.type == "cuda":
            traced = profile.traced_slice(torch, lambda: prog.step(next(feed)), TRACE_STEPS)
        leaked = forbidden_modules()
        first = feed.reference_batches(FIRST_STEPS)
    finally:
        free(torch, prog, feed)
    del prog
    ref = load_program(cfg["program"]).reference_readings(torch, cfg, seed, first, device)
    values = correct_mod.numbers(prog_readings, ref)
    ok, compared = correct_mod.verdict(values, spec.limits(workload))
    ok = ok and win["failed"] == 0
    return {
        "cell": cell, "config": cfg, "traffic": traffic, "window": win, "setup_s": setup_s,
        "peak_bytes": peak_bytes, "traced": traced, "correct": ok, "compared": compared,
        "leaked": leaked, "phases": phases,
    }


def p95(values):
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))

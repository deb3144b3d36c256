#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blendjax_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. card     — ``nvidia-smi``'s name and power limit.
2. kernels  — the hand-written kernels the port has; their library is
              built from ``blendjax_torch/ops/csrc`` into ``build/``, one
              ``nvcc`` per source in parallel (``build`` line).
3. kernel   — the decode kernel against its plain PyTorch version on the
              card (``decode_cases``: the main shape, unaligned bases
              1-15, sizes around the plan's chunk; f32 and bf16, with and
              without ``linearize``), with its max abs error, and
              bit-equal to it wherever ``linearize`` is off; its time at
              the main path's shape in bf16 and f32 beside the bytes it
              moves and the card's bandwidth bound, the timing window's
              own floor, and the kernel's own duration from
              torch.profiler (``kernel_us``).
4. train    — a full-width TinyDetector (channels 32/64/128, hidden 256,
              K=8) takes 8 Adam steps on seeded 8x480x640x3 uint8 batches
              decoded by the kernel inside the loss; the model path is also
              held against the CPU on a small input.
5. stream   — the datagen path through its entry points: 2 producers
              started by ``BlenderLauncher`` (with
              ``tests/helpers/fake_blender.py`` as the Blender executable)
              -> ``RemoteIterableDataset`` -> ``TorchStream`` -> decode
              kernel -> train steps.
6. flash    — the flash-attention forward, dQ and dK/dV kernels against
              their plain passes on the card, case by case (the flagship
              shape in bf16, f32 causal and not, f32 at head dim 128 and
              T=512, GQA, a window, ragged lengths, a q offset, and a bf16
              twin of every f32 case), each with its max abs error, limit
              and route: bf16 takes the tensor-core kernels ("tc"), f32
              the CUDA-core ones ("f32").
7. flash_time — each flash kernel, its plain pass and the library call
              (``scaled_dot_product_attention`` on the fastest of its
              backends, timed as a CUDA graph's replay, for comparison
              only) at the flagship shape, beside its FLOPs, bytes and
              bound; each also on the CUDA-core route (``previous_ms``).
              nvidia-smi samples the SM clock, power and temperature
              beside this window and the decode timing.
8. seqformer — the flagship SeqFormer (8 layers, d_model 1024, 8 heads,
              T=512, batch 8) takes 8 Adam(1e-4) steps through the flash
              kernels on seeded float16 episodes on the card, every
              forward, dQ and dK/dV launch on the tensor-core route, then
              3 more under
              ``torch.profiler`` for the device's busy time and idle share
              per step; a small f32 model is held between card (kernels)
              and CPU (plain passes).
9. worldmodel — the world-model path through its entry points: 2
              ``btb/episodes.blend.py`` producers -> ``RemoteIterableDataset``
              -> ``TorchStream(transform=episode_transform)`` ->
              ``worldmodel.train_on_episodes`` at the flagship sizing.

Every kernel's launch count is zeroed just before the path that runs it
(the datagen stream for the decode kernel, the world-model stream for the
flash kernels) and read just after; a kernel the path never launched fails
the run.  The line before the last holds every kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.  Any failed check exits nonzero
without printing it, as does a host without CUDA or a directory without
the ``blendjax_torch`` package beside this file.

Kernel times are medians of CUDA-event windows with the L2 flushed before
each (``ms``: the flush buffer zeroed, so up to the L2's 50 MB of dirty
lines are written back inside the window; ``ms_clean_l2``: the buffer then
read once, so the L2 holds clean lines and the window only the kernel's
own traffic).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: Published HBM bandwidth, bytes/s, by the card name nvidia-smi prints:
#: H100 SXM5 80GB, 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet).  A
#: card not listed here stops the run until its rate is added.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
#: Published dense bf16 tensor-core rate, FLOP/s, by the same names: H100
#: SXM5 80GB, 989.4 TFLOP/s (NVIDIA H100 Tensor Core GPU data sheet).
BF16_PEAK = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

MAIN_SHAPE = (8, 480, 640, 3)  # examples/datagen: batch 8 of 480x640 RGB
# benchmarks/suite_device.py's flagship SeqFormer: batch 8, 513-step
# episodes (T = 512) of 32 channels, d_model 1024, 8 heads, 8 layers
SEQ = dict(batch=8, seq_len=512, obs_dim=32, d_model=1024, n_heads=8, n_layers=8, lr=1e-4)
FLASH_SHAPE = (SEQ["batch"], SEQ["seq_len"], SEQ["n_heads"],
               SEQ["d_model"] // SEQ["n_heads"])  # (B, T, H, Dh)
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")  # each counted by route too


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def peak_rate(table, name):
    if name not in table:
        raise SystemExit(f"chip_smoke: no peak rate on record for {name!r}")
    return table[name]


#: device cycles (about 0.5 ms) the stream spins before each timed window,
#: so the host has enqueued the timed work before the window opens
HOST_LEAD_CYCLES = 1_000_000


def time_ms(torch, fn, reps=50, flush=None, clean=False):
    """Median CUDA-event time of ``fn`` in ms after warm-up.  ``flush``
    (a large tensor) is rewritten before each launch so the 50 MB L2
    holds none of the inputs, as for a batch just copied in.  The rewrite
    leaves the L2 full of dirty lines, which ``fn`` then writes back inside
    its window; with ``clean`` the buffer is also read once after it is
    zeroed, so the L2 holds clean lines and the window only ``fn``'s own
    traffic.  A device-side spin of :data:`HOST_LEAD_CYCLES` precedes each
    start event, so the window holds the device's time for ``fn`` and not
    the host's path to its launches, up to about 0.5 ms of host work."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            if clean:
                flush.sum()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profiled_us(torch, fn, flush, reps=20):
    """Median device duration in us of the kernels ``fn`` launches, from
    torch.profiler (CUDA activity), with the L2 flushed clean before each
    call as for ``time_ms(clean=True)``: the kernel's own time,
    without the event window's floor.  The flush's own kernels (fill and
    reduce) are left out by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            flush.sum()
            fn()
            torch.cuda.synchronize()
    flush_names = {"zero", "fill", "reduce", "sum"}
    times = sorted(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not any(k in e.name.lower() for k in flush_names))
    return times[len(times) // 2] if times else float("nan")


def graph_replay(torch, fn, stream):
    """``fn`` captured in a CUDA graph on ``stream`` after a warm-up there;
    returns the graph's replay: the same device work, with no host dispatch
    between its kernels."""
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph.replay


SMI_FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")


@contextlib.contextmanager
def smi_window(label):
    """Samples the card's SM clock, power and temperature with nvidia-smi
    about every 0.25 s in a thread while the block runs, then emits each
    field's range over the window."""
    samples, stop = [], threading.Event()
    cmd = ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
           "--format=csv,noheader,nounits"]

    def sample():
        while not stop.is_set():
            out = subprocess.run(cmd, capture_output=True, text=True)
            row = out.stdout.strip().splitlines()[:1]
            if out.returncode == 0 and row:
                samples.append([v.strip() for v in row[0].split(",")])
            stop.wait(0.25)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()
    ranges = {}
    for i, field in enumerate(SMI_FIELDS):
        vals = [float(s[i]) for s in samples
                if len(s) > i and s[i].replace(".", "", 1).isdigit()]
        ranges[field] = [min(vals), max(vals)] if vals else None
    emit({"phase": "smi", "window": label, "samples": len(samples), "ranges": ranges})


def bf16_ulp(torch, ref):
    """One bf16 ulp of each value (8 significant bits)."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def decode_cases(torch, image, g):
    """The decode kernel's checked inputs as ``(label, uint8 tensor)``: the
    main shape and a small odd one, the main shape's flat buffer from each
    base offset 1-15 (unaligned input; the small one's from 1), and flat
    sizes around the plan's chunk (``image.DECODE_CHUNK``)."""
    chunk = image.DECODE_CHUNK
    cases = []
    for shape in (MAIN_SHAPE, (2, 13, 17, 3)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        cases.append((str(shape), x))
        for k in range(1, 16) if shape == MAIN_SHAPE else (1,):
            cases.append((f"{shape}[{k}:]", x.reshape(-1)[k:]))
    flat = torch.randint(0, 256, (132 * chunk + 7,), dtype=torch.uint8, device="cuda",
                         generator=g)
    for size in (1, 17, chunk - 1, chunk + 1, 132 * chunk + 7):
        cases.append((f"n={size}", flat[:size]))
    return cases


def kernel_phase(torch, image, peak):
    g = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for label, inp in decode_cases(torch, image, g):
        results = []
        for dtype in (torch.float32, torch.bfloat16):
            for linearize in (False, True):
                out = image.decode_frames_cuda(inp, dtype, linearize)
                ref = image.decode_frames_plain(inp, dtype, linearize)
                torch.cuda.synchronize()
                check(out.shape == ref.shape and out.dtype == dtype,
                      f"decode {label} shape/dtype")
                err = (out.float() - ref.float()).abs()
                max_err = err.max().item()
                if dtype == torch.float32:
                    limit = 1e-6 if linearize else 1e-7
                    ok = max_err <= limit
                else:
                    limit = "1 bf16 ulp"
                    ok = bool((err <= bf16_ulp(torch, ref)).all())
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                results.append({"dtype": str(dtype), "linearize": linearize,
                                "max_abs_err": max_err, "limit": limit, "ok": ok,
                                "bit_equal": torch.equal(out.view(bits), ref.view(bits))})
                check(ok, f"decode_u8 {label} {dtype} linearize={linearize}")
                # without linearize every step is exact or correctly rounded
                check(linearize or results[-1]["bit_equal"],
                      f"decode_u8 {label} {dtype} bit-equal to the plain decode")
                if label == str(MAIN_SHAPE) and dtype == torch.bfloat16 and not linearize:
                    main_err = max_err
        emit({"phase": "kernel", "kernel": "decode_u8", "case": label,
              "numel": inp.numel(), "results": results})

    x = torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda", generator=g)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def decode():
        return image.decode_frames_cuda(x, torch.bfloat16)

    ms = time_ms(torch, decode, flush=flush)
    ms_clean = time_ms(torch, decode, flush=flush, clean=True)
    plain_ms = time_ms(torch, lambda: image.decode_frames_plain(x, torch.bfloat16),
                       flush=flush)
    # the window's own floor: no work between the events, the same flush
    window_floor_ms = time_ms(torch, lambda: None, flush=flush, clean=True)
    kernel_us = profiled_us(torch, decode, flush)

    # The one library call that computes the same function: uint8 promoted
    # to f32, times f32(1/255), rounded to nearest-even bf16 on the store.
    # Timed for comparison only; the port never calls it.
    def library():
        return torch.mul(x, 1.0 / 255.0,
                         out=torch.empty(x.shape, dtype=torch.bfloat16, device="cuda"))

    check(torch.equal(library().view(torch.int16),
                      image.decode_frames_plain(x, torch.bfloat16).view(torch.int16)),
          "torch.mul library call bit-equal to the plain decode")
    library_ms = time_ms(torch, library, flush=flush)
    library_ms_clean = time_ms(torch, library, flush=flush, clean=True)
    f32_ms = time_ms(torch, lambda: image.decode_frames_cuda(x, torch.float32), flush=flush)
    f32_ms_clean = time_ms(torch, lambda: image.decode_frames_cuda(x, torch.float32),
                           flush=flush, clean=True)
    f32_kernel_us = profiled_us(torch, lambda: image.decode_frames_cuda(x, torch.float32),
                                flush)
    del flush
    nbytes = x.numel() * (1 + 2)  # uint8 read once, bf16 written once
    bound_ms = nbytes / peak * 1e3
    f32_bound_ms = x.numel() * (1 + 4) / peak * 1e3
    rec = {"phase": "kernel_time", "kernel": "decode_u8", "shape": list(MAIN_SHAPE),
           "out": "bfloat16", "bytes_in": x.numel(), "bytes_out": 2 * x.numel(),
           "ms": ms, "ms_clean_l2": ms_clean, "window_floor_ms": window_floor_ms,
           "kernel_us": kernel_us, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_ms_clean_l2": library_ms_clean,
           "library_call": "torch.mul(x, 1/255, out=bf16)",
           "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
           "bound_ms": bound_ms, "hbm_peak_share": bound_ms / ms,
           "hbm_peak_share_clean_l2": bound_ms / ms_clean}
    emit(rec)
    emit({"phase": "kernel_time", "kernel": "decode_u8", "shape": list(MAIN_SHAPE),
          "out": "float32", "ms": f32_ms, "ms_clean_l2": f32_ms_clean,
          "window_floor_ms": window_floor_ms, "kernel_us": f32_kernel_us,
          "bound_ms": f32_bound_ms,
          "hbm_peak_share": f32_bound_ms / f32_ms,
          "hbm_peak_share_clean_l2": f32_bound_ms / f32_ms_clean})
    return {"max_abs_err": main_err, "ms": ms, "ms_clean_l2": ms_clean, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms}


def train_phase(torch, datagen, detector, make_train_step):
    # the model path on the card against the CPU on a small input (float32
    # compute; TF32 is off for this, see main)
    cfg = dict(num_keypoints=2, channels=(8, 16), hidden=32)
    params = detector.init(torch.Generator().manual_seed(0), device="cpu", **cfg)
    xg = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (2, 33, 48, 3), dtype=torch.uint8, generator=xg)
    xy = torch.rand((2, 2, 2), generator=xg)
    loss = datagen.make_loss(torch.float32)
    cpu_loss = loss(params, {"image": u8, "xy": xy}).item()
    gpu_loss = loss({k: v.cuda() for k, v in params.items()},
                    {"image": u8.cuda(), "xy": xy.cuda()}).item()
    emit({"phase": "reference", "cpu_loss": cpu_loss, "cuda_loss": gpu_loss,
          "rtol": 1e-4})
    check(math.isclose(cpu_loss, gpu_loss, rel_tol=1e-4), "small-input loss vs CPU")

    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    dg = torch.Generator(device="cuda").manual_seed(1)
    # fixed targets: the loss must fall within 8 steps
    target = torch.rand((MAIN_SHAPE[0], 8, 2), generator=dg, device="cuda")
    step = make_train_step(datagen.make_loss())
    losses, times = [], []
    for _ in range(8):
        batch = {"image": torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8,
                                        device="cuda", generator=dg),
                 "xy": target}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    emit({"phase": "train", "steps": len(losses), "first_loss": losses[0],
          "last_loss": losses[-1], "losses": losses, "median_step_ms": med,
          "step_ms": times,
          "model_tflop_per_s": detector.train_flops(*MAIN_SHAPE[:3]) / (med * 1e-3) / 1e12})
    check(all(math.isfinite(v) for v in losses), "train losses finite")
    check(losses[-1] < losses[0], "train loss fell")


def _port_pair():
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
    raise SystemExit("chip_smoke: no free port pair")


def _fake_blender():
    os.environ["BLENDJAX_BLENDER"] = os.path.join(REPO, "tests", "helpers",
                                                  "fake_blender.py")


def _stamped(stream, arrivals, check_batch):
    """Pass the stream's batches through, checking each and recording its
    arrival and the time the train loop spent on it ("step")."""
    for batch in stream:
        check_batch(batch)
        arrivals.append(time.perf_counter())
        t0 = time.perf_counter()
        yield batch  # the train step runs while this generator waits
        stream.timer.add("step", time.perf_counter() - t0)


def stream_phase(torch, btt, datagen, image):
    _fake_blender()
    max_items, batch_size = 64, 8
    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    arrivals = []

    def check_batch(batch):
        check(batch["image"].is_cuda and batch["image"].dtype == torch.uint8
              and tuple(batch["image"].shape) == MAIN_SHAPE, "stream batch")

    with btt.BlenderLauncher(scene="", script=str(datagen.SCRIPT), num_instances=2,
                             named_sockets=["DATA"], start_port=_port_pair(),
                             background=True, seed=0) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=max_items,
                                       item_transform=datagen.item_transform)
        with btt.TorchStream(ds, batch_size=batch_size, num_workers=2,
                             device="cuda") as stream:
            image.decode_frames_cuda.launches = 0
            _, losses = datagen.train_on_stream(
                _stamped(stream, arrivals, check_batch), state=state, log_every=0)
            torch.cuda.synchronize()
            end = time.perf_counter()
            launches = image.decode_frames_cuda.launches
    items_after_first = (len(arrivals) - 1) * batch_size
    rec = {"phase": "stream", "batches": len(losses), "items": len(losses) * batch_size,
           "items_per_s": items_after_first / (end - arrivals[0]),
           "median_step_ms": stream.timer.percentiles("step")["p50_ms"],
           "first_loss": losses[0], "last_loss": losses[-1],
           "launches": {"decode_u8": launches}, "timer": stream.timer.summary()}
    emit(rec)
    check(len(losses) == max_items // batch_size, "stream delivered every batch")
    check(all(math.isfinite(v) for v in losses), "stream losses finite")
    check(launches >= 1, "the main path launched decode_u8")
    return launches


# -- flash attention -----------------------------------------------------------

# (label, (B, Tq, H, Dh), h_kv, Tk, dtype, causal, window, q_offset)
FLASH_CASES = [
    ("flagship", FLASH_SHAPE, FLASH_SHAPE[2], FLASH_SHAPE[1], "bfloat16", True, None, 0),
    ("f32 causal", (2, 128, 4, 32), 4, 128, "float32", True, None, 0),
    ("f32 non-causal", (2, 128, 4, 32), 4, 128, "float32", False, None, 0),
    ("gqa 8q/2kv", (2, 128, 8, 32), 2, 128, "float32", True, None, 0),
    ("gqa 8q/2kv bf16 dh128", (2, 128, 8, 128), 2, 128, "bfloat16", True, None, 0),
    ("f32 dh128 T 512", (2, 512, 8, 128), 8, 512, "float32", True, None, 0),
    ("gqa 8q/2kv f32 dh128 T 512", (2, 512, 8, 128), 2, 512, "float32", True, None, 0),
    ("window 48", (2, 128, 4, 32), 4, 128, "float32", True, 48, 0),
    ("T 96", (2, 96, 4, 32), 4, 96, "float32", True, None, 0),
    ("T 17", (2, 17, 4, 32), 4, 17, "float32", True, None, 0),
    ("T 17 non-causal dh16", (2, 17, 4, 16), 4, 17, "float32", False, None, 0),
    ("dh64 bf16 non-causal", (2, 128, 4, 64), 4, 128, "bfloat16", False, None, 0),
    ("q_offset 64, Tk 128", (2, 64, 4, 32), 4, 128, "float32", True, None, 64),
    ("q_offset 128, window 160", (2, 128, 4, 32), 4, 128, "float32", True, 160, 128),
    ("q_offset 256, window 48: no row sees a column", (1, 128, 2, 32), 2, 128,
     "float32", True, 48, 256),
]
# a bf16 twin of every f32 case: the backward's tensor-core route ("tc")
# takes bf16 inputs, its CUDA-core route ("f32") float32 ones
FLASH_CASES += [("bf16 " + c[0].replace("f32 ", ""), *c[1:4], "bfloat16", *c[5:])
                for c in FLASH_CASES if c[4] == "float32"]


#: absolute slack of a bf16 output beside its two ulps (below)
BF16_ATOL = 1e-4


def _compare(torch, got, want, grad, gqa):
    """Max abs error of a kernel output against its plain pass, whether it
    is within its limit, and the limit.  Kernel and plain pass share f32
    arithmetic and differ only in the order of their f32 sums, so an f32
    output (including lse, and dK/dV partials under GQA, from bf16 inputs
    too) is held to tests/test_flash_attention.py's f32 limits (atol =
    rtol: forward 2e-5, gradients 5e-5, GQA gradients 1e-4), and a bf16
    output to BF16_ATOL plus two bf16 ulps of the plain value: one for a
    rounding that falls the other way, one for a binade crossed."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        allowed, limit = BF16_ATOL + 2 * bf16_ulp(torch, want), f"{BF16_ATOL} + 2 bf16 ulps"
    else:
        tol = (1e-4 if gqa else 5e-5) if grad else 2e-5
        allowed, limit = tol + tol * want.float().abs(), f"atol=rtol={tol}"
    ok = bool((err <= allowed).all()) and bool(torch.isfinite(got).all())
    return err.max().item(), ok, limit


def _flash_inputs(torch, g, shape, h_kv, tk, dtype):
    b, t, h, d = shape
    dt = getattr(torch, dtype)

    def rnd(rows, length):
        return torch.randn((rows, length, d), generator=g, device="cuda").to(dt)

    return rnd(b * h, t), rnd(b * h_kv, tk), rnd(b * h_kv, tk), rnd(b * h, t)


def flash_phase(torch, flash):
    """Each kernel against its plain pass on the same card inputs."""
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for label, shape, h_kv, tk, dtype, causal, window, q_offset in FLASH_CASES:
        b, t, h, d = shape
        qf, kf, vf, dof = _flash_inputs(torch, g, shape, h_kv, tk, dtype)
        heads = (h, h_kv) if h != h_kv else None
        kw = dict(window=window, q_offset=q_offset, heads=heads)
        scale = 1.0 / math.sqrt(d)
        of, lse = flash.flash_fwd_plain(qf, kf, vf, causal, scale, **kw)
        delta = (dof.float() * of.float()).sum(-1, keepdim=True)
        gkw = dict(kw, out_dtype=torch.float32 if heads else None)
        bwd = (qf, kf, vf, dof, lse, delta, causal, scale)
        pairs = {  # kernel outputs, plain outputs, gradient?
            "flash_fwd": (flash.flash_fwd_cuda(qf, kf, vf, causal, scale, **kw), (of, lse),
                          False),
            "flash_dq": ((flash.flash_dq_cuda(*bwd, **kw),),
                         (flash.flash_dq_plain(*bwd, **kw),), True),
            "flash_dkv": (flash.flash_dkv_cuda(*bwd, **gkw),
                          flash.flash_dkv_plain(*bwd, **gkw), True),
        }
        torch.cuda.synchronize()
        route = flash.kernel_route(qf.dtype, d)
        for name, (got, want, grad) in pairs.items():
            results = [_compare(torch, a, w, grad, heads is not None)
                       for a, w in zip(got, want)]
            max_err = max(r[0] for r in results)
            ok = all(r[1] for r in results)
            emit({"phase": "flash", "kernel": name, "case": label, "shape": list(shape),
                  "h_kv": h_kv, "tk": tk, "dtype": dtype, "causal": causal,
                  "window": window, "q_offset": q_offset,
                  "route": route, "max_abs_err": max_err,
                  "limit": " / ".join(r[2] for r in results), "ok": ok})
            check(ok, f"{name} {label}")
            if label == "flagship":
                errs[name] = max_err
    _misaligned_check(torch, flash, g)
    return errs


def _misaligned_check(torch, flash, g):
    """bf16 views whose bases sit off TMA's 16-byte alignment give the
    tensor-core kernels' answer (forward, dQ, dK/dV) for aligned copies of
    the same values."""
    qf, kf, vf, dof = _flash_inputs(torch, g, (2, 128, 4, 32), 4, 128, "bfloat16")
    of, lse = flash.flash_fwd_plain(qf, kf, vf, True, 0.25)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)

    def shifted(x):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
        return buf[1:x.numel() + 1].view(x.shape).copy_(x)

    rest = (lse, delta, True, 0.25)
    views = [shifted(x) for x in (qf, kf, vf, dof)]
    check(all(x.data_ptr() % 16 for x in views), "misaligned views")
    got = [*flash.flash_fwd_cuda(*views[:3], True, 0.25), flash.flash_dq_cuda(*views, *rest),
           *flash.flash_dkv_cuda(*views, *rest)]
    want = [*flash.flash_fwd_cuda(qf, kf, vf, True, 0.25),
            flash.flash_dq_cuda(qf, kf, vf, dof, *rest),
            *flash.flash_dkv_cuda(qf, kf, vf, dof, *rest)]
    torch.cuda.synchronize()
    ok = all(torch.equal(a, w) for a, w in zip(got, want))
    emit({"phase": "flash", "kernel": "flash_fwd, flash_dq, flash_dkv",
          "case": "bf16 misaligned bases", "route": "tc",
          "limit": "bit-equal to the aligned inputs", "ok": ok})
    check(ok, "tensor-core forward and backward on misaligned bases")


def _flash_work(b, t, h, d, elt):
    """FLOPs over the causal pairs and the least bytes of each flash kernel
    at (B, T, H, Dh) causal, no window, elt-byte inputs and outputs."""
    pairs = b * h * t * (t + 1) // 2
    tile = b * h * t * d * elt  # one q, k, v, O or dO tensor
    rows = b * h * t * 4  # one f32 lse or delta vector
    return {
        "flash_fwd": (2 * 2 * pairs * d, 3 * tile + tile + rows),  # QK^T, PV
        "flash_dq": (3 * 2 * pairs * d, 4 * tile + 2 * rows + tile),  # QK^T, dOV^T, dSK
        "flash_dkv": (4 * 2 * pairs * d, 4 * tile + 2 * rows + 2 * tile),  # + P^T dO, dS^T Q
    }


LIBRARY_CALLS = {
    "fwd": "F.scaled_dot_product_attention(q, k, v, is_causal=True)",
    "bwd": "torch.autograd.grad of that call (dQ, dK and dV together)",
}
#: SDPA's backends tried for the library call; the fastest one's time is kept
LIBRARY_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def _library_times(torch, qf, kf, vf, dof, flush):
    """The library calls of :data:`LIBRARY_CALLS` on (B, H, T, Dh) views of
    the flat flagship inputs, on each of :data:`LIBRARY_BACKENDS` in turn:
    ``{backend: {"fwd": {"ms", "eager_ms"}, "bwd": {...}}}``, or
    ``{backend: {"error": ...}}`` where it has no kernel for these inputs.
    ``ms`` is a CUDA graph's replay, so host dispatch (autograd's above
    all) falls outside the window, and ``ms_clean_l2`` the same after a
    clean flush (:func:`time_ms`); ``eager_ms`` times the call itself.
    Timed for comparison only: the port never calls them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, t, h, d = FLASH_SHAPE
    q4, k4, v4, do4 = (x.view(b, h, t, d) for x in (qf, kf, vf, dof))
    times = {}
    for name in LIBRARY_BACKENDS:
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q4, k4, v4))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                with torch.cuda.stream(side):  # the backward runs on its forward's stream
                    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
                calls = {
                    "fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                    "bwd": lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                       retain_graph=True),
                }
                eager = {k: time_ms(torch, fn, reps=20, flush=flush) for k, fn in calls.items()}
                replays = {k: graph_replay(torch, fn, side) for k, fn in calls.items()}
        except RuntimeError as exc:  # no kernel of this backend for these inputs
            times[name] = {"error": (str(exc) or type(exc).__name__).splitlines()[0][:200]}
            continue
        torch.cuda.current_stream().wait_stream(side)
        times[name] = {k: {"ms": time_ms(torch, replays[k], reps=20, flush=flush),
                           "ms_clean_l2": time_ms(torch, replays[k], reps=20, flush=flush,
                                                  clean=True),
                           "eager_ms": eager[k]} for k in calls}
    return times


def flash_time_phase(torch, flash, hbm, flops_peak):
    b, t, h, d = FLASH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(1)
    qf, kf, vf, dof = _flash_inputs(torch, g, FLASH_SHAPE, h, t, "bfloat16")
    scale = 1.0 / math.sqrt(d)
    of, lse = flash.flash_fwd_cuda(qf, kf, vf, True, scale)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bwd_args = (qf, kf, vf, dof, lse, delta, True, scale)
    runs = {
        "flash_fwd": (lambda: flash.flash_fwd_cuda(qf, kf, vf, True, scale),
                      lambda: flash.flash_fwd_plain(qf, kf, vf, True, scale)),
        "flash_dq": (lambda: flash.flash_dq_cuda(*bwd_args),
                     lambda: flash.flash_dq_plain(*bwd_args)),
        "flash_dkv": (lambda: flash.flash_dkv_cuda(*bwd_args),
                      lambda: flash.flash_dkv_plain(*bwd_args)),
    }
    library = _library_times(torch, qf, kf, vf, dof, flush)
    ran = {n: r for n, r in library.items() if "error" not in r}
    check(ran, "scaled_dot_product_attention ran on some backend")
    # the earlier kernels, the CUDA-core route, on the same bf16 inputs: the
    # tensor-core kernels' baseline on this card in this run
    previous = {"flash_fwd": lambda: flash.flash_fwd_cuda(qf, kf, vf, True, scale, route="f32"),
                "flash_dq": lambda: flash.flash_dq_cuda(*bwd_args, route="f32"),
                "flash_dkv": lambda: flash.flash_dkv_cuda(*bwd_args, route="f32")}
    work = _flash_work(b, t, h, d, 2)
    timing = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(torch, kernel, reps=20, flush=flush)
        ms_clean = time_ms(torch, kernel, reps=20, flush=flush, clean=True)
        plain_ms = time_ms(torch, plain, reps=10, flush=flush)
        previous_ms = time_ms(torch, previous[name], reps=10, flush=flush)
        flops, nbytes = work[name]
        by_ops, by_bytes = flops / flops_peak * 1e3, nbytes / hbm * 1e3
        lib = "fwd" if name == "flash_fwd" else "bwd"
        best = min(ran, key=lambda n: ran[n][lib]["ms"])
        rec = {"phase": "flash_time", "kernel": name, "shape": list(FLASH_SHAPE),
               "dtype": "bfloat16", "causal": True, "flops": flops, "bytes": nbytes,
               "route": flash.kernel_route(qf.dtype, d),
               "ms": ms, "ms_clean_l2": ms_clean, "previous_ms": previous_ms,
               "previous_route": "f32",
               "plain_ms": plain_ms, "library_ms": ran[best][lib]["ms"],
               "library_ms_clean_l2": ran[best][lib]["ms_clean_l2"],
               "library_call": LIBRARY_CALLS[lib], "library_backend": best,
               "library_backends": {n: r.get(lib, r) for n, r in library.items()},
               "tflop_per_s": flops / (ms * 1e-3) / 1e12,
               "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops > by_bytes else "bytes"}
        rec["bound_share"] = rec["bound_ms"] / ms
        emit(rec)
        timing[name] = rec
    del flush
    return timing


def _zero_flash_counts(flash):
    for name in FLASH_KERNELS:
        fn = getattr(flash, name + "_cuda")
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def _route_counts(flash):
    """The flash kernels' launches by route ("tc", "f32")."""
    return {n: dict(getattr(flash, n + "_cuda").launches_by_route) for n in FLASH_KERNELS}


def _device_profile(torch, run_step, steps, median_ms):
    """``steps`` more train steps under torch.profiler (CUDA activity): the
    device's busy time per step (the sum of its kernel, copy and set
    durations), its idle share of the profiled step and of the median
    unprofiled step, and the flash kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, events = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            events += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    flash_ms = sum(v for n, v in by_name.items() if "bjx_flash" in n)  # K2-K4
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    rec = {"phase": "seqformer_profile", "steps": steps, "device_events": events,
           "wall_ms_per_step": wall_ms, "median_step_ms": median_ms,
           "busy_ms_per_step": busy if events else "not measured",
           "idle_share": 1 - busy / wall_ms if events else None,
           "idle_share_of_median_step": 1 - busy / median_ms if events else None,
           "flash_ms_per_step": flash_ms,
           "flash_share_of_busy": flash_ms / busy if events else None,
           "flash_share_of_step": flash_ms / wall_ms,
           "top_ms_per_step": [[k[:120], v] for k, v in top]}
    emit(rec)


def _episodes(torch, pendulum, rng, batch):
    """Seeded float16 pendulum episodes on the card, (batch, T+1, obs_dim)."""
    ep = pendulum.simulate_episode(rng, batch, SEQ["seq_len"], SEQ["obs_dim"])
    return {"episode": torch.from_numpy(ep).to(torch.float16).cuda()}


def seqformer_phase(torch, seqformer, flash, worldmodel, pendulum, make_train_step,
                    TrainState):
    import functools

    import numpy as np

    # the model path on the card (kernels) against the CPU (plain passes),
    # float32 compute, on a small model: head dim 32, T = 128
    attn = flash.make_flash_attention(causal=True, block_q="auto", block_kv="auto")
    params = seqformer.init(torch.Generator().manual_seed(0), obs_dim=8, d_model=64,
                            n_heads=2, n_layers=2, max_len=128, device="cpu")
    ep = {"episode": torch.from_numpy(pendulum.simulate_episode(
        np.random.default_rng(0), 2, 128)).to(torch.float16)}
    losses = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        losses[dev] = seqformer.episode_loss_fn(
            p, {"episode": ep["episode"].to(dev)}, attn_fn=attn,
            compute_dtype=torch.float32).item()
    emit({"phase": "seqformer_reference", "cpu_loss": losses["cpu"],
          "cuda_loss": losses["cuda"], "rtol": 2e-4})
    check(math.isclose(losses["cpu"], losses["cuda"], rel_tol=2e-4),
          "small SeqFormer loss: card vs CPU")

    cfg = {k: SEQ[k] for k in ("obs_dim", "d_model", "n_heads", "n_layers")}
    params = seqformer.init(torch.Generator(device="cuda").manual_seed(0),
                            max_len=SEQ["seq_len"], device="cuda", **cfg)
    state = TrainState.create(params, lr=SEQ["lr"])
    step = make_train_step(functools.partial(
        seqformer.episode_loss_fn, attn_fn=worldmodel.make_attn("flash", SEQ["seq_len"])))
    rng = np.random.default_rng(0)
    batches = [_episodes(torch, pendulum, rng, SEQ["batch"]) for _ in range(8)]
    _zero_flash_counts(flash)
    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {n: getattr(flash, n + "_cuda").launches / len(batches)
                for n in FLASH_KERNELS}
    routes = _route_counts(flash)
    med = statistics.median(times)

    more = iter(batches)

    def profiled_step():
        nonlocal state
        state, loss = step(state, next(more))
        float(loss)  # waits for the step, as in the timed steps

    _device_profile(torch, profiled_step, 3, med)
    flops = seqformer.train_flops(SEQ["batch"], SEQ["seq_len"], **cfg)
    emit({"phase": "seqformer", "config": SEQ, "params": sum(v.numel() for v in params.values()),
          "steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
          "losses": losses, "median_step_ms": med, "step_ms": times,
          "train_flops": flops,
          "model_tflop_per_s": flops / (med * 1e-3) / 1e12,
          "model_tflop_per_s_note": "train_flops counts attention over the full T^2",
          "launches_per_step": launches, "launches_by_route": routes,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(all(math.isfinite(v) for v in losses), "seqformer losses finite")
    check(losses[-1] < losses[0], "seqformer loss fell")
    check(all(n == SEQ["n_layers"] for n in launches.values()),
          "one launch of each flash kernel per layer and step")
    check(all(r == {"tc": SEQ["n_layers"] * len(batches), "f32": 0} for r in routes.values()),
          "every flagship forward, dQ and dK/dV launch took the tensor-core route")


def worldmodel_phase(torch, btt, worldmodel, flash):
    _fake_blender()
    batches, batch_size = 16, SEQ["batch"]
    args = ["--seq-len", str(SEQ["seq_len"] + 1), "--obs-dim", str(SEQ["obs_dim"])]
    shape = (batch_size, SEQ["seq_len"] + 1, SEQ["obs_dim"])
    arrivals = []

    def check_batch(batch):
        check(batch["episode"].is_cuda and batch["episode"].dtype == torch.float16
              and tuple(batch["episode"].shape) == shape, "episode batch")

    attn = worldmodel.make_attn("flash", SEQ["seq_len"])
    sizing = {k: SEQ[k] for k in ("d_model", "n_heads", "n_layers", "obs_dim", "seq_len",
                                  "lr")}
    with btt.BlenderLauncher(scene="", script=str(worldmodel.SCRIPT), num_instances=2,
                             named_sockets=["DATA"], start_port=_port_pair(),
                             background=True, seed=0, instance_args=[args, args]) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=batches * batch_size)
        with btt.TorchStream(ds, batch_size=batch_size, num_workers=2, device="cuda",
                             transform=worldmodel.episode_transform) as stream:
            _zero_flash_counts(flash)
            _, losses = worldmodel.train_on_episodes(
                _stamped(stream, arrivals, check_batch), attn=attn, log_every=0,
                **sizing)
            torch.cuda.synchronize()
            end = time.perf_counter()
            launches = {n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS}
            routes = _route_counts(flash)
    items_after_first = (len(arrivals) - 1) * batch_size
    emit({"phase": "worldmodel", "batches": len(losses), "items": len(losses) * batch_size,
          "items_per_s": items_after_first / (end - arrivals[0]),
          "median_step_ms": stream.timer.percentiles("step")["p50_ms"],
          "first_loss": losses[0], "last_loss": losses[-1],
          "launches": launches, "launches_by_route": routes,
          "timer": stream.timer.summary()})
    check(len(losses) == batches, "worldmodel stream delivered every batch")
    check(all(math.isfinite(v) for v in losses), "worldmodel losses finite")
    for name, n in launches.items():
        check(n >= 1, f"the world-model path launched {name}")
    for name, r in routes.items():
        check(r == {"tc": launches[name], "f32": 0},
              f"every world-model {name} launch took the tensor-core route")
    return launches, routes


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from blendjax_torch import btt, datagen, worldmodel
    from blendjax_torch.btb import pendulum
    from blendjax_torch.models import detector, seqformer
    from blendjax_torch.models.train import TrainState, make_train_step
    from blendjax_torch.ops import _build, image
    from blendjax_torch.ops import flash_attention as flash

    # full float32 for the float32 checks (cuDNN would take TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"card": card})
    emit({"kernels": ["decode_u8"] + list(FLASH_KERNELS)})
    name = card.split(",")[0]
    hbm, flops_peak = peak_rate(HBM_PEAK, name), peak_rate(BF16_PEAK, name)
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "sources": _build.SOURCES, "seconds": time.perf_counter() - t0})

    with smi_window("kernel"):
        timing = kernel_phase(torch, image, hbm)
    train_phase(torch, datagen, detector, make_train_step)
    decode_launches = stream_phase(torch, btt, datagen, image)
    flash_errs = flash_phase(torch, flash)
    with smi_window("flash_time"):
        flash_timing = flash_time_phase(torch, flash, hbm, flops_peak)
    seqformer_phase(torch, seqformer, flash, worldmodel, pendulum, make_train_step,
                    TrainState)
    flash_launches, flash_routes = worldmodel_phase(torch, btt, worldmodel, flash)

    kernels = [{
        "name": "decode_u8", "route": "cuda",
        "source": "blendjax_torch/ops/csrc/decode.cu",
        "replaces": "blendjax/ops/image.py:69",
        "launches": decode_launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes",
        "library_ms": timing["library_ms"], "ms_clean_l2": timing["ms_clean_l2"],
    }]
    # the flagship's bf16 inputs run the tensor-core kernels; f32 inputs
    # take the CUDA-core ones, whose time on these bf16 inputs is previous_ms
    replaces = {"flash_fwd": ("flash_fwd_tc.cu", "flash_fwd.cu", 203),
                "flash_dq": ("flash_bwd_tc.cu", "flash_bwd.cu", 257),
                "flash_dkv": ("flash_bwd_tc.cu", "flash_bwd.cu", 296)}
    for kname, (src, previous_src, line) in replaces.items():
        rec = flash_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"blendjax_torch/ops/csrc/{src}",
            "replaces": f"blendjax/ops/flash_attention.py:{line}",
            "launches": flash_launches[kname], "max_abs_err": flash_errs[kname],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "ms_clean_l2": rec["ms_clean_l2"], "launches_by_route": flash_routes[kname],
            "previous_ms": rec["previous_ms"],
            "previous_source": f"blendjax_torch/ops/csrc/{previous_src}",
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

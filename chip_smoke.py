#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blendjax_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. card     — ``nvidia-smi``'s name and power limit.
2. kernels  — the hand-written kernels the port has.
3. kernel   — every kernel against its plain PyTorch version on the card,
              with its max abs error, and its time at the main path's shape
              beside the bytes it moves and the card's bandwidth bound.
4. train    — a full-width TinyDetector (channels 32/64/128, hidden 256,
              K=8) takes 8 Adam steps on seeded 8x480x640x3 uint8 batches
              decoded by the kernel inside the loss; the model path is also
              held against the CPU on a small input.
5. stream   — the main path through its entry points: 2 producers started
              by ``BlenderLauncher`` (with ``tests/helpers/fake_blender.py``
              as the Blender executable) -> ``RemoteIterableDataset`` ->
              ``TorchStream`` -> decode kernel -> train steps.  Every
              kernel's launch count is zeroed just before and read just
              after; a kernel the path never launched fails the run.

The line before the last holds every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero without
printing it, as does a host without CUDA or a directory without the
``blendjax_torch`` package beside this file.  The kernels are built from
``blendjax_torch/ops/csrc`` into ``build/`` at first use.
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: Published HBM bandwidth, bytes/s, by the card name nvidia-smi prints:
#: H100 SXM5 80GB, 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet).  A
#: card not listed here stops the run until its rate is added.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

MAIN_SHAPE = (8, 480, 640, 3)  # examples/datagen: batch 8 of 480x640 RGB


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def hbm_peak(name):
    if name not in HBM_PEAK:
        raise SystemExit(f"chip_smoke: no HBM bandwidth on record for {name!r}")
    return HBM_PEAK[name]


def time_ms(torch, fn, reps=50, flush=None):
    """Median CUDA-event time of ``fn`` in ms after warm-up.  ``flush``
    (a large tensor) is rewritten before each launch so the 50 MB L2
    holds none of the inputs, as for a batch just copied in."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bf16_ulp(torch, ref):
    """One bf16 ulp of each value (8 significant bits)."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_phase(torch, image, peak):
    g = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for shape in (MAIN_SHAPE, (2, 13, 17, 3)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        # the flat buffer from byte 1 on: base pointer not 16-byte aligned
        for inp, label in ((x, str(shape)), (x.reshape(-1)[1:], f"{shape}[1:]")):
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
                    emit({"phase": "kernel", "kernel": "decode_u8", "case": label,
                          "dtype": str(dtype), "linearize": linearize,
                          "max_abs_err": max_err, "limit": limit, "ok": ok})
                    check(ok, f"decode_u8 {label} {dtype} linearize={linearize}")
                    if (label == str(MAIN_SHAPE) and dtype == torch.bfloat16
                            and not linearize):
                        main_err = max_err

    x = torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda", generator=g)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: image.decode_frames_cuda(x, torch.bfloat16), flush=flush)
    plain_ms = time_ms(torch, lambda: image.decode_frames_plain(x, torch.bfloat16),
                       flush=flush)

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
    del flush
    nbytes = x.numel() * (1 + 2)  # uint8 read once, bf16 written once
    bound_ms = nbytes / peak * 1e3
    rec = {"phase": "kernel_time", "kernel": "decode_u8", "shape": list(MAIN_SHAPE),
           "out": "bfloat16", "bytes_in": x.numel(), "bytes_out": 2 * x.numel(),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "torch.mul(x, 1/255, out=bf16)",
           "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
           "bound_ms": bound_ms, "hbm_peak_share": bound_ms / ms}
    emit(rec)
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
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


def stream_phase(torch, btt, datagen, image):
    os.environ["BLENDJAX_BLENDER"] = os.path.join(REPO, "tests", "helpers",
                                                  "fake_blender.py")
    max_items, batch_size = 64, 8
    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    arrivals = []

    def stamped(stream):
        for batch in stream:
            check(batch["image"].is_cuda and batch["image"].dtype == torch.uint8
                  and tuple(batch["image"].shape) == MAIN_SHAPE, "stream batch")
            arrivals.append(time.perf_counter())
            t0 = time.perf_counter()
            yield batch  # the train step runs while this generator waits
            stream.timer.add("step", time.perf_counter() - t0)

    with btt.BlenderLauncher(scene="", script=str(datagen.SCRIPT), num_instances=2,
                             named_sockets=["DATA"], start_port=_port_pair(),
                             background=True, seed=0) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=max_items,
                                       item_transform=datagen.item_transform)
        with btt.TorchStream(ds, batch_size=batch_size, num_workers=2,
                             device="cuda") as stream:
            image.decode_frames_cuda.launches = 0
            _, losses = datagen.train_on_stream(stamped(stream), state=state,
                                                log_every=0)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from blendjax_torch import btt, datagen
    from blendjax_torch.models import detector
    from blendjax_torch.models.train import make_train_step
    from blendjax_torch.ops import image

    # full float32 for the float32 checks (cuDNN would take TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"card": card})
    emit({"kernels": ["decode_u8"]})

    timing = kernel_phase(torch, image, hbm_peak(card.split(",")[0]))
    train_phase(torch, datagen, detector, make_train_step)
    launches = stream_phase(torch, btt, datagen, image)

    emit({"kernels": [{
        "name": "decode_u8", "route": "cuda",
        "source": "blendjax_torch/ops/csrc/decode.cu",
        "replaces": "blendjax/ops/image.py:69",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes",
        "library_ms": timing["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

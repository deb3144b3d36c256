"""Supervised data generation + training on the card: producers stream
frames, the port's feed stages them onto the GPU, the CUDA kernel decodes
them inside the loss and a TinyDetector trains on them.  The counterpart
of ``examples/datagen/generate.py``.

Modes::

    python -m blendjax_torch.datagen                  # live stream -> train
    python -m blendjax_torch.datagen --record prefix  # ... and record .btr
    python -m blendjax_torch.datagen --replay prefix  # no Blender: replay
    python -m blendjax_torch.datagen --infer-int8     # ... then int8 inference

The producer is :file:`btb/cube.blend.py` (a randomly rotated cube
rendered offscreen, its corners as keypoints); point ``$BLENDJAX_BLENDER``
at a Blender, or at ``tests/helpers/fake_blender.py`` with
``BLENDJAX_FAKE_BPY=1`` and ``--background``.  :data:`FRAMES_SCRIPT`
(:file:`btb/frames.blend.py`, seeded synthetic frames in the same schema,
no ``bpy``) stands in for it where the feed and the trainer are what is
being measured.  The training loop is :func:`train_on_stream`, usable
with any iterator of device batches.

Data-parallel ranks: started as ``torchrun --nproc-per-node N -m
blendjax_torch.datagen ...`` (or with ``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT`` set by hand), each rank joins a gloo
process group (ranks may share one card, which NCCL refuses), launches
its own producers and streams its ``shard=(rank, N)`` of their items as
DTensors sharded over a ``data_mesh()``, and the replicated detector
trains on the global batch, as ``generate.py`` shards its stream over a
data mesh.  One rank keeps the single-device path.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from blendjax_torch.models import detector
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.ops.image import decode_frames
from blendjax_torch.utils.device import resolve_device

SCRIPT = Path(__file__).parent / "btb" / "cube.blend.py"
FRAMES_SCRIPT = Path(__file__).parent / "btb" / "frames.blend.py"
IMAGE_HW = (480, 640)


def item_transform(item):
    """Producer message -> training sample: keep the image uint8 (the
    decode happens on the card) and normalize keypoints to [0,1].  Works
    on a collated batch too (the batch axis broadcasts): as a stream's
    batch-level ``transform=`` it leaves the dataset without a per-item
    transform, so the arena path stays engaged."""
    h, w = IMAGE_HW
    return {
        "image": item["image"],
        "xy": (item["xy"] / np.array([w, h], np.float32)).astype(np.float32),
    }


def make_state(generator, num_keypoints=8, in_channels=3, device="cuda", **kwargs):
    """Fresh TinyDetector params from ``generator`` under Adam(1e-3)."""
    params = detector.init(generator, num_keypoints=num_keypoints,
                           in_channels=in_channels, device=device, **kwargs)
    return TrainState.create(params)


def make_loss(dtype=torch.bfloat16):
    """The detector loss with the uint8 decode inside it: the train step's
    input is the uint8 batch.  ``dtype`` is both the decode's output and
    the compute dtype (bf16 on the main path, float32 for parity runs)."""

    def loss_with_decode(params, batch):
        images = decode_frames(batch["image"], dtype=dtype)
        return detector.loss_fn(params, {"image": images, "xy": batch["xy"]},
                                compute_dtype=dtype)

    return loss_with_decode


def train_on_stream(batches, state=None, log_every=8, dtype=torch.bfloat16,
                    device="cuda", mesh=None):
    """Train TinyDetector over an iterator of device batches; returns
    ``(state, losses)``.  Without ``state``, params come from a generator
    seeded 0 on ``device``.  With ``mesh`` the batches are DTensors sharded
    over it (``TorchStream(sharding=data_sharding(mesh))``): the params are
    replicated over the mesh and the step is
    :func:`~blendjax_torch.parallel.sharding.make_sharded_train_step`'s
    (eager)."""
    if mesh is not None:
        from blendjax_torch.parallel.sharding import make_sharded_train_step

        init_sharded, step = make_sharded_train_step(make_loss(dtype), mesh)
        if state is None:
            gen = torch.Generator(device=mesh.device_type).manual_seed(0)
            state = init_sharded(detector.init(gen, device=mesh.device_type))
    else:
        if state is None:
            device = resolve_device(device)
            state = make_state(torch.Generator(device=device).manual_seed(0),
                               device=device)
        step = make_train_step(make_loss(dtype))
    losses = []
    for i, batch in enumerate(batches):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            print(f"batch {i + 1}: loss {np.mean(losses[-log_every:]):.5f}")
    return state, losses


def infer_int8(state, raw_frames):
    """w8a8 inference on a trained detector: quantize once
    (:func:`blendjax_torch.ops.quant.quantize_detector`), decode the uint8
    frames to f32 (the decode kernel on the card) and run the int8
    forward.  Returns (N, K, 2) keypoints."""
    from blendjax_torch.ops.quant import detector_apply_int8, quantize_detector

    with torch.no_grad():
        qparams = quantize_detector({k: v.detach() for k, v in state.params.items()})
        images = decode_frames(raw_frames, dtype=torch.float32)
        return detector_apply_int8(qparams, images)


def _data_parallel():
    """``(mesh, rank, world)``: a data mesh over the ranks when the process
    group holds more than one (joined here, over gloo, when
    ``WORLD_SIZE`` > 1 names one), else ``(None, 0, 1)``."""
    import torch.distributed as dist

    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo")
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None, 0, 1
    from blendjax_torch.parallel.mesh import data_mesh

    return data_mesh(), dist.get_rank(), dist.get_world_size()


def main():
    from blendjax_torch import btt
    from blendjax_torch.btt.collate import collate
    from blendjax_torch.btt.prefetch import device_prefetch

    ap = argparse.ArgumentParser()
    ap.add_argument("--record", metavar="PREFIX", help="record while streaming")
    ap.add_argument("--replay", metavar="PREFIX", help="replay recordings (no Blender)")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--background", action="store_true",
                    help="run Blender headless")
    ap.add_argument("--infer-int8", action="store_true",
                    help="after training, run one quantized (w8a8) inference batch "
                         "on the live stream")
    args = ap.parse_args()

    mesh, rank, world = _data_parallel()
    sharding = None
    if mesh is not None:
        from blendjax_torch.parallel.mesh import data_sharding

        sharding = data_sharding(mesh)

    if args.replay:
        ds = btt.FileDataset(args.replay, item_transform=item_transform)

        def batches():
            idx = np.random.default_rng(0).permutation(len(ds))
            for s in range(0, len(ds) - args.batch + 1, args.batch):
                yield collate([ds[int(i)] for i in idx[s : s + args.batch]])

        train_on_stream(device_prefetch(batches()))
        return

    with btt.BlenderLauncher(
        scene="",
        script=str(SCRIPT),
        num_instances=args.instances,
        named_sockets=["DATA"],
        background=args.background,
        # each rank launches its own producers, on ports of its own
        start_port=11000 + rank * args.instances,
    ) as bl:
        ds = btt.RemoteIterableDataset(
            bl.launch_info.addresses["DATA"],
            max_items=args.items,
            item_transform=item_transform,
            record_path_prefix=args.record,
        )
        with btt.TorchStream(ds, batch_size=args.batch, num_workers=args.workers,
                             sharding=sharding, shard=(rank, world)) as stream:
            it = iter(stream)
            # the inference batch is held back before training, which
            # drains the finite stream
            hold = next(it, None) if args.infer_int8 else None
            state, _ = train_on_stream(it, mesh=mesh)
            if hold is not None:
                frames = hold["image"]
                if mesh is not None:
                    # each rank infers on its own held-back rows; the
                    # data-parallel params replicate, so their local
                    # tensors are whole
                    state = dataclasses.replace(
                        state, params={k: v.to_local() for k, v in state.params.items()})
                    frames = frames.to_local()
                xy = infer_int8(state, frames)
                print(f"int8 inference: {xy.shape[0]} frames -> keypoints "
                      f"{tuple(xy.shape[1:])}")
            elif args.infer_int8:
                print("int8 inference SKIPPED: stream yielded no batch")
        print("stage timing:", stream.timer.summary())


if __name__ == "__main__":
    main()

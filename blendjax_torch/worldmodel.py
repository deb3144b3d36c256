"""SeqFormer world-model training on streamed episodes, on the card: the
counterpart of ``examples/worldmodel/train_worldmodel.py``'s single-device
path.

    python -m blendjax_torch.worldmodel                 # full attention
    python -m blendjax_torch.worldmodel --attn flash    # the flash kernels

Producers (:file:`btb/episodes.blend.py`, seeded pendulum episodes) stream
episodes; the feed casts each batch to float16 on the host
(:func:`episode_transform`), stages it onto the card, and the obs/target
views are sliced on the device.  Point ``$BLENDJAX_BLENDER`` at a Blender,
or at ``tests/helpers/fake_blender.py``.  The training loop is
:func:`train_on_episodes`, usable with any iterator of device batches.
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

import numpy as np
import torch

from blendjax_torch.btb.pendulum import simulate_episode as _simulate
from blendjax_torch.models import seqformer
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.utils.device import resolve_device

SCRIPT = Path(__file__).parent / "btb" / "episodes.blend.py"
T = 64
OBS_DIM = 8

SINGLE_ATTN = ("full", "flash")
PARALLEL_ATTN = ("ring", "ring_flash", "zigzag_flash", "ulysses", "ulysses_flash")
#: options of the reference example that this port does not have yet, and
#: the ROADMAP queue item that ports them
NOT_PORTED = {
    "--mesh": "the sharded path waits for the parallel layer (ROADMAP Queue 1, item 7)",
    "--dream": "rollout/decode_step wait for the serving adapters (ROADMAP Queue 1, item 5)",
    "--dream-int8": "rollout and int8 quantization wait for the serving adapters "
                    "(ROADMAP Queue 1, item 5)",
}


def episode_transform(batch):
    """Collated producer batch -> wire-efficient episode batch (f16)."""
    return {"episode": batch["obs_seq"].astype(np.float16)}


def make_attn(name, seq_len, window=None):
    """Single-device attention for ``--attn``: None (the model's default
    full attention), windowed full attention, or the flash kernels tiled
    for ``seq_len``.  Parallel scheme names are rejected."""
    if name == "full":
        if window is None:
            return None
        from blendjax_torch.parallel.ring_attention import full_attention

        def windowed_full(q, k, v):
            return full_attention(q, k, v, causal=True, window=window)

        return windowed_full
    if name != "flash":
        raise ValueError(
            f"--attn {name} is a parallel scheme; the sharded path is not "
            "ported yet (ROADMAP Queue 1, item 7; single-device options: "
            "full, flash)"
        )
    from blendjax_torch.ops.flash_attention import flash_block_size, make_flash_attention

    blk = flash_block_size(seq_len)
    return make_flash_attention(causal=True, block_q=blk, block_kv=blk, window=window)


def train_on_episodes(batches, state=None, attn=None, d_model=128, n_heads=4,
                      n_layers=2, log_every=8, pos_encoding="learned", obs_dim=OBS_DIM,
                      seq_len=T, lr=3e-4, device="cuda"):
    """Train the SeqFormer over an iterator of device episode batches
    ``{'episode': (B, seq_len + 1, obs_dim)}``; returns ``(state,
    losses)``.  Without ``state``, params come from a generator seeded 0
    on ``device``, under Adam(``lr``)."""
    if state is None:
        device = resolve_device(device)
        params = seqformer.init(
            torch.Generator(device=device).manual_seed(0), obs_dim=obs_dim,
            d_model=d_model, n_heads=n_heads, n_layers=n_layers, max_len=seq_len,
            pos_encoding=pos_encoding, device=device,
        )
        state = TrainState.create(params, lr=lr)
    loss_fn = seqformer.episode_loss_fn
    if attn is not None:
        loss_fn = functools.partial(loss_fn, attn_fn=attn)
    step = make_train_step(loss_fn)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            print(f"batch {i + 1}: loss {losses[-1]:.5f}")
    return state, losses


def simulate_episode(rng, batch, T_steps=None, obs_dim=OBS_DIM):
    """Host-side pendulum episodes with the producer's dynamics, (batch,
    T_steps + 1, obs_dim) float32: held-out data without a fleet."""
    return _simulate(rng, batch, T_steps or T, obs_dim)


def main(argv=None):
    from blendjax_torch import btt

    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--attn", default="full", choices=list(SINGLE_ATTN) + list(PARALLEL_ATTN))
    ap.add_argument("--pos", choices=["learned", "rope"], default="learned",
                    help="position encoding")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window attention width (causal)")
    for flag, why in NOT_PORTED.items():
        ap.add_argument(flag, nargs="?", const="", help=f"not ported: {why}")
    args = ap.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            sys.exit(f"{flag}: {why}")

    try:
        attn_fn = make_attn(args.attn, T, window=args.window)
    except ValueError as exc:
        sys.exit(str(exc))
    with btt.BlenderLauncher(scene="", script=str(SCRIPT), num_instances=args.instances,
                             named_sockets=["DATA"], background=True) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=args.batches * args.batch)
        with btt.TorchStream(ds, batch_size=args.batch, num_workers=args.instances,
                             transform=episode_transform) as stream:
            _, losses = train_on_episodes(stream, attn=attn_fn, pos_encoding=args.pos)
    print(f"trained {len(losses)} batches; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    print("stage timing:", stream.timer.summary())


if __name__ == "__main__":
    main()

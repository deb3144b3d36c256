"""SeqFormer world-model training on streamed episodes, on the card: the
counterpart of ``examples/worldmodel/train_worldmodel.py``'s single-device
path.

    python -m blendjax_torch.worldmodel                 # full attention
    python -m blendjax_torch.worldmodel --attn flash    # the flash kernels
    python -m blendjax_torch.worldmodel --dream 32      # ... then dream

Producers (:file:`btb/episodes.blend.py`, seeded pendulum episodes) stream
episodes; the feed casts each batch to float16 on the host
(:func:`episode_transform`), stages it onto the card, and the obs/target
views are sliced on the device.  Point ``$BLENDJAX_BLENDER`` at a Blender,
or at ``tests/helpers/fake_blender.py``.  The training loop is
:func:`train_on_episodes`, usable with any iterator of device batches;
``--dream N`` then rolls the trained model forward open-loop from a
held-out episode's prefix (:func:`dream`, the KV-cache rollout), in int8
with ``--dream-int8``.
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
    "--mesh": "the sequence-sharded path waits for ring attention (ROADMAP Queue 1, "
              "item 7, part 7c: make_seqformer_train_step)",
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
            f"--attn {name} is a parallel scheme; the sequence-sharded path "
            "is not ported yet (ROADMAP Queue 1, item 7, part 7c; "
            "single-device options: full, flash)"
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


def dream(state, episode, prefix_len, n_steps, window=None, int8=False):
    """Roll the trained world model forward without the simulator: feed
    ``prefix_len`` real observations of ``episode`` (B, T, D), then its own
    predictions for ``n_steps`` (:func:`seqformer.rollout`, f32 compute;
    ``int8`` quantizes the params first).  Returns (predicted (B, n_steps,
    D) on the params' device, open-loop MSE against the real
    continuation)."""
    params = {k: v.detach() for k, v in state.params.items()}
    if int8:
        from blendjax_torch.ops.quant import quantize_seqformer

        params = quantize_seqformer(params)
    device = next(iter(params.values())).device
    episode = torch.as_tensor(np.asarray(episode, np.float32), device=device)
    with torch.no_grad():
        preds = seqformer.rollout(params, episode[:, :prefix_len], n_steps,
                                  compute_dtype=torch.float32, window=window)
    real = episode[:, prefix_len:prefix_len + n_steps]
    return preds, float(torch.mean((preds - real) ** 2))


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
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and dreams (default: the card)")
    ap.add_argument("--start-port", type=int, default=11000,
                    help="the producers' first DATA port")
    ap.add_argument("--dream", type=int, default=0,
                    help="after training, roll the model forward this many steps "
                         "open-loop from a held-out episode prefix and report the "
                         "MSE against the real continuation")
    ap.add_argument("--dream-int8", action="store_true",
                    help="quantize the trained model (w8a8) before dreaming")
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
                             named_sockets=["DATA"], background=True,
                             start_port=args.start_port) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=args.batches * args.batch)
        with btt.TorchStream(ds, batch_size=args.batch, num_workers=args.instances,
                             transform=episode_transform, device=args.device) as stream:
            state, losses = train_on_episodes(stream, attn=attn_fn, pos_encoding=args.pos,
                                              device=args.device)
    print(f"trained {len(losses)} batches; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    print("stage timing:", stream.timer.summary())
    if args.dream > 0:
        prefix_len = T // 2
        # rope has no table bound: the requested horizon is honoured
        n_steps = args.dream if args.pos == "rope" else min(args.dream, T - prefix_len)
        # a fresh episode the model never saw, with the producers' dynamics
        episode = simulate_episode(np.random.default_rng(123), batch=2,
                                   T_steps=prefix_len + n_steps)
        _, mse = dream(state, episode, prefix_len, n_steps, window=args.window,
                       int8=args.dream_int8)
        print(f"dream: {n_steps} open-loop steps from a {prefix_len}-step prefix, "
              f"MSE vs real continuation {mse:.5f}")


if __name__ == "__main__":
    main()

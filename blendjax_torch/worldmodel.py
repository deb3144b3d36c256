"""SeqFormer world-model training on streamed episodes, on the card: the
counterpart of ``examples/worldmodel/train_worldmodel.py``.

    python -m blendjax_torch.worldmodel                 # full attention
    python -m blendjax_torch.worldmodel --attn flash    # the flash kernels
    python -m blendjax_torch.worldmodel --dream 32      # ... then dream
    torchrun --nproc-per-node 2 -m blendjax_torch.worldmodel --mesh 1,2,1
                                                        # ring_flash, 2 ranks

Producers (:file:`btb/episodes.blend.py`, seeded pendulum episodes) stream
episodes; the feed casts each batch to float16 on the host
(:func:`episode_transform`), stages it onto the card, and the obs/target
views are sliced on the device.  Point ``$BLENDJAX_BLENDER`` at a Blender,
or at ``tests/helpers/fake_blender.py``.  The training loop is
:func:`train_on_episodes`, usable with any iterator of device batches;
``--dream N`` then rolls the trained model forward open-loop from a
held-out episode's prefix (:func:`dream`, the KV-cache rollout), in int8
with ``--dream-int8``.

``--mesh dp,sp,tp`` trains dp x sp x tp over that many ranks (a torchrun
world, joined over gloo: ranks that share one card cannot use NCCL) with a
parallel ``--attn`` (``ring_flash`` by default;
:func:`make_sharded_trainer`).  The first rank of each data group (its
``'seq'`` and ``'model'`` index 0) launches the producers and streams that
group's rows; it broadcasts each batch to the rest of its group, and each
rank trains on its sequence shard (:func:`mesh_batches`).
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
            f"--attn {name} is a parallel scheme; pass --mesh dp,sp,tp "
            "to use it (single-device options: full, flash)"
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


def sharded_transform(batch):
    """Host-side transform for the mesh path: the episode split into the
    obs/target views the sharded step trains on (an episode's T+1 steps do
    not divide the seq axis; the T-step views do)."""
    ep = batch["obs_seq"].astype(np.float32)
    return {"obs": ep[:, :-1], "target": ep[:, 1:]}


def make_sharded_trainer(mesh_shape, attn_impl, d_model=128, n_heads=4, n_layers=2,
                         window=None, pos_encoding="learned", device="cuda"):
    """``(state, step, batch_sharding)`` for dp x sp x tp training over the
    ranks of the initialised process group: the mesh ``{'data': dp, 'seq':
    sp, 'model': tp}``, the SeqFormer's params from a generator seeded 0
    (the same on every rank), and
    :func:`~blendjax_torch.parallel.sharding.make_seqformer_train_step`
    under Adam(3e-4)."""
    from blendjax_torch.parallel import make_mesh, make_seqformer_train_step

    dp, sp, tp = mesh_shape
    mesh = make_mesh({"data": dp, "seq": sp, "model": tp}, device=device)
    device = resolve_device(device)
    params = seqformer.init(
        torch.Generator(device=device).manual_seed(0), obs_dim=OBS_DIM, d_model=d_model,
        n_heads=n_heads, n_layers=n_layers, max_len=T, pos_encoding=pos_encoding,
        device=device)
    init_sharded, step, batch_sharding = make_seqformer_train_step(
        mesh, lr=3e-4, attn_impl=attn_impl, attn_window=window)
    return init_sharded(params), step, batch_sharding


def mesh_batches(host_batches, sharding):
    """Each rank's device batches of the mesh path.  ``host_batches``
    iterates the data group's host batches (``{'obs', 'target'}`` numpy,
    ``(B/dp, T, D)``) on the group's first rank and is None elsewhere: that
    rank broadcasts each batch over its ``'seq'`` group, and each first
    rank of a ``'seq'`` line over its ``'model'`` group, so every rank of
    the data group holds it.  Each rank keeps its sequence shard, placed
    on ``sharding``.  A batch of ``-1`` rows ends every rank's loop."""
    import torch.distributed as dist

    from blendjax_torch.btt.prefetch import put_batch

    mesh = sharding.mesh
    s, n_seq = mesh.get_local_rank("seq"), mesh.size(mesh.mesh_dim_names.index("seq"))
    it = iter(host_batches) if host_batches is not None else None

    def bcast(t, axis):
        group = mesh.get_group(axis)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)

    def share(t):
        if s == 0:  # the group's first rank to the first ranks of the other seq lines
            bcast(t, "model")
        bcast(t, "seq")

    while True:
        host = next(it, None) if it is not None else None
        head = torch.tensor(host["obs"].shape if host is not None else (-1, 0, 0))
        share(head)
        if head[0] < 0:
            return
        bufs = {k: (torch.from_numpy(np.ascontiguousarray(host[k], np.float32))
                    if host is not None else torch.empty(tuple(head.tolist())))
                for k in ("obs", "target")}
        for v in bufs.values():
            share(v)
        t_loc = bufs["obs"].shape[1] // n_seq
        yield put_batch({k: v[:, s * t_loc:(s + 1) * t_loc].contiguous()
                         for k, v in bufs.items()}, sharding)


def train_sharded(batches, state, step, log_every=8):
    """Train over an iterator of mesh-sharded ``{obs, target}`` batches;
    returns ``(state, losses)``."""
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


def _whole_params(state):
    """A mesh-trained state's parameters as whole plain tensors on every
    rank (for the dream): a replicated parameter's local tensor, a sharded
    one gathered (:func:`blendjax_torch.parallel.sharding.gather_whole`,
    every rank calling it in one order)."""
    from blendjax_torch.parallel.sharding import gather_whole

    return {k: gather_whole(v) for k, v in state.params.items()}


def _train_on_mesh(args, attn):
    """The ``--mesh`` path of :func:`main` on this rank: returns ``(state,
    losses, stream timer summary or None)``."""
    import torch.distributed as dist

    from blendjax_torch import btt

    if not dist.is_initialized():
        dist.init_process_group("gloo")  # a torchrun world (env://)
    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    axes = dict(zip(("data", "seq", "model"), mesh_shape))
    world = dist.get_world_size()
    if len(mesh_shape) != 3 or mesh_shape[0] * mesh_shape[1] * mesh_shape[2] != world:
        sys.exit(f"mesh {axes} needs {int(np.prod(mesh_shape))} devices, have {world}")
    state, step, sharding = make_sharded_trainer(mesh_shape, attn, window=args.window,
                                                 pos_encoding=args.pos, device=args.device)
    mesh = sharding.mesh
    if mesh.get_local_rank("seq") or mesh.get_local_rank("model"):  # not its group's first
        return (*train_sharded(mesh_batches(None, sharding), state, step), None)
    d, dp = mesh.get_local_rank("data"), mesh_shape[0]
    with btt.BlenderLauncher(scene="", script=str(SCRIPT), num_instances=args.instances,
                             named_sockets=["DATA"], background=True,
                             start_port=args.start_port + d * args.instances) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=args.batches * args.batch)
        with btt.TorchStream(ds, batch_size=args.batch // dp, num_workers=args.instances,
                             transform=sharded_transform, device="cpu",
                             shard=(d, dp)) as stream:
            host = ({k: v.numpy() for k, v in b.items()} for b in stream)
            state, losses = train_sharded(mesh_batches(host, sharding), state, step)
    return state, losses, stream.timer.summary()


def main(argv=None):
    from blendjax_torch import btt

    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--attn", default=None, choices=list(SINGLE_ATTN) + list(PARALLEL_ATTN),
                    help="default: full (single device) / ring_flash (--mesh)")
    ap.add_argument("--pos", choices=["learned", "rope"], default="learned",
                    help="position encoding")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window attention width (causal); on the ring schemes "
                         "the ring then rotates only the shards the window reaches")
    ap.add_argument("--mesh", default=None,
                    help="dp,sp,tp rank counts (a torchrun world of that many ranks); "
                         f"enables the sharded path (attn one of {PARALLEL_ATTN})")
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
    args = ap.parse_args(argv)

    # the attn/mesh pairing is checked before any producer starts
    if args.mesh:
        attn = args.attn or "ring_flash"
        if attn not in PARALLEL_ATTN:
            ap.error(f"--mesh needs a parallel --attn {PARALLEL_ATTN}, got {attn!r}")
        state, losses, timing = _train_on_mesh(args, attn)
    else:
        try:
            attn_fn = make_attn(args.attn or "full", T, window=args.window)
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
        timing = stream.timer.summary()
    print(f"trained {len(losses)} batches; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if timing is not None:
        print("stage timing:", timing)
    if args.dream > 0:
        prefix_len = T // 2
        # rope has no table bound: the requested horizon is honoured
        n_steps = args.dream if args.pos == "rope" else min(args.dream, T - prefix_len)
        # a fresh episode the model never saw, with the producers' dynamics
        episode = simulate_episode(np.random.default_rng(123), batch=2,
                                   T_steps=prefix_len + n_steps)
        if args.mesh:
            state = TrainState(params=_whole_params(state), optimizer=None)
        _, mse = dream(state, episode, prefix_len, n_steps, window=args.window,
                       int8=args.dream_int8)
        print(f"dream: {n_steps} open-loop steps from a {prefix_len}-step prefix, "
              f"MSE vs real continuation {mse:.5f}")


if __name__ == "__main__":
    main()

"""Simulation-parameter optimization through a renderer that is not
differentiable, on the card: the counterpart of
``examples/densityopt/densityopt.py``.

    python -m blendjax_torch.densityopt [--instances 4] [--iterations 100] \\
        [--batch 8] [--target 5 5] [--background] [--device cpu]

A log-normal ProbModel over supershape parameters (m1, m2) learns to make
renders that a discriminator, trained on "real" renders at hidden target
parameters, cannot tell from them.  No gradient flows through Blender: the
score-function estimator with an EMA baseline turns per-sample
discriminator losses into gradients of the distribution's parameters.

One iteration (:func:`optimize`):

1. draw a batch of parameters from the ProbModel (on the device);
2. send them round-robin over the producers' duplex channels with fresh
   shape ids; each producer (:file:`btb/supershape.blend.py`) applies one
   per frame and publishes ``{image, shape_id}``;
3. join the frames back by shape id, skipping stale ones
   (:func:`make_blender_renderer`);
4. decode the uint8 batch (the CUDA kernel on the card), one discriminator
   Adam step (real against simulated), the per-sample scores, one
   ProbModel Adam step with the baseline, the baseline's EMA.

The three device steps come from :func:`make_steps`: on the card each is
one captured CUDA graph (:mod:`blendjax_torch.models.train`), eager on the
CPU; the baseline enters the ProbModel step as a device scalar, so one
graph serves every iteration.  :func:`optimize` takes any ``render_batch``
callable, so a synthetic renderer can stand in for Blender.  Point
``$BLENDJAX_BLENDER`` at a Blender, or at ``tests/helpers/fake_blender.py``
with ``BLENDJAX_FAKE_BPY=1`` and ``--background``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from blendjax_torch.models import discriminator, probmodel
from blendjax_torch.models.train import TrainState, make_eval_step, make_train_step
from blendjax_torch.ops.image import decode_frames
from blendjax_torch.utils.device import resolve_device

SCRIPT = Path(__file__).parent / "btb" / "supershape.blend.py"

#: the per-iteration stages :func:`optimize` times when given a timer
STAGES = ("sample", "render", "upload", "decode", "d_step", "scores", "p_step",
          "host_reads")


def make_blender_renderer(duplexes, dataset_iter, batch_size):
    """``render_batch(params (B, 2)) -> (B, H, W, C) uint8`` through a fleet.

    Parameters go round-robin over the duplex channels, each with a fresh
    shape id; frames are joined back by ``shape_id`` from the shared
    stream, and any other frame (a producer's last shape, published again
    every frame) is skipped.  ``render_batch.stale`` counts the frames
    skipped so far."""
    counter = {"next": 0}

    def render_batch(params_np):
        ids = []
        for i, p in enumerate(params_np):
            sid = counter["next"]
            counter["next"] += 1
            duplexes[i % len(duplexes)].send(shape_params=[float(p[0]), float(p[1])],
                                             shape_id=sid)
            ids.append(sid)
        pending = dict.fromkeys(ids)
        remaining = len(ids)
        while remaining:
            item = next(dataset_iter)
            sid = item.get("shape_id")
            if sid in pending and pending[sid] is None:
                pending[sid] = item["image"]
                remaining -= 1
            else:
                render_batch.stale += 1
        return np.stack([pending[i] for i in ids])

    render_batch.stale = 0
    return render_batch


def make_steps(compute_dtype=torch.bfloat16, capture=None):
    """The loop's three device steps, ``(d_step, p_step, scores)``:

    - ``d_step(d_state, {"real", "fake"}) -> (d_state, loss)``: one Adam
      step on :func:`discriminator.d_loss_fn`;
    - ``p_step(p_state, {"samples", "losses", "baseline"}) -> (p_state,
      loss)``: one Adam step on :func:`probmodel.score_loss`, the baseline
      a 0-d tensor;
    - ``scores(d_params, {"fake"}) -> (B,)``: :func:`discriminator.sim_scores`.

    Each is captured on the card (per batch signature) and eager on the
    CPU, as :func:`blendjax_torch.models.train.make_train_step`."""

    def d_loss(params, batch):
        return discriminator.d_loss_fn(params, batch["real"], batch["fake"], compute_dtype)

    def p_loss(params, batch):
        return probmodel.score_loss(params, batch["samples"], batch["losses"],
                                    batch["baseline"])

    def sim(params, batch):
        return discriminator.sim_scores(params, batch["fake"], compute_dtype)

    return (make_train_step(d_loss, capture=capture), make_train_step(p_loss, capture=capture),
            make_eval_step(sim, capture=capture))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def optimize(render_batch, real_images, generator=None, iterations=100, batch_size=8,
             d_lr=2e-4, p_lr=5e-2, target_init=(2.0, 2.0), sigma_init=(0.4, 0.4),
             log_every=10, device="cuda", d_params=None, draw=None, steps=None, timer=None,
             on_iteration=None):
    """The optimization loop, for any renderer.

    ``render_batch(params (B, 2) numpy) -> (B, H, W, C) uint8``;
    ``real_images`` (N, H, W, C) uint8.  Samples come from ``generator``
    (a ``torch.Generator`` on ``device``; seeded 0 when None), or from
    ``draw(pm_params, batch_size)`` when given; the discriminator starts
    from ``d_params`` (the port's dict), else from a generator seeded 1.
    ``steps`` is a :func:`make_steps` triple to run (bf16 compute,
    captured on the card, when None).  ``timer`` (a
    :class:`~blendjax_torch.utils.timing.StageTimer`) gets each of
    :data:`STAGES` per iteration, the device synchronised at the end of
    each; ``on_iteration(rec)`` gets the iteration's numbers (its stage
    times under ``stages_ms``) and both train states.  Returns
    ``(pm_params, history)``; history holds per iteration ``(d_loss,
    sim_loss_mean, pm_mean)``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pm_params = probmodel.init(mu=np.log(target_init), sigma=sigma_init, device=device)
    if d_params is None:
        d_params = discriminator.init(torch.Generator(device=device).manual_seed(1),
                                      in_channels=real_images.shape[-1], device=device)
    # the steps update in place: the caller's d_params stay as they were
    d_state = TrainState.create({k: v.detach().to(device).clone() for k, v in d_params.items()},
                                lr=d_lr)
    p_state = TrainState.create(pm_params, lr=p_lr)
    d_step, p_step, scores = steps or make_steps()

    stages = {}  # this iteration's stage times, in seconds

    def stage(name, t0):
        if timer is None:
            return t0
        _sync(device)
        now = time.perf_counter()
        stages[name] = now - t0
        timer.add(name, now - t0)
        return now

    real = decode_frames(torch.as_tensor(np.asarray(real_images)).to(device))
    baseline = torch.zeros((), device=device)
    history = []
    for it in range(iterations):
        t = t_it = time.perf_counter()
        stale = getattr(render_batch, "stale", 0)
        with torch.no_grad():
            samples = (draw(p_state.params, batch_size) if draw is not None
                       else probmodel.sample(p_state.params, generator, batch_size))
        samples_np = samples.cpu().numpy()
        t = stage("sample", t)
        fake_u8 = render_batch(samples_np)
        t = stage("render", t)
        fake_u8 = torch.from_numpy(np.ascontiguousarray(fake_u8)).to(device)
        t = stage("upload", t)
        fake = decode_frames(fake_u8)
        t = stage("decode", t)
        d_state, d_loss = d_step(d_state, {"real": real, "fake": fake})
        t = stage("d_step", t)
        sim_losses = scores(d_state.params, {"fake": fake})
        t = stage("scores", t)
        p_state, _ = p_step(p_state, {"samples": samples, "losses": sim_losses,
                                      "baseline": baseline})
        t = stage("p_step", t)
        with torch.no_grad():
            baseline = probmodel.ema_update(baseline, sim_losses)
            pm_mean = probmodel.mean(p_state.params)
        history.append((float(d_loss), float(sim_losses.mean()), pm_mean.cpu().numpy()))
        base = float(baseline)
        stage("host_reads", t)
        if on_iteration is not None:
            on_iteration({"iteration": it, "d_loss": history[-1][0],
                          "sim_loss_mean": history[-1][1], "pm_mean": history[-1][2],
                          "baseline": base, "samples": samples_np,
                          "stale": getattr(render_batch, "stale", 0) - stale,
                          "ms": (time.perf_counter() - t_it) * 1e3,
                          "stages_ms": {k: v * 1e3 for k, v in stages.items()},
                          "d_state": d_state, "p_state": p_state})
        if log_every and (it + 1) % log_every == 0:
            print(f"iter {it + 1}: d_loss {history[-1][0]:.4f} "
                  f"sim_loss {history[-1][1]:.4f} mean {history[-1][2]}")
    return {k: v.detach() for k, v in p_state.params.items()}, history


def main(argv=None):
    from blendjax_torch import btt

    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--target", type=float, nargs=2, default=[5.0, 5.0])
    ap.add_argument("--background", action="store_true",
                    help="run Blender headless (the producers then run the "
                         "blocking frame loop; offscreen GL must be available, "
                         "e.g. the fake stack)")
    ap.add_argument("--start-port", type=int, default=11000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with btt.BlenderLauncher(scene="", script=str(SCRIPT), num_instances=args.instances,
                             named_sockets=["DATA", "CTRL"], start_port=args.start_port,
                             background=args.background) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=10**9, timeoutms=30000)
        duplexes = [btt.DuplexChannel(addr, btid=i)
                    for i, addr in enumerate(bl.launch_info.addresses["CTRL"])]
        try:
            render_batch = make_blender_renderer(duplexes, iter(ds), args.batch)
            # phase 1: "real" images rendered at the hidden target parameters
            real = render_batch(np.tile(args.target, (args.batch * 4, 1)))
            # phase 2: optimize the distribution to match
            pm_params, history = optimize(render_batch, real, iterations=args.iterations,
                                          batch_size=args.batch, device=device)
        finally:
            for d in duplexes:
                d.close()
    print("final mean:", probmodel.mean(pm_params).cpu().numpy())
    return pm_params, history


if __name__ == "__main__":
    main()

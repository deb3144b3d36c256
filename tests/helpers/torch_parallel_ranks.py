"""Rank programs for :mod:`helpers.torch_ranks`: the port's side of the
twins of ``tests/test_sharding.py`` and ``tests/test_multihost.py``.  Each
runs in every gloo rank and reports its cases as it finishes them; the
inputs (numpy parameters from the JAX package's ``init``, seeded batches)
come in ``args`` from the test process.  Torch and the port only."""

from __future__ import annotations

import functools
import os


def _np(t):
    return t.detach().to("cpu").numpy()


def sharding_cases(rank, world, args, report):
    """The four cases of ``tests/test_sharding.py`` on 8 ranks, and a
    tensor-parallel step over all 8 on a replicated batch."""
    import torch

    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.models import detector
    from blendjax_torch.models.convert import params_from_jax
    from blendjax_torch.models.train import make_train_step
    from blendjax_torch.parallel import (
        data_sharding,
        detector_rules,
        make_mesh,
        make_sharded_train_step,
        param_specs,
        replicated,
        shard_pytree,
    )

    loss = functools.partial(detector.loss_fn, compute_dtype=torch.float32)

    params = params_from_jax(args["rules_params"], device="cpu")
    report("rules", {k: tuple(v) for k, v in param_specs(params, detector_rules()).items()})

    mesh = make_mesh({"data": 4, "model": 2}, device="cpu")
    params = params_from_jax(args["placement_params"], device="cpu")
    fc = shard_pytree(params, mesh, param_specs(params, detector_rules()))["fc.w"]
    report("placement", {"placements": [repr(p) for p in fc.placements],
                         "shape": tuple(fc.shape), "local_shape": tuple(fc.to_local().shape)})

    def run(mesh, tree, image, xy, rules, lr, steps, sharding=None):
        init_sharded, step = make_sharded_train_step(loss, mesh, rules=rules, lr=lr)
        state = init_sharded(params_from_jax(tree, device="cpu"))
        if sharding is None:
            # this rank's rows of the global batch, placed as its shard
            d, n = mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))
            rows = slice(d * len(image) // n, (d + 1) * len(image) // n)
            sharding = data_sharding(mesh)
        else:
            rows = slice(None)
        batch = put_batch({"image": image[rows], "xy": xy[rows]}, sharding, device="cpu")
        losses = []
        for _ in range(steps):
            state, value = step(state, batch)
            losses.append(float(value))
        try:  # a sharded step runs eager: a capture request raises
            make_train_step(loss, capture=True)(state, batch)
            capture = "ran"
        except RuntimeError as exc:
            capture = str(exc)
        return {"losses": losses, "step": state.step, "capture": capture,
                "placements": {k: [repr(p) for p in v.placements]
                               for k, v in state.params.items()},
                "params": {k: _np(v.full_tensor()) for k, v in state.params.items()}}

    image, xy = args["dp_tp_batch"]
    report("dp_tp", run(mesh, args["dp_tp_params"], image, xy, detector_rules(), 1e-3, 2))
    tp = make_mesh({"model": 8}, device="cpu")
    report("tp8", run(tp, args["dp_tp_params"], image, xy, detector_rules(), 1e-3, 2,
                      replicated(tp)))
    image, xy = args["dp8_batch"]
    report("dp8", run(make_mesh({"data": 8}, device="cpu"), args["dp8_params"], image, xy,
                      {}, 1e-1, 1))


def multihost_feed(rank, world, args, report):
    """``tests/test_multihost.py``'s feed: each rank streams its shard of one
    producer fleet into a global batch of DTensors."""
    import torch

    from blendjax_torch.btt import RemoteIterableDataset, TorchStream
    from blendjax_torch.parallel import data_mesh, data_sharding

    mesh = data_mesh(device="cpu")
    seen = []

    def transform(batch):
        seen.extend(int(f) for f in batch["frameid"])
        return {"image": batch["image"]}

    ds = RemoteIterableDataset(args["addresses"], max_items=16, timeoutms=30000)
    with TorchStream(ds, batch_size=8, num_workers=1, sharding=data_sharding(mesh),
                     shard=(rank, world), transform=transform) as stream:
        batches = list(stream)
    img = batches[0]["image"]
    report("feed", {"batches": len(batches), "global_shape": tuple(img.shape),
                    "local_shape": tuple(img.to_local().shape),
                    "placements": [repr(p) for p in img.placements],
                    "mean": float(img.to(torch.float32).mean().full_tensor()),
                    "frameids": seen})


def multihost_train(rank, world, args, report):
    """``tests/test_multihost.py``'s train step: 3 data-parallel steps on
    different local data per rank, a checkpoint saved by rank 0 and
    restored on every rank."""
    import torch
    import torch.distributed as dist

    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.parallel import data_mesh, data_sharding, make_sharded_train_step
    from blendjax_torch.utils.checkpoint import load_train_state, save_train_state

    mesh = data_mesh(device="cpu")

    def loss_fn(params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        err = pred - batch["y"]
        return torch.mean(err * err)

    init_sharded, step = make_sharded_train_step(loss_fn, mesh, lr=1e-2)
    state = init_sharded({k: torch.from_numpy(v) for k, v in args["params"].items()})
    losses = []
    for i in range(3):
        state, loss = step(state, put_batch(args["batches"][i][rank], data_sharding(mesh),
                                            device="cpu"))
        losses.append(float(loss))
    path = os.path.join(args["dir"], "state.npz")
    if rank == 0:
        save_train_state(path, state)
    dist.barrier()
    fresh = init_sharded({k: torch.zeros_like(torch.from_numpy(v))
                          for k, v in args["params"].items()})
    load_train_state(path, fresh)
    same = all(torch.equal(state.params[k].to_local(), fresh.params[k].to_local())
               for k in state.params)
    moments = [(state.optimizer.state[state.params[k]], fresh.optimizer.state[fresh.params[k]])
               for k in state.params]
    same_adam = all(torch.equal(a[m].to_local(), b[m].to_local())
                    for a, b in moments for m in ("exp_avg", "exp_avg_sq"))
    report("train", {"losses": losses, "restored_equal": same, "adam_equal": same_adam,
                     "restored_step": fresh.step,
                     "params": {k: _np(v.full_tensor()) for k, v in state.params.items()},
                     "placements": [repr(p) for p in state.params["w1"].placements]})

"""Rank programs for :mod:`helpers.torch_ranks`: the port's side of the
twins of ``tests/test_sharding.py``, ``tests/test_multihost.py``,
``tests/test_ring_attention.py``, the sharded cases of
``tests/test_seqformer.py`` and ``tests/test_moe.py``, and
``tests/test_actor_learner_sharded.py``.  Each
runs in every gloo rank and reports its cases as it finishes them; the
inputs (numpy parameters from the JAX package's ``init``, seeded batches)
come in ``args`` from the test process.  Torch and the port only."""

from __future__ import annotations

import functools
import os

import numpy as np


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


def _seq_block(mesh, x, grad=False, dtype=None):
    """This rank's block of the global numpy ``x`` (B, S, ...) on a mesh
    with a 'seq' axis (and maybe 'data'), as a tensor; and where it lies."""
    import torch

    names = mesh.mesh_dim_names

    def part(axis, length):
        if axis not in names:
            return 0, length
        n, i = mesh.size(names.index(axis)), mesh.get_local_rank(axis)
        return i * length // n, (i + 1) * length // n

    rows, cols = part("data", x.shape[0]), part("seq", x.shape[1])
    t = torch.from_numpy(x[rows[0]:rows[1], cols[0]:cols[1]].copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad), {"rows": rows, "cols": cols}


def ring_attention_cases(rank, world, args, report):
    """The port's side of ``tests/test_ring_attention.py``'s 12 tests on 8
    ranks: each case reports this rank's block of the output (and of the
    q/k/v gradients of ``sum(out**2)``), or the error a refused case
    raised; ranks outside a case's mesh report None."""
    import functools

    import torch

    from blendjax_torch.ops.flash_attention import flash_attention
    from blendjax_torch.parallel import make_mesh, make_ring_attention, p2p

    meshes = {"seq8": make_mesh({"seq": 8}, device="cpu"),
              "dp": make_mesh({"data": 2, "seq": 4}, device="cpu"),
              "seq4": make_mesh({"seq": 4}, device="cpu"),
              "seq2": make_mesh({"seq": 2}, device="cpu")}

    def run(case, mesh, qkv, grad=False, dtype=None, **kw):
        mesh = meshes[mesh]
        if mesh is None:
            report(case, None)
            return
        try:
            attn = make_ring_attention(mesh, **kw)
            blocks = [_seq_block(mesh, x, grad, dtype) for x in qkv]
            before = dict(p2p.counts)
            out = attn(*(t for t, _ in blocks))
            rec = {"where": blocks[0][1], "out": _np(out.float())}
            if grad:
                (out.float() ** 2).sum().backward()
                rec["grads"] = [_np(t.grad.float()) for t, _ in blocks]
            rec["rotations"] = p2p.counts["rotate"] - before["rotate"]
        except Exception as exc:  # noqa: BLE001 - a refused case reports its error
            rec = {"error": f"{type(exc).__name__}: {exc}"}
        report(case, rec)

    qkv = args["qkv"]
    impls = ("ring", "ring_flash", "zigzag_flash", "ulysses")
    for impl in impls:
        for causal in (False, True):
            run(("full", impl, causal), "seq8", qkv, causal=causal, impl=impl)
    for impl in impls:
        run(("grad", impl), "seq8", qkv, grad=True, causal=True, impl=impl)
    for impl in impls:
        run(("dp", impl), "dp", qkv, causal=True, impl=impl, batch_axis="data")
    bad = np.zeros((2, 32, 6, 16), np.float32)
    run("uneven_heads", "seq8", (bad, bad, bad), impl="ulysses")
    inner = functools.partial(flash_attention, block_q=32, block_kv=32)
    run("ulysses_flash", "seq4", args["ulysses_flash_qkv"], impl="ulysses", causal=True,
        inner_attn=inner)
    for impl in ("ring_flash", "zigzag_flash"):
        run(("bf16", impl), "seq8", qkv, dtype=torch.bfloat16, causal=True, impl=impl)
    for impl in ("ring", "ring_flash", "ulysses"):
        for window in (1, 3, 4, 7, 1000):
            run(("window", impl, window), "seq8", qkv, causal=True, impl=impl, window=window)
    for impl in ("ring", "ring_flash"):
        run(("window_grad", impl), "seq8", qkv, grad=True, causal=True, impl=impl, window=7)
    run("traffic", "seq8", args["traffic_qkv"], grad=True, causal=True, impl="ring_flash",
        window=1)
    for impl in ("ring_flash", "zigzag_flash"):
        run(("gqa", impl), "seq8", (qkv[0],) + args["gqa_kv"], causal=True, impl=impl)
    run("ulysses_gqa", "seq2", args["ulysses_gqa_qkv"], causal=True, impl="ulysses")


def seqformer_sharded_cases(rank, world, args, report):
    """The port's side of the sequence-sharded SeqFormer steps of
    ``tests/test_seqformer.py`` (the five parity cases, the packaged step
    trained end to end, the ulysses_flash parity) and ``tests/test_moe.py``'s expert-sharded routed
    step, on 8 ranks (the ulysses_flash case on the first 4).  Each reports
    the losses and, for the parity cases, the whole parameters after the
    step."""
    import torch

    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.models.convert import params_from_jax
    from blendjax_torch.parallel import make_mesh, make_seqformer_train_step

    def steps(case, mesh, tree, batch, n=1, sgd=None, **kw):
        if mesh is None:
            report(case, None)
            return
        init_sharded, step, sharding = make_seqformer_train_step(mesh, **kw)
        state = init_sharded(params_from_jax(tree, device="cpu"))
        if sgd is not None:  # the reference's parity cases step with SGD
            state.optimizer = torch.optim.SGD(list(state.params.values()), lr=sgd)
        local = put_batch({k: _seq_block(mesh, v)[0] for k, v in batch.items()}, sharding,
                          device="cpu")
        losses = []
        for _ in range(n):
            state, loss = step(state, local)
            losses.append(float(loss))
        rec = {"losses": losses}
        if sgd is not None:
            rec["params"] = {k: _np(v.full_tensor()) for k, v in state.params.items()}
        report(case, rec)

    f32 = torch.float32
    mesh3 = make_mesh({"data": 2, "seq": 2, "model": 2}, device="cpu")
    for n_experts, impl in args["parity_cases"]:
        steps(("parity", n_experts, impl), mesh3, args["params"][n_experts], args["batch"],
              sgd=0.1, attn_impl=impl, compute_dtype=f32)
    steps("packaged", mesh3, args["params"][4], args["batch"], n=8, lr=1e-2)
    mesh_u = make_mesh({"data": 2, "seq": 2, "model": 1}, device="cpu")
    for impl in ("ulysses", "ulysses_flash"):
        steps(("ulysses_flash_parity", impl), mesh_u, args["ulysses_params"],
              args["ulysses_batch"], lr=1e-3, attn_impl=impl)
    mesh_e = make_mesh({"data": 2, "seq": 2, "expert": 2}, device="cpu")
    steps("moe", mesh_e, args["moe_params"], args["moe_batch"], sgd=0.1,
          model_axis="expert", expert_axis="expert", compute_dtype=f32, moe_impl="topk",
          moe_k=2, moe_capacity_factor=2.0, moe_aux_weight=0.01)


def worldmodel_mesh(rank, world, args, report):
    """``python -m blendjax_torch.worldmodel --mesh 1,2,1 --attn ring_flash``
    at a small size on 2 ranks (the first launches the producer and shares
    its batches), then a ``--mesh`` whose product is not the world's size;
    reports each run's printed lines or its exit message."""
    import contextlib
    import io

    from blendjax_torch import worldmodel

    os.environ["BLENDJAX_BLENDER"] = args["blender"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        worldmodel.main(["--mesh", "1,2,1", "--attn", "ring_flash", "--device", "cpu",
                         "--instances", "1", "--batch", "2", "--batches", "3",
                         "--start-port", str(args["port"])])
    report("ring_flash", out.getvalue().splitlines())
    try:
        worldmodel.main(["--mesh", "2,2,2", "--device", "cpu"])
        report("wrong_size", "ran")
    except SystemExit as exc:
        report("wrong_size", str(exc))


def _segment(rng, t, n, d, fill=None):
    obs = [rng.random((n, d)).astype(np.float32) if fill is None
           else np.full((n, d), fill, np.float32) for _ in range(t)]
    return (obs, [rng.integers(0, 2, (n,)).astype(np.int32) for _ in range(t)],
            [rng.random((n,)).astype(np.float32) for _ in range(t)],
            [np.zeros((n,), bool) for _ in range(t)])


def _rows(mesh, x):
    """This rank's ``Shard(0)`` rows of the global numpy ``x``."""
    n, i = mesh.size(0), mesh.get_local_rank("data")
    return x[i * len(x) // n:(i + 1) * len(x) // n]


def actor_learner_sharded_cases(rank, world, args, report):
    """The port's side of ``tests/test_actor_learner_sharded.py``'s mesh
    cases on 8 ranks, each rank owning its fleets: the DP equivalence and
    padding updates over ``{"data": 8}``, the fan-in's padding and placement
    and the multi-fleet runs (live, and with one fleet killed) over
    ``{"data": 2}`` (ranks 0 and 1) with ``seconds=`` runs of 2 s and 30 s,
    the offline updates and the
    indivisible replay batches over ``{"data": 8}``."""
    import threading
    import time

    import torch

    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.faults import FaultPolicy
    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.parallel import FleetSet, SegmentFanIn, data_sharding, make_mesh
    from blendjax_torch.replay import ReplayBuffer

    os.environ["BLENDJAX_BLENDER"] = args["blender"]
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    mesh8 = make_mesh({"data": 8}, device="cpu")
    mesh2 = make_mesh({"data": 2}, device="cpu")

    for case in ("dp", "padding"):
        c = args[case]
        al = ActorLearner(None, obs_dim=3, num_actions=2, seed=3, mesh=mesh8, device="cpu")
        with torch.no_grad():
            for k, v in al.state.params.items():
                v.to_local().copy_(torch.from_numpy(c["params"][k]))
        local = {k: _rows(mesh8, v) for k, v in c["batch"].items()}
        batch = put_batch(local, data_sharding(mesh8), device="cpu")
        state, loss = al._step(al.state, batch)
        report(case, {"loss": float(loss),
                      "grads": {k: _np(v.grad.to_local()) for k, v in state.params.items()},
                      "params": {k: _np(v.to_local()) for k, v in state.params.items()},
                      "placements": [repr(p) for p in batch["obs"].placements],
                      "rows": int(batch["obs"].to_local().shape[0])})

    if mesh2 is None:
        for case in ("fanin", "two_fleets", "seconds", "kill_one_fleet"):
            report(case, None)
    else:
        rng = np.random.default_rng(rank)
        stop = threading.Event()
        sizes = [2, 2] if rank == 0 else [2]
        fanin = SegmentFanIn(sizes, mesh=mesh2, device="cpu")
        segs = [_segment(rng, 4, 2, 3) for _ in sizes]
        for f, seg in enumerate(segs):
            assert fanin.put_segment(f, seg, stop)
        dev = fanin.to_device(fanin.assemble(fanin.collect(lambda f: True, stop)))
        obs = dev["obs"]
        report("fanin", {"n_real": fanin.n_real, "n_real_global": fanin.n_real_global,
                         "n_local": fanin.n_local, "n_padded": fanin.n_padded,
                         "mask": dev["mask"].to_local().tolist(),
                         "global_shape": tuple(obs.shape),
                         "local_shape": tuple(obs.to_local().shape),
                         "rewards_shape": tuple(dev["rewards"].shape),
                         "placements": [repr(p) for p in obs.placements],
                         "obs": _np(obs.to_local()),
                         "segments": [np.stack(seg[0]).swapaxes(0, 1) for seg in segs]})

        values = np.array([0.0, 1.0], np.float64)

        def action_map(a):
            return list(values[np.asarray(a)])

        # 2 fleets of 1 env: 20 ports a rank and FleetSet (port_stride 10)
        with FleetSet("", args["env_script"], num_fleets=2, envs_per_fleet=1,
                      start_port=args["port"] + rank * 20, port_stride=10, timeoutms=30000,
                      horizon=1_000_000) as fs:
            al = ActorLearner(fs, obs_dim=1, num_actions=2, rollout_len=16, seed=1,
                              mesh=mesh2, action_map=action_map, device="cpu")
            stats = al.run(num_updates=30)
            report("two_fleets", {"stats": stats, "health": fs.health()})
            # rank 0 runs for 2 s, rank 1 for 30 s (a clock behind), and rank
            # 1's first batch comes 4 s late: rank 0's budget runs out while
            # it waits in the first update for rank 1
            if rank == 1:
                fetch = al._next_fanin_batch

                def late(deadline, first=[True]):
                    if first:
                        first.clear()
                        time.sleep(4.0)
                    return fetch(deadline)

                al._next_fanin_batch = late
            timed = al.run(seconds=2.0 if rank == 0 else 30.0)
        report("seconds", {"updates": timed["updates"], "losses": timed["losses"]})

        policy = FaultPolicy(max_retries=1, backoff_base=0.05, deadline_s=2.0,
                             circuit_threshold=0, seed=7)
        with FleetSet("", args["env_script"], num_fleets=2, envs_per_fleet=1,
                      start_port=args["port"] + 40 + rank * 20, port_stride=10,
                      timeoutms=10000, fault_policy=policy, interval=0.2,
                      horizon=1_000_000) as fs:
            al = ActorLearner(fs, obs_dim=1, num_actions=2, rollout_len=8, seed=1,
                              mesh=mesh2, action_map=action_map, device="cpu")

            def killer():
                while sum(al._env_steps_by_fleet) < 32:
                    time.sleep(0.02)
                kill_instance(fs.launchers[1], 0)

            kt = threading.Thread(target=killer, daemon=True)
            if rank == 1:  # rank 1's fleet 1 dies; its rows go masked
                kt.start()
            stats = al.run(num_updates=30)
            if rank == 1:
                kt.join(timeout=10)
            health = fs.health()
        report("kill_one_fleet", {"stats": stats, "health": health})

    buf = ReplayBuffer(1024, seed=rank)
    rng = np.random.default_rng(rank)
    buf.extend({"obs": rng.random(3).astype(np.float32), "action": np.int32(rng.integers(0, 2)),
                "reward": np.float32(rng.random()), "next_obs": rng.random(3).astype(np.float32),
                "done": False} for _ in range(512))
    al = ActorLearner(None, obs_dim=3, num_actions=2, seed=2, mesh=mesh8, replay=buf,
                      device="cpu")
    out = al.run_offline(num_updates=5, batch_size=32)
    report("offline", {"updates": out["updates"], "losses": out["losses"],
                       "params": {k: _np(v.to_local()) for k, v in al.state.params.items()}})
    errors = []
    try:
        ActorLearner(None, obs_dim=3, num_actions=2, mesh=mesh8, replay=buf, replay_ratio=1,
                     replay_batch=36, device="cpu")
    except ValueError as exc:
        errors.append(str(exc))
    try:
        al.run_offline(num_updates=1, batch_size=30)
    except ValueError as exc:
        errors.append(str(exc))
    report("indivisible", errors)


def learner_mesh_options(rank, world, args, report):
    """``ActorLearner(mesh=)`` and ``SegmentFanIn(mesh=)`` on 2 ranks: one
    sharded update on each rank's row of a seeded env-major batch, the
    refusal of a mesh without a 'data' axis, and a fan-in's padded rows."""
    import threading

    import torch

    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.parallel import SegmentFanIn, data_sharding, make_mesh

    mesh = make_mesh({"data": 2}, device="cpu")
    model = make_mesh({"model": 2}, device="cpu")
    al = ActorLearner(None, 3, 2, seed=0, mesh=mesh, device="cpu")
    local = {k: _rows(mesh, v) for k, v in args["batch"].items()}
    state, loss = al._step(al.state, put_batch(local, data_sharding(mesh), device="cpu"))
    try:
        ActorLearner(None, 3, 2, mesh=model, device="cpu")
        refused = "ran"
    except ValueError as exc:
        refused = str(exc)
    report("actor_learner", {"loss": float(loss), "step": state.step, "refused": refused,
                             "params": {k: _np(v.to_local()) for k, v in state.params.items()},
                             "snapshot": {k: _np(v) for k, v in al._snapshot()[0].items()}})
    fanin = SegmentFanIn([1 + rank], mesh=mesh, device="cpu")
    stop = threading.Event()
    fanin.put_segment(0, _segment(np.random.default_rng(rank), 3, 1 + rank, 2), stop)
    dev = fanin.to_device(fanin.assemble(fanin.collect(lambda f: True, stop)))
    report("fanin", {"mask": dev["mask"].to_local().tolist(), "shape": tuple(dev["obs"].shape),
                     "n_padded": fanin.n_padded})


def control_mesh(rank, world, args, report):
    """``train_reinforce(mesh=)`` on 2 ranks, each stepping its own numpy
    cartpole pool; then one sharded update (SGD, so that it is linear in the
    gradient) on an uneven 10/6 split of a seeded batch."""
    import torch

    from blendjax_torch import control
    from blendjax_torch.models import policy
    from blendjax_torch.parallel import make_mesh, make_sharded_train_step
    from blendjax_torch.parallel.podracer import data_sum
    from test_torch_control import _NumpyCartpolePool

    mesh = make_mesh({"data": 2}, device="cpu")
    recs = []
    state, returns = control.train_reinforce(_NumpyCartpolePool(2, seed=rank), iterations=2,
                                             horizon=8, log_every=0, mesh=mesh,
                                             on_iteration=recs.append)
    report("train", {"returns": returns, "losses": [r["loss"] for r in recs],
                     "params": {k: _np(v.to_local()) for k, v in state.params.items()}})
    held = args["held"]
    total = data_sum(mesh)

    def loss_fn(p, b):
        return policy.reinforce_loss(p, b["obs"], b["actions"], b["returns"], reduce=total)

    init_sharded, step = make_sharded_train_step(loss_fn, mesh)
    state = init_sharded({k: torch.from_numpy(v) for k, v in held["params"].items()})
    state.optimizer = torch.optim.SGD(list(state.params.values()), lr=0.1)
    rows = slice(0, 10) if rank == 0 else slice(10, 16)
    state, loss = step(state, {k: torch.from_numpy(v[rows]) for k, v in held["batch"].items()})
    report("held", {"loss": float(loss),
                    "params": {k: _np(v.to_local()) for k, v in state.params.items()}})


def _pipe_stage_fn():
    import torch

    from blendjax_torch.models.layers import dense_apply, gelu, layer

    def stage_fn(p, x):
        return x + gelu(dense_apply(layer(p, "fc"), x, dtype=torch.float32))

    return stage_fn


def _mse(pred, tgt):
    import torch

    return torch.mean((pred - tgt) ** 2)


def _t(arr):
    import torch

    return torch.tensor(np.asarray(arr, np.float32))


def _run_case(report, case, mesh, fn):
    """Report ``fn()`` for ``case`` on the ranks of ``mesh`` (None on the
    others), or the error it raised."""
    if mesh is None:
        report(case, None)
        return
    try:
        rec = fn()
    except Exception as exc:  # noqa: BLE001 - a refused case reports its error
        rec = {"error": f"{type(exc).__name__}: {exc}"}
    report(case, rec)


def pipeline_cases(rank, world, args, report):
    """The port's side of ``tests/test_pipeline.py``'s 13 cases on 8 ranks:
    the meshes ``{"pipe": 4}`` (ranks 0-3), ``{"pipe": 2, "data": 4}``,
    ``{"pipe": 2}`` (ranks 0-1) and ``{"pipe": 1, "data": 8}``; each case
    reports this rank's outputs, its row of the stacked gradients, and the
    projections' gradients."""
    import torch
    from torch.distributed.tensor import DTensor

    from blendjax_torch.models.convert import params_from_jax
    from blendjax_torch.models.layers import dense_apply, layer
    from blendjax_torch.parallel import (
        make_mesh,
        make_pipeline,
        make_pipeline_train,
        stack_stage_params,
    )
    from blendjax_torch.parallel.mesh import P, placements

    stage_fn = _pipe_stage_fn()
    pipe4 = make_mesh({"pipe": 4}, devices=range(4), device="cpu")
    dp = make_mesh({"pipe": 2, "data": 4}, device="cpu")
    pipe2 = make_mesh({"pipe": 2}, devices=range(2), device="cpu")
    tiny = make_mesh({"pipe": 1, "data": 8}, device="cpu")

    def stacked(key):
        return stack_stage_params([params_from_jax(s, device="cpu") for s in args[key]])

    def fwd(m):
        y = make_pipeline(stage_fn, pipe4)(stacked("stages4"), _t(args["x"][m]))
        return {"y": _np(y)}

    for m in (4, 7):
        _run_case(report, ("fwd", m), pipe4, lambda m=m: fwd(m))

    def grad():
        st = {k: v.clone().requires_grad_(True) for k, v in stacked("stages4").items()}
        apply = make_pipeline(stage_fn, pipe4)
        (apply(st, _t(args["x"][4])) ** 2).sum().backward()
        me = pipe4.get_local_rank("pipe")
        return {"row": me, "w": _np(st["fc.w"].grad[me]),
                "other_rows_zero": bool((st["fc.w"].grad.sum(dim=(1, 2)) != 0).sum() == 1)}

    _run_case(report, "grad", pipe4, grad)

    def data_parallel():
        x = _t(args["x_dp"])
        d = dp.get_local_rank("data")
        rows = x.shape[1] // 4
        xs = DTensor.from_local(x[:, d * rows:(d + 1) * rows], dp,
                                placements(dp, P(None, "data")), run_check=False)
        y = make_pipeline(stage_fn, dp, x_spec=P(None, "data"))(stacked("stages2"), xs)
        return {"rows": [d * rows, (d + 1) * rows], "y": _np(y.to_local()),
                "placements": [repr(p) for p in y.placements]}

    _run_case(report, "dp", dp, data_parallel)
    _run_case(report, "wrong_count", pipe4,
              lambda: make_pipeline(stage_fn, pipe4)(stacked("stages2"), torch.zeros(4, 3, 16)))

    def learns():
        learn = args["learn"]
        params = {**{f"stages.{k}": v for k, v in stacked("stages4").items()},
                  **{f"head.{k}": _t(v) for k, v in learn["head"].items()}}
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        apply = make_pipeline(stage_fn, pipe4)
        opt = torch.optim.Adam(list(params.values()), lr=1e-2)
        x, y = _t(learn["x"]), _t(learn["y"])
        losses = []
        for _ in range(15):
            opt.zero_grad()
            h = apply({"fc.w": params["stages.fc.w"], "fc.b": params["stages.fc.b"]}, x)
            loss = torch.mean((dense_apply(layer(params, "head"), h, dtype=torch.float32)
                               - y) ** 2)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return {"losses": losses}

    _run_case(report, "learn", pipe4, learns)

    def proj(pp):
        return ({"w": _t(pp[0]["w"])}, {"w": _t(pp[1]["w"])})

    def mm(pp, x):
        return x @ pp["w"]

    def train(mesh, case, sched):
        stages, pp, x, tgt = case
        st = stack_stage_params([params_from_jax(s, device="cpu") for s in stages])
        fn = make_pipeline_train(stage_fn, _mse, mesh, schedule=sched, in_proj=mm,
                                 out_proj=mm)
        loss, (gs, gp) = fn(st, proj(pp), _t(x), _t(tgt))
        return {"loss": float(loss), "row": mesh.get_local_rank("pipe"),
                "stage_grads": {k: _np(v[0]) for k, v in gs.items()},
                "proj_grads": [{k: _np(v) for k, v in g.items()} for g in gp]}

    for sched in ("gpipe", "1f1b"):
        for m in (4, 7):
            _run_case(report, ("train", sched, m), pipe4,
                      lambda s=sched, m=m: train(pipe4, args["train"][m], s))

    def converges():
        stages, pp, x, tgt = args["converge"]
        params = {**{f"stages.{k}": v for k, v in
                     stack_stage_params([params_from_jax(s, device="cpu")
                                         for s in stages]).items()},
                  **{f"proj.{i}.w": _t(p["w"]) for i, p in enumerate(pp)}}
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        opt = torch.optim.Adam(list(params.values()), lr=3e-2)
        fn = make_pipeline_train(stage_fn, _mse, pipe2, schedule="1f1b", in_proj=mm,
                                 out_proj=mm)
        me = pipe2.get_local_rank("pipe")
        losses = []
        for _ in range(20):
            st = {k[len("stages."):]: v.detach() for k, v in params.items()
                  if k.startswith("stages.")}
            loss, (gs, gp) = fn(st, ({"w": params["proj.0.w"].detach()},
                                     {"w": params["proj.1.w"].detach()}), _t(x), _t(tgt))
            for k, g in gs.items():
                full = torch.zeros_like(params[f"stages.{k}"])
                full[me] = g[0]
                params[f"stages.{k}"].grad = full
            for i, g in enumerate(gp):
                params[f"proj.{i}.w"].grad = g["w"].clone()
            opt.step()
            losses.append(float(loss))
        return {"losses": losses}

    _run_case(report, "converge", pipe2, converges)
    _run_case(report, "tiny", tiny, lambda: make_pipeline_train(stage_fn, _mse, tiny))


def _array_loss_fn(spec):
    """The family loss over the packed array target of
    ``tests/test_1f1b_numerics.py``: pg's ``(action, adv, w)`` ride as the
    last axis's channels."""
    from blendjax_torch.parallel.mpmd import reference_pieces

    loss_fn = reference_pieces(spec)[3]
    if spec["family"] == "mse":
        return lambda pred, t: loss_fn(pred, {"y": t})
    return lambda pred, t: loss_fn(pred, {"action": t[..., 0].long(), "adv": t[..., 1],
                                          "w": t[..., 2]})


def _ref_params(stacked, proj):
    stacked = {k: _t(v) for k, v in stacked.items()}
    return stacked, tuple({k: _t(v) for k, v in p.items()} for p in proj)


def onef1b_cases(rank, world, args, report):
    """The port's side of ``tests/test_1f1b_numerics.py`` on ``{"pipe":
    4}``: the 1F1B step of :func:`reference_pieces`' factoring at M = N and
    2N, for both families, on the JAX package's parameters."""
    from blendjax_torch.parallel import make_mesh, make_pipeline_train
    from blendjax_torch.parallel.mpmd import reference_pieces

    mesh = make_mesh({"pipe": 4}, device="cpu")
    for key, case in args.items():
        spec = case["spec"]
        in_proj, stage_fn, out_proj, _ = reference_pieces(spec)

        def run(case=case, spec=spec, in_proj=in_proj, stage_fn=stage_fn, out_proj=out_proj):
            stacked, proj = _ref_params(case["stacked"], case["proj"])
            fn = make_pipeline_train(stage_fn, _array_loss_fn(spec), mesh, schedule="1f1b",
                                     in_proj=in_proj, out_proj=out_proj)
            loss, (gs, gp) = fn(stacked, proj, _t(case["x"]), _t(case["tgt"]))
            return {"loss": float(loss), "row": mesh.get_local_rank("pipe"),
                    "stage_grads": {k: _np(v[0]) for k, v in gs.items()},
                    "proj_grads": [{k: _np(v) for k, v in g.items()} for g in gp]}

        _run_case(report, key, mesh, run)


def mpmd_lock(rank, world, args, report):
    """The port's in-process reference for ``tests/test_mpmd.py``'s lock:
    ``make_pipeline_train('1f1b')`` over ``{"pipe": 2}`` plus SGD, from the
    port's ``build_full_params(spec)``, on the given batches; reports the
    losses and this rank's final stage row and projections."""
    from blendjax_torch.parallel import make_mesh, make_pipeline_train, microbatch
    from blendjax_torch.parallel.mpmd import build_full_params, reference_pieces
    from blendjax_torch.parallel.mpmd import reference_stacked

    spec, m = args["spec"], args["m"]
    in_proj, stage_fn, out_proj, loss_fn = reference_pieces(spec)
    mesh = make_mesh({"pipe": spec["n_procs"]}, device="cpu")
    train = make_pipeline_train(stage_fn, lambda pred, y: loss_fn(pred, {"y": y}), mesh,
                                schedule="1f1b", in_proj=in_proj, out_proj=out_proj)
    stacked, proj = reference_stacked(build_full_params(spec), spec)
    me = mesh.get_local_rank("pipe")
    losses = []
    for x, tgt in args["batches"]:
        loss, (gs, gp) = train(stacked, proj, _t(microbatch(x, m)),
                               _t(microbatch(tgt["y"], m)))
        losses.append(float(loss))
        stacked = {k: v.clone() for k, v in stacked.items()}
        for k, g in gs.items():
            stacked[k][me] -= spec["lr"] * g[0]
        proj = tuple({k: p[k] - spec["lr"] * g[k] for k in p} for p, g in zip(proj, gp))
    report("lock", {"losses": losses, "row": me,
                    "stacked": {k: _np(v[me]) for k, v in stacked.items()},
                    "proj": [{k: _np(v) for k, v in p.items()} for p in proj]})


def gather_cases(rank, world, args, report):
    """A ``{"model": 2}`` tensor-parallel state whose sharded dimensions do
    not split evenly (7 features over 2 ranks): one Adam step, then its
    arrays through ``convert.train_state_arrays`` (c10d's all-gather, by
    ``sharding.gather_whole``) and through DTensor's ``full_tensor()``."""
    import torch

    from blendjax_torch.models import convert
    from blendjax_torch.parallel import detector_rules, make_mesh, make_sharded_train_step
    from blendjax_torch.parallel.sharding import gather_whole

    mesh = make_mesh({"model": 2}, device="cpu")
    g = torch.Generator().manual_seed(0)
    params = {"fc.w": torch.randn(5, 7, generator=g), "fc.b": torch.randn(7, generator=g),
              "head.w": torch.randn(7, 3, generator=g), "head.b": torch.randn(3, generator=g)}

    def loss_fn(p, batch):
        h = torch.tanh(batch["x"] @ p["fc.w"] + p["fc.b"])
        return torch.mean((h @ p["head.w"] + p["head.b"] - batch["y"]) ** 2)

    init, step = make_sharded_train_step(loss_fn, mesh, rules=detector_rules(), lr=1e-2)
    state = init(params)
    batch = {"x": torch.randn(4, 5, generator=g), "y": torch.randn(4, 3, generator=g)}
    state, _ = step(state, batch)
    arrays = convert.train_state_arrays(state)
    names = convert.jax_order(state.params)
    adam = [state.optimizer.state[state.params[n]] for n in names]
    full = ([_np(state.params[n].full_tensor()) for n in names]
            + [_np(s["exp_avg"].full_tensor()) for s in adam]
            + [_np(s["exp_avg_sq"].full_tensor()) for s in adam])
    p = len(names)
    report("gather", {
        "names": names,
        "placements": {n: [repr(q) for q in state.params[n].placements] for n in names},
        "local_shapes": {n: tuple(state.params[n].to_local().shape) for n in names},
        "helper": [np.asarray(a) for a in arrays[:p] + arrays[p + 1:3 * p + 1]],
        "full_tensor": full,
        "whole": {n: _np(gather_whole(state.params[n])) for n in names},
        "count": int(arrays[p]), "step": int(arrays[-1])})

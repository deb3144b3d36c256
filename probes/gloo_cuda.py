#!/usr/bin/env python3
"""Which gloo ops serve CUDA tensors.  Two rank processes on ``cuda:0`` in
a gloo process group run each group of cases below, a fresh pair of
processes per group, each case announced before it runs, so a crash names
its op and ends only its group.  Needs one CUDA card.

    python3 probes/gloo_cuda.py [GROUP ...]

Groups (all by default):

- ``collectives``: broadcast, all-reduce (f32, 4 MB, bf16), all-gather
  (c10d's, f32 and bf16), the functional collectives DTensor uses
  (all-reduce f32 and bf16; all-gather f32, uint8 and bf16) and a DTensor
  data-parallel matmul step;
- ``send_recv``, ``isend_irecv``, ``batch_isend_irecv``,
  ``all_to_all_single``: each op on CUDA tensors, f32 and bf16, at 1 MB
  and 16 MB, the received values checked;
- ``staged``: the port's own exchange (``parallel/p2p.py``) on CUDA
  tensors: a rotation of the flagship ring's K/V pair ((8, 256, 8, 128)
  bf16 each, 8 MB) and an all-to-all of one such tensor, each checked and
  timed (median of 20 calls, host clock around a synchronised call).

Prints each rank's log (``=== GROUP rank R rc=...``).  On torch 2.11 (an
H100 machine) the functional all-gather segfaults (the port avoids it:
``layers._conv``, ``parallel.sharding.shard_pytree``); the crash ends that
rank's log.  ``send``/``recv``, ``isend``/``irecv`` and
``batch_isend_irecv`` raise on CUDA tensors (``writev ... Bad address``:
gloo hands the device pointer to its socket), so ``p2p.CUDA_ROUTES``
stages the ring's rotation through pinned host buffers;
``all_to_all_single`` serves CUDA tensors, and the port's Ulysses and
zigzag exchanges call it as they are.
"""

import faulthandler
import os
import socket
import subprocess
import sys
import tempfile

faulthandler.enable()

GROUPS = ("collectives", "send_recv", "isend_irecv", "batch_isend_irecv",
          "all_to_all_single", "staged")


def p2p_cases(rank, group_name):
    """The cases of one p2p or all-to-all group: (name, fn) pairs."""
    import statistics
    import time

    import torch
    import torch.distributed as dist

    peer = 1 - rank

    def sized(mb, dtype):
        n = (mb << 20) // torch.tensor([], dtype=dtype).element_size()
        return torch.arange(n, device="cuda").to(dtype) * 0 + float(rank + 1)

    def swap(kind, mb, dtype):
        def run():
            x, y = sized(mb, dtype), torch.empty(sized(mb, dtype).shape, dtype=dtype,
                                                 device="cuda")
            if kind == "send_recv":
                if rank == 0:
                    dist.send(x, peer)
                    dist.recv(y, peer)
                else:
                    dist.recv(y, peer)
                    dist.send(x, peer)
            elif kind == "isend_irecv":
                works = [dist.isend(x, peer), dist.irecv(y, peer)]
                for w in works:
                    w.wait()
            else:
                for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                                 dist.P2POp(dist.irecv, y, peer)]):
                    w.wait()
            torch.cuda.synchronize()
            return "ok" if bool((y == float(peer + 1)).all()) else "WRONG values"
        return run

    def a2a(mb, dtype):
        def run():
            x = sized(mb, dtype)
            x[x.numel() // 2:] += 10
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
            h = x.numel() // 2
            want = torch.cat([torch.full((h,), float(1 + 10 * rank), dtype=dtype),
                              torch.full((h,), float(2 + 10 * rank), dtype=dtype)])
            return "ok" if torch.equal(y.cpu(), want) else "WRONG values"
        return run

    def staged():
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from blendjax_torch.parallel import p2p

        world = dist.group.WORLD
        g = torch.Generator(device="cuda").manual_seed(rank)
        k, v = (torch.randn((8, 256, 8, 128), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        own = [t.cpu() for t in (k, v)]
        dist.barrier()
        got = p2p.rotate([k, v], world, 1)
        # the peer's tensors, rotated back: each rank then holds its own again
        back = p2p.rotate(got, world, -1)
        ok = (all(torch.equal(a.cpu(), b) for a, b in zip(back, own))
              and not torch.equal(got[0].cpu(), own[0]))
        flat = k.reshape(-1)
        out = p2p.all_to_all_single(flat, [flat.numel() // 2] * 2, [flat.numel() // 2] * 2,
                                    world)
        ok = ok and torch.equal(out[:flat.numel() // 2].cpu() if rank == 0
                                else out[flat.numel() // 2:].cpu(),
                                flat[rank * (flat.numel() // 2):(rank + 1) * (flat.numel() // 2)]
                                .cpu())

        def timed(fn):
            times = []
            for _ in range(20):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        rot_ms = timed(lambda: p2p.rotate([k, v], world, 1))
        a2a_ms = timed(lambda: p2p.all_to_all_single(flat, [flat.numel() // 2] * 2,
                                                     [flat.numel() // 2] * 2, world))
        return {"ok": ok, "routes": p2p.CUDA_ROUTES, "rotate_kv_8mb_ms": rot_ms,
                "all_to_all_4mb_ms": a2a_ms, "counts": dict(p2p.counts)}

    if group_name == "staged":
        return [("port staged exchange", staged)]
    if group_name == "all_to_all_single":
        return [(f"all_to_all_single {mb} MB {dt}", a2a(mb, dt))
                for dt in (torch.float32, torch.bfloat16) for mb in (1, 16)]
    return [(f"{group_name} {mb} MB {dt}", swap(group_name, mb, dt))
            for dt in (torch.float32, torch.bfloat16) for mb in (1, 16)]


def rank_main(rank, port, group_name):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    def say(msg):
        print(f"rank {rank}: {msg}", flush=True)

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    torch.cuda.set_device(0)
    world = dist.group.WORLD

    def full(n, dtype=torch.float32):
        return torch.full((n,), float(rank + 1), device="cuda", dtype=dtype)

    def broadcast():
        x = full(4)
        dist.broadcast(x, src=0)
        return x.tolist()

    def all_reduce(n, dtype):
        def run():
            x = full(n, dtype)
            dist.all_reduce(x)
            return x[:4].float().tolist()
        return run

    def all_gather(dtype):
        def run():
            out = torch.empty(8, device="cuda", dtype=dtype)
            dist.all_gather_into_tensor(out, full(4, dtype))
            return out.float().tolist()
        return run

    def fc_all_reduce(dtype):
        def run():
            return funcol.wait_tensor(funcol.all_reduce(full(4, dtype), "sum", world)).float().tolist()
        return run

    def fc_all_gather(dtype):
        def run():
            return funcol.wait_tensor(funcol.all_gather_tensor(full(4, dtype), 0, world)).float().tolist()
        return run

    def dtensor_step():
        group = dist.new_group([0, 1], backend="gloo")
        mesh = DeviceMesh.from_group(group, "cuda", torch.tensor([0, 1]), mesh_dim_names=("data",))
        w = distribute_tensor(torch.ones(3, 3, device="cuda"), mesh, [Replicate()]).requires_grad_(True)
        x = DTensor.from_local(torch.full((2, 3), float(rank + 1), device="cuda"), mesh,
                               [Shard(0)], run_check=False)
        loss = (x @ w).mean()
        loss.backward()
        return [loss.full_tensor().item(), w.grad.full_tensor()[0, 0].item()]

    if group_name != "collectives":
        cases = p2p_cases(rank, group_name)
    else:
        cases = [("broadcast f32", broadcast), ("all_reduce f32", all_reduce(4, torch.float32)),
                 ("all_reduce 4 MB f32", all_reduce(1 << 20, torch.float32)),
                 ("all_reduce bf16", all_reduce(4, torch.bfloat16)),
                 ("all_gather f32", all_gather(torch.float32)),
                 ("all_gather bf16", all_gather(torch.bfloat16)),
                 ("functional all_reduce f32", fc_all_reduce(torch.float32)),
                 ("functional all_reduce bf16", fc_all_reduce(torch.bfloat16)),
                 ("dtensor data-parallel step", dtensor_step),
                 ("functional all_gather f32", fc_all_gather(torch.float32)),
                 ("functional all_gather uint8", fc_all_gather(torch.uint8)),
                 ("functional all_gather bf16", fc_all_gather(torch.bfloat16))]
    for name, fn in cases:
        say(f"{name} ...")
        try:
            out = fn()
            torch.cuda.synchronize()
            say(f"{name} -> {out}")
        except Exception as exc:  # noqa: BLE001 - the refusal is the result
            say(f"{name} raised {type(exc).__name__}: {str(exc)[:300]}")
        dist.barrier()
    dist.destroy_process_group()


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("probes/gloo_cuda.py: CUDA is not available")
    print(torch.__version__, torch.version.cuda, flush=True)
    groups = sys.argv[1:] or list(GROUPS)
    for group_name in groups:
        if group_name not in GROUPS:
            sys.exit(f"unknown group {group_name!r} (one of {GROUPS})")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logs = tempfile.mkdtemp(prefix="bjx-gloo-")
        procs = []
        for rank in range(2):
            with open(os.path.join(logs, f"{rank}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank", str(rank), str(port),
                     group_name], stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for rank, p in enumerate(procs):
            print(f"=== {group_name} rank {rank} rc={p.returncode}")
            with open(os.path.join(logs, f"{rank}.log")) as f:
                print("\n".join(ln for ln in f.read().splitlines()
                                if "hostname" not in ln)[-4000:], flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()

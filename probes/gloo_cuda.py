#!/usr/bin/env python3
"""Which gloo collectives serve CUDA tensors: two rank processes on
``cuda:0`` in a gloo process group run broadcast, all-reduce (f32, 4 MB,
bf16), all-gather (c10d's, f32 and bf16), the functional collectives
DTensor uses (all-reduce f32 and bf16; all-gather f32, uint8 and bf16) and
a DTensor data-parallel matmul step, each announced before it runs, so a
crash names its op.  Needs one CUDA card.

    python3 probes/gloo_cuda.py

Prints each rank's log (``=== rank R rc=...``).  On torch 2.11 the
functional all-gather segfaults (the port avoids it: ``layers._conv``,
``parallel.sharding.shard_pytree``); the crash ends that rank's log.
"""

import faulthandler
import os
import socket
import subprocess
import sys
import tempfile

faulthandler.enable()


def rank_main(rank, port):
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
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = tempfile.mkdtemp(prefix="bjx-gloo-")
    procs = []
    for rank in range(2):
        with open(os.path.join(logs, f"{rank}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank),
                                           str(port)], stdout=log, stderr=subprocess.STDOUT))
    for p in procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for rank, p in enumerate(procs):
        print(f"=== rank {rank} rc={p.returncode}")
        with open(os.path.join(logs, f"{rank}.log")) as f:
            print("\n".join(ln for ln in f.read().splitlines()
                            if "hostname" not in ln)[-4000:], flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), int(sys.argv[2]))
    else:
        main()

#!/usr/bin/env python3
"""The ring phase's flagship check (``chip_smoke.ring_flagship``: 4
ring_flash Adam steps of the flagship SeqFormer over a {"seq": 2} mesh
against one process's steps) on several seeds, with the SeqFormer's layer
norm through K5 and through the plain composition of tensor ops, the
arithmetic the norm had before K5.  Both sides of each comparison run in
the same rank process and take the same route, so the probe tells what the
norm's arithmetic does to the gap between the ring and one process.  Needs
one CUDA card and the CUDA toolkit.

    python3 probes/ring_norm.py [--seeds 0 1 2 3 4 5 6 7]

Spawns 2 rank processes on ``cuda:0`` over gloo, each running every
(seed, route) in turn; prints the card's name and power limit, one JSON
line per (route, seed) with the values the smoke checks beside its limits
(``chip_smoke.RING``), and a summary per route.  The plain route on seed 0
is the smoke's ring phase as it ran before K5.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

ROUTES = ("kernel", "plain")
TIMEOUT_S = 900


def rank_main(spec):
    import torch
    import torch.distributed as dist

    cfg, stage = cs._rank_world(spec, "ring_norm", TIMEOUT_S)
    from blendjax_torch.models import seqformer
    from blendjax_torch.ops import layer_norm as ln
    from blendjax_torch.parallel import make_mesh

    kernel_ln = seqformer._ln_apply

    def plain_ln(p, x):
        return ln.layer_norm_fwd_plain(x, p["scale"], p["bias"])[0]

    out = {"rank": cfg["rank"], "runs": []}
    try:
        mesh = make_mesh({"seq": cs.RING["ranks"]})
        s = mesh.get_local_rank("seq")
        t = cs.SEQ["seq_len"]
        cols = slice(s * t // cs.RING["ranks"], (s + 1) * t // cs.RING["ranks"])
        for seed in cfg["seeds"]:
            for route in ROUTES:
                stage(f"seed {seed} {route}")
                seqformer._ln_apply = kernel_ln if route == "kernel" else plain_ln
                rec = cs.ring_flagship(torch, mesh, cols, seed)
                rec["route"] = route
                out["runs"].append(rec)
    finally:
        seqformer._ln_apply = kernel_ln
        dist.destroy_process_group()
    stage("done")
    print(json.dumps(out), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args()
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    port = cs._port_block(1)
    outs = cs._spawn_ranks("--rank", [{"rank": r, "world": cs.RING["ranks"], "port": port,
                                       "seeds": args.seeds}
                                      for r in range(cs.RING["ranks"])],
                           TIMEOUT_S, "ring_norm", script=__file__)
    keys = ("loss_max_rel_diff", "first_grad_err", "param_max_abs_diff_where_well",
            "well_share")
    summary = {route: {"seeds": [], "over_loss_rtol": 0} for route in ROUTES}
    for i, rec in enumerate(outs[0]["runs"]):
        other = outs[1]["runs"][i]
        cs.emit({"route": rec["route"], "seed": rec["seed"], "losses": rec["losses"],
                 "single_losses": rec["single_losses"],
                 **{k: [rec[k], other[k]] for k in keys},
                 "ln_launches": [rec["ln_launches"], other["ln_launches"]],
                 "within_limits": [cs.ring_flagship_ok(r) for r in (rec, other)]})
        sm = summary[rec["route"]]
        sm["seeds"].append(rec["seed"])
        sm["over_loss_rtol"] += max(rec["loss_max_rel_diff"],
                                    other["loss_max_rel_diff"]) > cs.RING["loss_rtol"]
        sm.setdefault("loss_max_rel_diff", []).append(
            max(rec["loss_max_rel_diff"], other["loss_max_rel_diff"]))
    for route, sm in summary.items():
        sm["median"] = sorted(sm["loss_max_rel_diff"])[len(sm["loss_max_rel_diff"]) // 2]
    cs.emit({"phase": "ring_norm", "limits": cs.RING, "summary": summary,
             "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())

"""K3 and K4, the flash backward (dQ, then dK and dV): the sum of their
rooflines' least times over their profiled device time, per backward
(one call of each), in %."""

from portbench.harness.work import flash_work, least_seconds


def read(ctx):
    tr, peak = ctx["traced"], ctx["peak"]
    if tr is None or peak is None or "flash_bwd" not in tr["by_class"]:
        return None
    cfg, traffic = ctx["config"], ctx["traffic"]
    seconds, calls = tr["by_class"]["flash_bwd"]
    h = cfg["n_heads"]
    work = flash_work(traffic["batch"], traffic["seq_len"], h, cfg["d_model"] // h, 2)
    least = sum(least_seconds(*work[k], peak) for k in ("flash_dq", "flash_dkv"))
    return 100.0 * least / (seconds / (calls / 2))

"""K2, the flash forward: its roofline's least time per call (the larger
of its causal FLOPs over the bf16 peak and its bytes, each input read and
each output written once, over HBM's rate) over its profiled device time
per call, in %."""

from portbench.harness.work import flash_work, least_seconds


def read(ctx):
    tr, peak = ctx["traced"], ctx["peak"]
    if tr is None or peak is None or "flash_fwd" not in tr["by_class"]:
        return None
    cfg, traffic = ctx["config"], ctx["traffic"]
    seconds, calls = tr["by_class"]["flash_fwd"]
    h = cfg["n_heads"]
    flops, nbytes = flash_work(traffic["batch"], traffic["seq_len"], h, cfg["d_model"] // h,
                               2)["flash_fwd"]
    return 100.0 * least_seconds(flops, nbytes, peak) / (seconds / calls)

"""The whole training step's share of the card's bf16 peak: the work the
model requires (``harness/work.py``, from the configuration alone) times
the window's steps, over the window's seconds and the peak."""

from portbench.harness.work import train_flops


def read(ctx):
    peak, win = ctx["peak"], ctx["window"]
    if peak is None or not win["steps"]:
        return None
    flops = train_flops(ctx["config"], ctx["traffic"]["batch"], ctx["traffic"]["seq_len"])
    return 100.0 * flops * win["steps"] / win["seconds"] / peak["bf16_flops_per_s"]

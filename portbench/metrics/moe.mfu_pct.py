"""The Moonlight training step's share of the card's bf16 peak: the work
the model requires (``harness/work_mla_moe.py``, from the configuration
alone; the routed experts at their expected assignments) times the
window's steps, over the window's seconds and the peak."""

from portbench.harness.work_mla_moe import train_flops


def read(ctx):
    peak, win = ctx["peak"], ctx["window"]
    if peak is None or not win["steps"] or "kv_lora_rank" not in ctx["config"]:
        return None
    flops = train_flops(ctx["config"], ctx["traffic"]["batch"], ctx["traffic"]["seq_len"])
    return 100.0 * flops * win["steps"] / win["seconds"] / peak["bf16_flops_per_s"]

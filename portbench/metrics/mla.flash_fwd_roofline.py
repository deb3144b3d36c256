"""K2, the flash forward, at latent attention's head dims (q/k
``qk_nope_head_dim + qk_rope_head_dim``, v ``v_head_dim``): its
roofline's least time per call (``harness/work_mla_moe.flash_work``, each
tensor at its own width, causal) over its profiled device time per call,
in %."""

from portbench.harness.work import least_seconds
from portbench.harness.work_mla_moe import flash_work


def read(ctx):
    tr, peak, cfg = ctx["traced"], ctx["peak"], ctx["config"]
    if tr is None or peak is None or "flash_fwd" not in tr["by_class"] or "kv_lora_rank" not in cfg:
        return None
    seconds, calls = tr["by_class"]["flash_fwd"]
    traffic = ctx["traffic"]
    flops, nbytes = flash_work(traffic["batch"], traffic["seq_len"], cfg["num_attention_heads"],
                               cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                               cfg["v_head_dim"], 2)["flash_fwd"]
    return 100.0 * least_seconds(flops, nbytes, peak) / (seconds / calls)

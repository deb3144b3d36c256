"""K3 and K4, the flash backward (dQ, then dK and dV), at latent
attention's head dims: the sum of their rooflines' least times
(``harness/work_mla_moe.flash_work``) over their profiled device time,
per backward (one call of each), in %."""

from portbench.harness.work import least_seconds
from portbench.harness.work_mla_moe import flash_work


def read(ctx):
    tr, peak, cfg = ctx["traced"], ctx["peak"], ctx["config"]
    if tr is None or peak is None or "flash_bwd" not in tr["by_class"] or "kv_lora_rank" not in cfg:
        return None
    seconds, calls = tr["by_class"]["flash_bwd"]
    traffic = ctx["traffic"]
    work = flash_work(traffic["batch"], traffic["seq_len"], cfg["num_attention_heads"],
                      cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"], 2)
    least = sum(least_seconds(*work[k], peak) for k in ("flash_dq", "flash_dkv"))
    return 100.0 * least / (seconds / (calls / 2))

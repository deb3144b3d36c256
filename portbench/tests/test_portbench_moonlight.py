"""The Moonlight cell (``moe_train``) through the harness on the CPU at a
small size: a run is correct against the reference, each planted fault
is not, the fp8 control is not, and the yardstick's counts of the
configuration by hand.  The cell's own configuration and traffic with
every width and count cut down under the configuration's own keys; the
harness's small-size keys (``_tiny.overrides``, which the faults and the
control tests hand every cell) fold into the same."""

import subprocess
import sys

import pytest
from _tiny import SEED, SPEC
from _tiny import overrides as small_keys

from portbench.harness import cell, correct, weights_mla, work_mla_moe
from portbench.harness.spec import ROOT, program
from portbench.readings import readings

CELL = "moe_train"


def overrides():
    cfg = dict(SPEC.config(SPEC.cell(CELL)["config"]), hidden_size=64, num_attention_heads=4,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
               intermediate_size=128, moe_intermediate_size=32, router_experts=8,
               n_routed_experts=2, num_experts_per_tok=2, num_hidden_layers=3,
               max_position_embeddings=32)
    traffic = dict(SPEC.traffic(SPEC.cell(CELL)["traffic"]), seq_len=32, batch=4,
                   pool_batches=4)
    return {"config": cfg, "traffic": traffic}


def test_portbench_moonlight_runs_correct_at_a_small_size():
    res = cell.run(SPEC, CELL, SEED, 0.3, False, device="cpu", overrides=overrides())
    assert res["correct"] is True, res["compared"]
    assert res["window"]["steps"] > 0 and res["window"]["failed"] == 0


def test_portbench_moonlight_run_and_reference_load_no_jax():
    body = ("import sys; sys.path.insert(0, 'portbench/tests'); "
            "import portbench.reference.mla_moe, portbench.harness.weights_mla; "
            "import test_portbench_moonlight as t; "
            "from portbench.harness import cell; "
            "res = cell.run(t.SPEC, t.CELL, 5, 0.2, False, device='cpu', overrides=t.overrides()); "
            "assert res['leaked'] == [] and res['correct'] is True, res")
    out = subprocess.run([sys.executable, "-c", body], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_portbench_moonlight_broken_timed_path_is_not_correct(fault):
    res = cell.run(SPEC, CELL, SEED, 0.3, False, device="cpu", fault=fault,
                   overrides=overrides())
    assert res["correct"] is False, res["compared"]


def test_portbench_moonlight_control_is_not_correct():
    recs = readings(CELL, [], [5, 6, 7], device="cpu", overrides=overrides(),
                    emit=lambda line: None)
    controls = [r for r in recs if r["kind"] == "control"]
    assert len(controls) == 3
    assert all(not correct.verdict(r, SPEC.limits(CELL))[0] for r in controls)


def test_portbench_moonlight_sizes_are_the_published_ones():
    cfg = SPEC.config("moonlight_16b_a3b")
    assert (cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]) == (
        2048, 16, 512, 128, 64, 128)
    assert (cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["router_experts"],
            cfg["num_experts_per_tok"], cfg["n_shared_experts"]) == (11264, 1408, 64, 6, 2)
    assert cfg["published"] == {"num_hidden_layers": 27, "n_routed_experts": 64}
    assert weights_mla.count(cfg) == cfg["parameters"] == 484_731_424


def test_portbench_moonlight_step_flops_by_hand():
    cfg = SPEC.config("moonlight_16b_a3b")
    n, t = 65536, 8192
    proj = 2 * (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048)  # 27.5M
    core = 2 * (8 * 16 * t * (t + 1) // 2) * (192 + 128) // n  # 41.9M a token
    dense = 6 * 2048 * 11264
    moe = 2 * 2048 * 64 + 6 * 2048 * 2816 + 6 * 6 * 2048 * 1408 * 8 // 64
    ends = 4 * 32 * 2048
    fwd = n * (5 * (proj + core) + dense + 4 * moe + ends)
    assert work_mla_moe.train_flops(cfg, 8, t) == 3 * fwd
    assert abs(work_mla_moe.train_flops(cfg, 8, t) / 1e12 - 133.18) < 0.01


def test_portbench_moonlight_takes_the_harness_small_keys():
    cfg = program("moonlight_train").resolve(small_keys(CELL)["config"])
    assert (cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"],
            cfg["num_hidden_layers"], cfg["max_position_embeddings"]) == (64, 2, 128, 2, 32)
    assert cfg["kv_lora_rank"] == 512 and cfg["router_experts"] == 64

"""The yardstick's FLOP and byte counts against hand-worked values."""

from portbench.harness import work

TINY = {"obs_dim": 2, "d_model": 4, "n_heads": 2, "n_layers": 1, "d_ff": 8}


def test_portbench_causal_pairs_by_hand():
    # T = 3: pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) = 6 per head and row
    assert work.causal_pairs(1, 3, 1) == 6
    assert work.causal_pairs(2, 3, 2) == 24


def test_portbench_dense_forward_by_hand():
    # B 1, T 3, N 3 tokens, d 4, Dh 2, obs 2, d_ff 8
    embed = 2 * 3 * 2 * 4  # 48
    qkvo = 2 * 3 * 4 * 4 * 4  # 384
    attn = 2 * 2 * 12 * 2  # 12 causal pairs over 2 heads, QK^T and PV: 96
    mlp = 2 * 2 * 3 * 4 * 8  # 384
    head = 2 * 3 * 4 * 2  # 48
    assert work.forward_flops(TINY, 1, 3) == embed + qkvo + attn + mlp + head == 960
    assert work.train_flops(TINY, 1, 3) == 3 * 960


def test_portbench_big_counts():
    # B 128, T 512: 65,536 tokens; d 1024, 16 heads of 64, d_ff 4096, 6 layers
    cfg = {"obs_dim": 32, "d_model": 1024, "n_heads": 16, "n_layers": 6, "d_ff": 4096}
    qkvo = 2 * 65536 * 1024 * 1024 * 4  # 549,755,813,888
    attn = 2 * 2 * (128 * 16 * 512 * 513 // 2) * 64  # 68,853,694,464
    mlp = 2 * 2 * 65536 * 1024 * 4096  # 1,099,511,627,776
    ends = 2 * 2 * 65536 * 32 * 1024  # embedding and head: 8,589,934,592
    assert work.train_flops(cfg, 128, 512) == 3 * (6 * (qkvo + attn + mlp) + ends)
    assert work.train_flops(cfg, 128, 512) == 30_951_950_254_080


def test_portbench_flash_work_by_hand():
    # B 1, T 2, H 1, Dh 4, bf16: 3 causal pairs, a tile 16 bytes, rows 8 bytes
    w = work.flash_work(1, 2, 1, 4, 2)
    assert w["flash_fwd"] == (2 * 2 * 3 * 4, 4 * 16 + 8)
    assert w["flash_dq"] == (3 * 2 * 3 * 4, 5 * 16 + 16)
    assert w["flash_dkv"] == (4 * 2 * 3 * 4, 6 * 16 + 16)


def test_portbench_least_seconds_takes_the_larger_bound():
    peak = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert work.least_seconds(2e12, 1e6, peak) == 2.0
    assert work.least_seconds(1e6, 3e9, peak) == 3.0

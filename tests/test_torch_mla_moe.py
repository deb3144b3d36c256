"""The DeepSeek-V3 blocks of the SeqFormer (multi-head latent attention,
RMSNorm, DeepSeekMoE with sigmoid routing, its bias balancing and shared
experts) on the CPU at a small size: against the benchmark's plain float32
reference (``portbench/reference/mla_moe.py``), the routing's rules, the
held share of a layer against the whole layer, the bias step and the
sequence-wise balance loss, K5's RMS plain passes, the flash plain passes
at q/k and v head dims that differ, and the held experts' grouped
products against a product an expert.

The small size: d 64, 4 heads of q/k 24 (16 + 8 rotary) and v 16, a
latent of 32, 8 routed experts of which 2 are held, 2 a token, 2 shared.
Tolerances: the program and the reference compute in float32 here and
differ by the order of their sums (1e-5 relative on the loss, 1e-4 on a
gradient beside 1e-6 of the largest)."""

import math

import numpy as np
import pytest
import torch

from blendjax_torch.models import moe, seqformer
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.ops import flash_attention as flash
from blendjax_torch.ops import layer_norm as ln
from blendjax_torch.parallel.ring_attention import full_attention
from portbench.harness import weights_mla
from portbench.reference import mla_moe as ref

CFG = {
    "obs_dim": 8, "hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32, "num_hidden_layers": 3,
    "first_k_dense_replace": 1, "intermediate_size": 96, "moe_intermediate_size": 32,
    "n_routed_experts": 2, "router_experts": 8, "n_shared_experts": 2,
    "num_experts_per_tok": 2, "first_held_expert": 0, "routed_scaling_factor": 2.446,
    "rms_norm_eps": 1e-5, "kv_norm_eps": 1e-6, "rope_theta": 50000.0, "balance_alpha": 1e-4,
    "bias_update_speed": 1e-3, "lr": 1e-3,
}
MLA = {"kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
       "n_dense": 1, "dense_ff": 96, "moe_ff": 32, "n_routed": 8, "n_shared": 2}


def _arch(cfg=CFG, balance=None):
    return {"norm_eps": cfg["rms_norm_eps"], "kv_norm_eps": cfg["kv_norm_eps"],
            "rope_theta": cfg["rope_theta"], "moe_k": cfg["num_experts_per_tok"],
            "moe_scale": cfg["routed_scaling_factor"], "moe_experts": cfg["router_experts"],
            "moe_first": cfg["first_held_expert"], "balance_alpha": cfg["balance_alpha"], "balance": balance}


def _episodes(seed, b=3, t=16, obs=8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, t + 1, obs)).astype(np.float32))


def _loss(params, ep, arch):
    return seqformer.episode_loss_fn(params, {"episode": ep}, compute_dtype=torch.float32,
                                     arch=arch)


def _weights(seed):
    """The benchmark's weights at the small size, and routing biases of the
    size of the scores' spread for each MoE layer (so that they move the
    choice): (parameters, {layer: bias})."""
    p = weights_mla.make(CFG, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    return p, {f"blocks.{i}": 0.05 * torch.randn(8, generator=g) for i in (1, 2)}


def _balance(biases):
    balance = moe.Balance(sorted(biases), 8, 2, CFG["bias_update_speed"], "cpu")
    for layer, b in biases.items():
        balance.layers[layer]["bias"].copy_(b)
    return balance


def test_init_mla_follows_the_benchmark_layout():
    got = seqformer.init(torch.Generator().manual_seed(0), obs_dim=8, d_model=64, n_heads=4,
                         n_layers=3, device="cpu", mla=dict(MLA, n_routed=2))
    want = {p: shape for p, shape, _ in weights_mla.layout(dict(CFG, router_experts=2))}
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert weights_mla.count(CFG) == sum(math.prod(s) for _, s, _ in weights_mla.layout(CFG))


def test_mla_attention_matches_the_reference():
    p, _ = _weights(3)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    tree = seqformer._nest(p)
    blk = seqformer._blocks(tree)[0]
    cos, sin = seqformer.rope_table(torch.arange(16), 8, base=CFG["rope_theta"])
    attn = lambda q, k, v: full_attention(q, k, v, causal=True)  # noqa: E731
    h = ref.rms_norm(x, p["blocks.0.attn_norm.scale"], CFG["rms_norm_eps"])
    got = seqformer._mla(blk, x, attn, cos, sin, torch.float32, _arch())
    want = ref.mla(p, "blocks.0", h, CFG, ref._same)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_loss_and_gradients_match_the_reference(attn):
    p, biases = _weights(5)
    ep = _episodes(5)
    attn_fn = None if attn == "full" else flash.make_flash_attention(block_q=16, block_kv=16)
    mine = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    theirs = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want, _ = ref.episode_loss(mine, ep, CFG, biases)
    got = seqformer.episode_loss_fn(theirs, {"episode": ep}, compute_dtype=torch.float32,
                                    attn_fn=attn_fn, arch=_arch(balance=_balance(biases)))
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    gw = torch.autograd.grad(want, list(mine.values()))
    gg = torch.autograd.grad(got, list(theirs.values()))
    scale = max(float(g.abs().max()) for g in gw)
    for k, a, b in zip(mine, gw, gg):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * scale), k


def test_the_train_step_and_its_bias_step_match_the_reference():
    p, biases = _weights(6)
    batches = [_episodes(6 + i) for i in range(3)]
    balance = _balance(biases)
    arch = _arch(balance=balance)
    state = TrainState.create({k: v.clone() for k, v in p.items()}, lr=CFG["lr"])
    step = make_train_step(lambda params, b: _loss(params, b["episode"], arch), balance=balance)
    losses = []
    for ep in batches:
        state, loss = step(state, {"episode": ep})
        losses.append(float(loss))
    out = ref.train_readings({k: v.clone() for k, v in p.items()}, batches, CFG, CFG["lr"],
                             biases=biases)
    for a, b in zip(losses, out["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    for k in ref_moving(out):
        moved = float(torch.linalg.vector_norm(state.params[k].detach() - p[k]))
        assert abs(moved - out["change_norms"][k]) <= 1e-3 * out["change_norms"][k], k
    assert int(balance.updates) == 3
    for layer, bufs in balance.layers.items():
        moved = (bufs["bias"] - biases[layer]) / CFG["bias_update_speed"]
        # three steps of +-gamma each (0 where a load met the mean)
        assert float((moved - moved.round()).abs().max()) < 1e-3
        assert 0 < float(moved.abs().max()) <= 3 + 1e-3 and float(bufs["load"].abs().sum()) == 0


def test_the_bias_step_moves_each_bias_by_gamma_a_step():
    p, _ = _weights(7)
    balance = moe.Balance(["blocks.1", "blocks.2"], 8, 2, CFG["bias_update_speed"], "cpu")
    arch = _arch(balance=balance)
    state = TrainState.create(p, lr=CFG["lr"])
    step = make_train_step(lambda params, b: _loss(params, b["episode"], arch), balance=balance)
    for i in range(3):
        step(state, {"episode": _episodes(20 + i)})
    for bufs in balance.layers.values():
        b = bufs["bias"] / CFG["bias_update_speed"]
        # from zero, three steps of +-gamma each (0 where a load met the mean)
        assert float((b - b.round()).abs().max()) < 1e-4 and float(b.abs().max()) <= 3


def test_balancing_bias_balances_a_collapsed_router():
    g = torch.Generator().manual_seed(21)
    # a shared direction in every token: nearly all of them choose the same experts
    common = torch.randn(64, generator=g)
    x = common + 0.3 * torch.randn(4096, 64, generator=g)
    scores = torch.sigmoid(x @ (torch.randn(64, 16, generator=g) / 8))
    balance = moe.Balance(["a"], 16, 16, 0.01, "cpu")
    bufs = balance.layers["a"]

    def loads(b):
        idx, _ = moe.sigmoid_topk(scores, b, 4)
        return torch.zeros(16).scatter_add_(0, idx.reshape(-1), torch.ones(idx.numel()))

    before = loads(bufs["bias"])
    for _ in range(300):
        # the bias step from the loads of the step's choices, as the train step runs it
        bufs["load"].copy_(loads(bufs["bias"]))
        balance.update()
    after = loads(bufs["bias"])
    assert float(before.max() / before.mean()) > 2.5
    assert float(after.max() / after.mean()) < 1.25 and float(after.min() / after.mean()) > 0.75


def ref_moving(out):
    from portbench.harness.correct import moving_leaves

    return moving_leaves(out["grad_norms"])


def test_selection_uses_the_biased_scores_and_weights_the_unbiased():
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.1], [0.2, 0.6, 0.5, 0.4]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.75])
    idx, w = moe.sigmoid_topk(scores, bias, 2)
    assert idx.tolist() == [[0, 3], [3, 1]]
    assert torch.allclose(w[0], torch.tensor([0.9, 0.1]) / 1.0)
    assert torch.allclose(w[1], torch.tensor([0.4, 0.6]) / 1.0)


def test_ties_go_to_the_lower_expert():
    scores = torch.full((3, 8), 0.5)
    scores[1, 6] = 0.5 + 1e-3
    idx, w = moe.sigmoid_topk(scores, torch.zeros(8), 3)
    assert idx[0].tolist() == [0, 1, 2]
    assert idx[1].tolist() == [6, 0, 1]
    assert torch.allclose(w.sum(-1), torch.ones(3))


def _layer(seed, d=64, e=8, held=8, f=32, first=0):
    g = torch.Generator().manual_seed(seed)
    full = {"gate": {"w": torch.randn(d, e, generator=g) / math.sqrt(d)},
            "w1": torch.randn(e, d, f, generator=g) / math.sqrt(d),
            "w3": torch.randn(e, d, f, generator=g) / math.sqrt(d),
            "w2": torch.randn(e, f, d, generator=g) / math.sqrt(f),
            "shared": {"w1": torch.randn(d, 2 * f, generator=g) / math.sqrt(d),
                       "w3": torch.randn(d, 2 * f, generator=g) / math.sqrt(d),
                       "w2": torch.randn(2 * f, d, generator=g) / math.sqrt(2 * f)}}
    return full


def _held(full, first, held):
    out = dict(full)
    for k in ("w1", "w3", "w2"):
        out[k] = full[k][first:first + held]
    return out


def _ref_layer(full, x, first, held, k=2, bias=None):
    """The reference's layer over flat params holding experts first..first+held."""
    e = full["gate"]["w"].shape[1]
    p = {"blocks.1.moe.gate.w": full["gate"]["w"]}
    for n in ("w1", "w3", "w2"):
        p[f"blocks.1.moe.{n}"] = full[n][first:first + held]
        p[f"blocks.1.moe.shared.{n}"] = full["shared"][n]
    cfg = dict(CFG, router_experts=e, n_routed_experts=held, first_held_expert=first,
               num_experts_per_tok=k)
    return ref.deepseek_moe(p, "blocks.1", x, cfg, torch.zeros(e) if bias is None else bias,
                            1, ref._same)


def _state(bias):
    state = moe.Balance(["blocks.1"], 8, 2, 1e-3, "cpu").layers["blocks.1"]
    state["bias"].copy_(bias)
    return state


def test_the_layer_matches_the_reference_and_drops_no_row():
    full = _layer(1)
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(2))
    balance = moe.Balance(["blocks.1"], 8, 2, 1e-3, "cpu")
    state = balance.layers["blocks.1"]
    got, aux = moe.deepseek_moe_apply(_held(full, 2, 2), x, torch.float32, 2, 2.446, 2, 8,
                                      state=state)
    want, load, _ = _ref_layer(full, x, 2, 2)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(state["load"], load)
    assert int(aux["rows"].sum()) == int(load[2:4].sum())


def test_a_skewed_router_within_the_bound_drops_no_row():
    # every token's first choice is a held expert: 4x the held experts'
    # expected rows (n * k * held / e)
    full = _layer(3)
    full["gate"]["w"][:, 0] += 0.0
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(4))
    held_p = _held(full, 0, 2)
    bias = torch.zeros(8)
    bias[0] = 10.0  # the choice only: every token takes expert 0 first
    state = _state(bias)
    got, aux = moe.deepseek_moe_apply(held_p, x, torch.float32, 2, 2.446, 0, 8, state=state)
    want, load, _ = _ref_layer(full, x, 0, 2, bias=bias)
    assert int(load[0]) == 64 and aux["rows"].tolist() == [64, int(load[1])]
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_every_token_on_every_held_expert_fits_the_arena():
    full = _layer(5)
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(6))
    bias = torch.zeros(8)
    bias[:2] = 10.0  # every token takes both held experts: 4x their expected rows
    state = _state(bias)
    got, aux = moe.deepseek_moe_apply(_held(full, 0, 2), x, torch.float32, 2, 2.446, 0, 8,
                                      state=state)
    want, load, _ = _ref_layer(full, x, 0, 2, bias=bias)
    # n * min(k, held) rows: each token's two choices, both held
    assert moe.arena_rows(64, 2, 2) == 128
    assert aux["rows"].tolist() == [64, 64] and int(load[:2].sum()) == 128
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_the_rows_past_the_routed_ones_reach_no_output_or_gradient(monkeypatch):
    # whatever the grouped product leaves in the arena's unrouted rows (NaN
    # here) reaches neither the layer's output nor a gradient
    real = moe.grouped_mm

    def poisoned(x, w, ends):
        y = real(x, w, ends)
        used = torch.arange(y.shape[0])[:, None] < ends[-1]
        return torch.where(used, y, torch.full_like(y, float("nan")))

    full = _layer(13)
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(14), requires_grad=True)
    held = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) else
                {n: t.clone().requires_grad_(True) for n, t in v.items()})
            for k, v in _held(full, 2, 2).items()}
    want, _ = moe.deepseek_moe_apply(held, x, torch.float32, 2, 2.446, 2, 8)
    monkeypatch.setattr(moe, "grouped_mm", poisoned)
    got, _ = moe.deepseek_moe_apply(held, x, torch.float32, 2, 2.446, 2, 8)
    assert torch.equal(got, want)
    leaves = [x, held["w1"], held["w3"], held["w2"], held["gate"]["w"]]
    for g in torch.autograd.grad(got.square().sum(), leaves):
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("held", [1, 2, 4])
def test_the_held_shares_add_up_to_the_uncut_layer(held):
    full = _layer(7)
    x = torch.randn(48, 64, generator=torch.Generator().manual_seed(8))
    uncut, _, _ = _ref_layer(full, x, 0, 8)
    shared = moe._swiglu(full["shared"], x, torch.float32)
    parts = [moe.deepseek_moe_apply(_held(full, first, held), x, torch.float32, 2, 2.446,
                                    first, 8)[0] - shared for first in range(0, 8, held)]
    assert torch.allclose(sum(parts) + shared, uncut, rtol=1e-5, atol=1e-5)
    ref_parts = [_ref_layer(full, x, first, held)[0] - shared for first in range(0, 8, held)]
    assert torch.allclose(sum(ref_parts) + shared, uncut, rtol=1e-5, atol=1e-5)


def test_the_bias_step_has_the_published_sign_and_size():
    balance = moe.Balance(["a"], 4, 2, 0.001, "cpu")
    bufs = balance.layers["a"]
    bufs["load"].copy_(torch.tensor([10.0, 2.0, 4.0, 0.0]))  # mean 4
    balance.update()
    assert torch.allclose(bufs["bias"], torch.tensor([-0.001, 0.001, 0.0, 0.001]))
    assert float(bufs["max_over_mean"]) == 2.5
    assert float(bufs["load"].sum()) == 0 and int(balance.updates) == 1
    ref_b = {"a": torch.zeros(4)}
    ref.balance_step(ref_b, {"a": torch.tensor([10.0, 2.0, 4.0, 0.0])}, 0.001)
    assert torch.equal(ref_b["a"], bufs["bias"])
    read = balance.read()["layers"]["a"]
    assert read["bias_spread"] == pytest.approx(0.002)


def test_the_sequence_balance_loss_by_hand():
    # 2 sequences of 2 tokens, 4 experts, top 1
    scores = torch.tensor([[0.5, 0.25, 0.125, 0.125], [0.25, 0.5, 0.125, 0.125],
                           [0.5, 0.5, 0.5, 0.5], [0.1, 0.1, 0.1, 0.7]])
    idx = torch.tensor([[0], [1], [2], [3]])
    got = moe.sequence_balance_loss(scores, idx, 2, 1)
    # sequence 0: f = 4/2 * [1, 1, 0, 0]; P = mean of the normalised rows
    p0 = (torch.tensor([0.5, 0.25, 0.125, 0.125]) + torch.tensor([0.25, 0.5, 0.125, 0.125])) / 2
    p1 = (torch.full((4,), 0.25) + torch.tensor([0.1, 0.1, 0.1, 0.7])) / 2
    f0, f1 = torch.tensor([2.0, 2.0, 0, 0]), torch.tensor([0, 0, 2.0, 2.0])
    want = ((f0 * p0).sum() + (f1 * p1).sum()) / 2
    assert torch.allclose(got, want)
    # uniform routing and scores give 1
    even = torch.full((8, 4), 0.3)
    idx = torch.arange(8).remainder(4)[:, None]
    assert float(moe.sequence_balance_loss(even, idx, 2, 1)) == pytest.approx(1.0)


def test_arena_rows_bound_the_total_with_each_expert_aligned():
    # 65,536 tokens, 6 a token, 8 held: each token's 6 choices
    assert moe.arena_rows(65536, 6, 8) == 393216
    # fewer held experts than choices: a token takes each of them once
    assert moe.arena_rows(64, 6, 2) == 128
    # the arena: the held assignments grouped by expert, each in token order,
    # then the zero row; the ends of the experts' segments
    idx = torch.tensor([[3, 0], [2, 3], [0, 1], [3, 2]])
    weights = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 1
    tok, w, ends, counts = moe._held_dispatch(idx, weights, 2, 2, moe.arena_rows(4, 2, 2))
    assert tok.tolist() == [1, 3, 0, 1, 3, 4, 4, 4]
    assert w.tolist() == [3.0, 8.0, 1.0, 4.0, 7.0, 0.0, 0.0, 0.0]
    assert ends.tolist() == [2, 5] and counts.tolist() == [2, 3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_plain_forward_and_backward(dtype):
    g = torch.Generator().manual_seed(9)
    x = (torch.randn(33, 96, generator=g) * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(96, generator=g)
    dy = torch.randn(33, 96, generator=g).to(dtype)
    y, rstd = ln.rms_norm_fwd_plain(x, scale, 1e-5)
    x32 = x.float().requires_grad_(True)
    s = scale.clone().requires_grad_(True)
    want = x32 / torch.sqrt((x32 ** 2).mean(-1, keepdim=True) + 1e-5) * s
    assert y.dtype == dtype and torch.allclose(y.float(), want.detach().to(dtype).float())
    assert torch.allclose(rstd, torch.rsqrt((x.float() ** 2).mean(-1) + 1e-5))
    dx, dscale = ln.rms_norm_bwd_plain(dy, x, rstd, scale)
    gx, gs = torch.autograd.grad(want, (x32, s), dy.float())
    assert dx.dtype == dtype
    assert torch.allclose(dx.float(), gx.to(dtype).float(), rtol=1e-2 if dtype != torch.float32
                          else 1e-5, atol=1e-5)
    assert torch.allclose(dscale, gs, rtol=1e-5, atol=1e-5)


def test_rms_norm_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ln.rms_norm_fwd_cuda(x, torch.ones(64), 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        ln.rms_norm_bwd_cuda(x, x, torch.ones(4), torch.ones(64))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 5)])
def test_flash_plain_passes_at_split_head_dims(causal, window):
    g = torch.Generator().manual_seed(10)
    b, t, h, dq, dv = 2, 32, 3, 24, 16
    q, k = (torch.randn(b, t, h, dq, generator=g, requires_grad=True) for _ in range(2))
    v = torch.randn(b, t, h, dv, generator=g, requires_grad=True)
    do = torch.randn(b, t, h, dv, generator=g)
    got = flash.flash_attention(q, k, v, causal=causal, block_q=16, block_kv=16, window=window)
    want = full_attention(q, k, v, causal=causal, window=window)
    assert got.shape == (b, t, h, dv)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    gg = torch.autograd.grad(got, (q, k, v), do)
    gw = torch.autograd.grad(want, (q, k, v), do)
    for a, w in zip(gg, gw):
        assert a.shape == w.shape and torch.allclose(a, w, rtol=1e-4, atol=1e-5)


def test_flash_route_takes_the_split_dims_on_the_tensor_cores_only():
    assert flash.kernel_route(torch.bfloat16, 192, dv=128) == "tc"
    with pytest.raises(ValueError, match="tensor-core kernels only"):
        flash.kernel_route(torch.float32, 192, dv=128)
    with pytest.raises(ValueError, match="has no kernel"):
        flash.kernel_route(torch.bfloat16, 192, dv=64)
    with pytest.raises(ValueError, match="has no kernel"):
        flash.kernel_route(torch.bfloat16, 192)


def test_grouped_products_plain_passes():
    g = torch.Generator().manual_seed(11)
    ends = torch.tensor([3, 3, 133], dtype=torch.int32)
    x = torch.randn(160, 16, generator=g, requires_grad=True)
    w = torch.randn(3, 16, 8, generator=g, requires_grad=True)
    dy = torch.randn(133, 8, generator=g)
    y = moe.grouped_mm(x, w, ends)[:133]
    assert torch.allclose(y[:3], x[:3] @ w[0]) and torch.allclose(y[3:], x[3:133] @ w[2])
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert torch.allclose(dx[:3], dy[:3] @ w[0].T, atol=1e-5)
    assert torch.allclose(dx[3:133], dy[3:] @ w[2].T, atol=1e-5)
    assert torch.allclose(dw[0], x[:3].T @ dy[:3], atol=1e-5)
    assert float(dw[1].abs().sum()) == 0
    assert torch.allclose(dw[2], x[3:133].T @ dy[3:], atol=1e-4)


@pytest.mark.parametrize("what", ["decode_step", "rollout", "init_cache"])
def test_the_decode_path_refuses_mla_params(what):
    p = seqformer.init(torch.Generator().manual_seed(0), obs_dim=8, d_model=64, n_heads=4,
                       n_layers=2, device="cpu", mla=MLA)
    with pytest.raises(ValueError, match="latent attention"):
        if what == "decode_step":
            seqformer.decode_step(p, {"k": [], "v": [], "pos": 0}, torch.zeros(1, 8))
        elif what == "rollout":
            seqformer.rollout(p, torch.zeros(1, 4, 8), 2)
        else:
            seqformer.init_cache(p, 1, length=8)


def test_mla_params_need_the_arch():
    p = seqformer.init(torch.Generator().manual_seed(0), obs_dim=8, d_model=64, n_heads=4,
                       n_layers=2, device="cpu", mla=MLA)
    with pytest.raises(ValueError, match="arch="):
        seqformer.apply(p, torch.zeros(1, 4, 8), compute_dtype=torch.float32)
    out = seqformer.apply(p, torch.zeros(1, 4, 8), compute_dtype=torch.float32,
                          arch=_arch(dict(CFG, n_routed_experts=8)))
    assert out.shape == (1, 4, 8) and bool(torch.isfinite(out).all())


def test_an_eager_mla_step_puts_its_ops_in_the_moe_regions():
    from torch.profiler import ProfilerActivity, profile

    from blendjax_torch.obs import regions

    p, biases = _weights(12)
    balance = _balance(biases)
    arch = _arch(balance=balance)
    state = TrainState.create(p, lr=1e-3)
    step = make_train_step(lambda params, b: _loss(params, b["episode"], arch), balance=balance)
    state, _ = step(state, {"episode": _episodes(12)})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, {"episode": _episodes(13)})
    table = regions.kernel_table(list(prof.events()))
    seen = {r for _, r in table}
    assert set(regions.MOE) | {"seqformer.norm", "seqformer.attention", "seqformer.mlp",
                               "seqformer.io", "train.backward", "train.adam",
                               "train.balance"} <= seen
    assert all(r is None or r in regions.NAMES for r in seen)

"""The DeepSeek-V3 blocks on the card: the held experts' grouped products
(torch's, forward, input gradient, weight gradient) against a bf16 product
an expert at Moonlight-16B-A3B's expert widths, the DeepSeekMoE layer and a small
DeepSeek-V3 SeqFormer's training step through them (K2-K4 at q/k 192 and
v 128, K5's RMS mode), captured against eager.  Needs an NVIDIA card: every
test skips without one.  Run on the card:

    python -m pytest tests/test_torch_mla_moe_cuda.py -q

Tolerances: the grouped products take bf16 operands into f32 sums, as the
bf16 product an expert does, in another order: 2e-2 of the output's
largest magnitude (a few bf16 ulps of the largest term) on bf16 outputs; a captured step replays the eager step's kernels on
the same inputs, so its loss is held to 1e-3 relative (bf16 atomics in the
index_add backward change the order of sums)."""

import math

import pytest
import torch

from blendjax_torch.models import moe, seqformer
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.ops import flash_attention as flash
from blendjax_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _close(got, want, share):
    got = got.detach()
    err = (got.float() - want.float()).abs().max()
    assert bool(torch.isfinite(got).all()) and float(err) <= share * float(want.abs().max()), err


@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])
def test_grouped_products_match_plain(card, k, n):
    g = torch.Generator(device="cuda").manual_seed(0)
    counts = torch.tensor([700, 0, 1, 5000, 129, 128, 64, 3000], device="cuda")
    ends = torch.cumsum(counts, 0).to(torch.int32)
    used = int(ends[-1])
    x = torch.randn(used + 300, k, generator=g, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    w = (torch.randn(8, k, n, generator=g, device="cuda") / math.sqrt(k)).requires_grad_(True)
    dy = torch.randn(used, n, generator=g, device="cuda").to(torch.bfloat16)
    y = moe.grouped_mm(x, w, ends)[:used]
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    starts = [0] + ends.tolist()[:-1]
    wb = w.detach().to(torch.bfloat16)
    xd = x.detach()
    for e, (a, z) in enumerate(zip(starts, ends.tolist())):
        if z > a:
            _close(y[a:z], xd[a:z] @ wb[e], 2e-2)
            _close(dx[a:z], dy[a:z] @ wb[e].T, 2e-2)
            _close(dw[e], xd[a:z].T @ dy[a:z], 2e-2)
    assert float(dw[1].abs().max()) == 0


def test_the_layer_on_the_card_matches_its_cpu_path(card):
    g = torch.Generator().manual_seed(1)
    d, e, held, f = 256, 64, 8, 128
    p = {"gate": {"w": torch.randn(d, e, generator=g) / math.sqrt(d)},
         **{n: torch.randn(held, *s, generator=g) / math.sqrt(s[0])
            for n, s in (("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d)))},
         "shared": {n: torch.randn(*s, generator=g) / math.sqrt(s[0])
                    for n, s in (("w1", (d, 2 * f)), ("w3", (d, 2 * f)), ("w2", (2 * f, d)))}}
    # bf16 values on both sides, so that the f32 router chooses alike
    x = torch.randn(4096, d, generator=g).to(torch.bfloat16).float()
    want, _ = moe.deepseek_moe_apply(p, x, torch.float32, 6, 2.446, 0, e)

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} if isinstance(t, dict) else t.cuda()

    pc = to_card(p)
    xc = x.cuda().to(torch.bfloat16).requires_grad_(True)
    got, aux = moe.deepseek_moe_apply(pc, xc, torch.bfloat16, 6, 2.446, 0, e)
    _close(got.float().cpu(), want, 3e-2)
    got.float().square().mean().backward()
    assert bool(torch.isfinite(xc.grad).all())


MLA_SMALL = {"kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
             "v_head_dim": 128, "n_dense": 1, "dense_ff": 512, "moe_ff": 128, "n_routed": 64,
             "n_shared": 2}


def test_a_small_deepseek_seqformer_trains_captured_as_eager(card):
    g = torch.Generator(device="cuda").manual_seed(2)
    params = seqformer.init(g, obs_dim=32, d_model=256, n_heads=4, n_layers=2, device="cuda",
                            mla=MLA_SMALL)
    for name in ("w1", "w3", "w2"):  # hold experts 8..15
        params[f"blocks.1.moe.{name}"] = params[f"blocks.1.moe.{name}"][8:16].contiguous()
    ep = torch.randn(2, 257, 32, generator=g, device="cuda").to(torch.float16)
    runs = {}
    for capture in (False, True):
        balance = moe.Balance(["blocks.1"], 64, 8, 1e-3, "cuda")
        arch = {"norm_eps": 1e-5, "kv_norm_eps": 1e-6, "rope_theta": 50000, "moe_k": 6,
                "moe_scale": 2.446, "moe_experts": 64, "moe_first": 8,
                "balance_alpha": 1e-4, "balance": balance}
        loss_fn = lambda p, b, arch=arch: seqformer.episode_loss_fn(  # noqa: E731
            p, b, compute_dtype=torch.bfloat16,
            attn_fn=flash.make_flash_attention(block_q=128, block_kv=128), arch=arch)
        state = TrainState.create({k: v.clone() for k, v in params.items()}, lr=1e-4)
        step = make_train_step(loss_fn, capture=capture, balance=balance)
        before = {n: getattr(ln, n).launches for n in ("rms_norm_fwd_cuda", "rms_norm_bwd_cuda")}
        losses = [float(step(state, {"episode": ep})[1]) for _ in range(4)]
        runs[capture] = (losses, balance.read())
        assert ln.rms_norm_fwd_cuda.launches > before["rms_norm_fwd_cuda"]
        assert ln.rms_norm_bwd_cuda.launches > before["rms_norm_bwd_cuda"]
    (eager, c_eager), (captured, c_captured) = runs[False], runs[True]
    for a, b in zip(eager, captured):
        assert abs(a - b) <= 1e-3 * abs(a)
    assert c_captured["updates"] == 4
    # the updated weights differ by atomics' order, so a near tie may route
    # a token the other way at steps 2-4
    rows_e, rows_c = (c["layers"]["blocks.1"]["rows"] for c in (c_eager, c_captured))
    assert sum(abs(a - b) for a, b in zip(rows_e, rows_c)) <= 0.01 * sum(rows_e)

"""The port's SeqFormer inference path (``init_cache``, ``decode_step``,
``rollout``, ``layers.apply_rope_rows``) against the JAX package's, on the
same seeded inputs and converted params, on the CPU.

Tolerances: f32 decode and rollout within 1e-5 (absolute, plus 1e-5
relative: the frameworks sum the projections in different orders); bf16
decode within 2% of the output's scale (bf16 keeps about three significant
digits, and the two round at different places); the int8 rollout within
1e-5 too (the int32 accumulators are exact; the dequantized f32 values
carry the float paths' rounding differences).  The port's rollout against
its own naive regeneration at 1e-5, as f32 end to end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import layers as jlayers
from blendjax.models import seqformer as jseq
from blendjax.ops import quant as jq
from blendjax_torch.models import layers as tlayers
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.models.convert import params_from_jax
from blendjax_torch.ops import quant as tq
from blendjax_torch.parallel.ring_attention import full_attention

#: tests/test_serve.py's decode matrix
CASES = {
    "learned": (dict(), None),
    "learned-windowed": (dict(), 4),
    "rope": (dict(pos_encoding="rope"), None),
    "rope-windowed": (dict(pos_encoding="rope"), 4),
    "gqa": (dict(n_kv_heads=2), None),
}


def _params(obs_dim=5, **kw):
    tree = jax.device_get(jseq.init(jax.random.PRNGKey(0), obs_dim=obs_dim, d_model=32,
                                    n_heads=4, n_layers=2, max_len=32, **kw))
    return tree, params_from_jax(tree, device="cpu")


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_apply_rope_rows_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    pos = np.array([0, 7, 3, 100, 31])
    jc, js = jlayers.rope_table(jnp.asarray(pos), 16)
    tc, ts = tlayers.rope_table(torch.from_numpy(pos), 16)
    _close(tc, jc, 1e-6)
    _close(tlayers.apply_rope_rows(torch.from_numpy(x), tc, ts),
           jlayers.apply_rope_rows(jnp.asarray(x), jc, js), 1e-6)


def test_init_cache_shapes_and_per_row_reset():
    """The caches' shapes are the reference's; a per-row cache has a (B,)
    position vector, and rewinding one row's position is a full reset of
    that row (the old tenant's k/v sit at negative slot positions)."""
    for kw, per_row in ((dict(), False), (dict(n_kv_heads=2), True)):
        tree, params = _params(**kw)
        jc = jseq.init_cache(tree, 3, dtype=jnp.float32, length=8, per_row=per_row)
        tc = tseq.init_cache(params, 3, dtype=torch.float32, length=8, per_row=per_row)
        assert [tuple(k.shape) for k in tc["k"]] == [k.shape for k in jc["k"]]
        assert [tuple(v.shape) for v in tc["v"]] == [v.shape for v in jc["v"]]
        assert (tuple(tc["pos"].shape) if per_row else ()) == jnp.shape(jc["pos"])
    assert tseq.init_cache(params, 2)["k"][0].shape == (2, 32, 2, 8)  # the table's length
    with pytest.raises(ValueError, match="learned position table"):
        tseq.init_cache(params, 1, length=33)
    _, rope = _params(pos_encoding="rope")
    with pytest.raises(ValueError, match="length="):
        tseq.init_cache(rope, 1)

    _, params = _params()
    cache = tseq.init_cache(params, 3, dtype=torch.float32, length=8, per_row=True)
    rng = np.random.default_rng(1)
    old_ep = torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
    for t in range(5):
        _, cache = tseq.decode_step(params, cache, old_ep[t].expand(3, 5),
                                    compute_dtype=torch.float32)
    cache["pos"][1] = 0
    new_ep = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    fresh = tseq.init_cache(params, 1, dtype=torch.float32, length=8)
    for t in range(3):
        p, cache = tseq.decode_step(params, cache, new_ep[t].expand(3, 5),
                                    compute_dtype=torch.float32)
        ref, fresh = tseq.decode_step(params, fresh, new_ep[t][None],
                                      compute_dtype=torch.float32)
        _close(p[1], ref[0])
    assert cache["pos"].tolist() == [8, 3, 8]


def _jax_serial(tree, episodes, length, window, dtype=jnp.float32):
    """The reference's per-episode scalar-position decode."""
    step = jax.jit(functools.partial(jseq.decode_step, compute_dtype=dtype, window=window))
    out = []
    for ep in episodes:
        cache = jseq.init_cache(tree, 1, dtype=dtype, length=length)
        preds = []
        for t in range(len(ep)):
            p, cache = step(tree, cache, jnp.asarray(ep[t][None]))
            preds.append(np.asarray(p[0], np.float32))
        out.append(np.stack(preds))
    return out


def _port_serial(params, episodes, length, window, dtype=torch.float32):
    out = []
    for ep in episodes:
        cache = tseq.init_cache(params, 1, dtype=dtype, length=length)
        preds = []
        for t in range(len(ep)):
            p, cache = tseq.decode_step(params, cache, torch.from_numpy(ep[t][None]),
                                        compute_dtype=dtype, window=window)
            preds.append(p[0].numpy())
        out.append(np.stack(preds))
    return out


def _port_batched(params, episodes, length, window):
    """One per-row cache over every episode, stepped in sub-batches of the
    episodes that still have observations: the serving tick's gather ->
    decode_step -> scatter."""
    n = len(episodes)
    cache = tseq.init_cache(params, n, dtype=torch.float32, length=length, per_row=True)
    got = [[] for _ in range(n)]
    for t in range(max(len(ep) for ep in episodes)):
        idx = torch.tensor([i for i in range(n) if t < len(episodes[i])])
        rows = {"pos": cache["pos"][idx], "k": [k[idx] for k in cache["k"]],
                "v": [v[idx] for v in cache["v"]]}
        obs = torch.from_numpy(np.stack([episodes[i][t] for i in idx.tolist()]))
        pred, rows = tseq.decode_step(params, rows, obs, compute_dtype=torch.float32,
                                      window=window)
        cache["pos"][idx] = rows["pos"]
        for name in ("k", "v"):
            for c, r in zip(cache[name], rows[name]):
                c[idx] = r
        for j, i in enumerate(idx.tolist()):
            got[i].append(pred[j].numpy())
    return [np.stack(p) for p in got]


def _episodes(seed, lengths, obs_dim=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, obs_dim)).astype(np.float32) for t in lengths]


@pytest.mark.parametrize("form", ["scalar", "per_row"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_matches_reference(case, form):
    """Both position forms against the reference's serial decode: the
    batch-uniform position one episode at a time, and per-row positions
    over episodes at heterogeneous lengths (every tick's rows at different
    timesteps)."""
    kw, window = CASES[case]
    tree, params = _params(**kw)
    episodes = _episodes(0, (7, 3, 5, 1))
    length = 16 if window is None else window
    want = _jax_serial(tree, episodes, length, window)
    if form == "scalar":
        got = _port_serial(params, episodes, length, window)
    else:
        got = _port_batched(params, episodes, length, window)
    for g, w in zip(got, want):
        _close(g, w)


def test_decode_step_bf16_matches_reference():
    tree, params = _params(pos_encoding="rope")
    episodes = _episodes(2, (6,))
    want = _jax_serial(tree, episodes, 8, None, dtype=jnp.bfloat16)[0]
    got = _port_serial(params, episodes, 8, None, dtype=torch.bfloat16)[0]
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def _naive(params, prefix, n_steps, window):
    """Re-run the teacher-forced forward on the growing self-fed sequence."""
    attn = None
    if window is not None:
        def attn(q, k, v):
            return full_attention(q, k, v, causal=True, window=window)
    seq, out = prefix, []
    for _ in range(n_steps):
        pred = tseq.apply(params, seq, attn_fn=attn, compute_dtype=torch.float32)[:, -1]
        out.append(pred)
        seq = torch.cat([seq, pred[:, None]], dim=1)
    return torch.stack(out, dim=1)


ROLLOUTS = {
    "plain": (dict(), None),
    "gqa": (dict(n_kv_heads=2), None),
    "windowed": (dict(), 5),
    "rope-windowed": (dict(pos_encoding="rope"), 5),
}


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_reference_and_naive_regeneration(case):
    kw, window = ROLLOUTS[case]
    tree, params = _params(**kw)
    prefix = np.random.default_rng(1).standard_normal((2, 6, 5)).astype(np.float32)
    want = jseq.rollout(tree, jnp.asarray(prefix), 4, compute_dtype=jnp.float32,
                        cache_dtype=jnp.float32, window=window)
    got = tseq.rollout(params, torch.from_numpy(prefix), 4, compute_dtype=torch.float32,
                       cache_dtype=torch.float32, window=window)
    assert got.shape == (2, 4, 5)
    _close(got, want)
    _close(got, _naive(params, torch.from_numpy(prefix), 4, window))


def test_int8_rollout_matches_reference():
    tree, _ = _params()
    qtree = jq.quantize_seqformer(jax.tree.map(jnp.asarray, tree))
    qparams = tq.quantize_seqformer(params_from_jax(tree, device="cpu"))
    prefix = np.random.default_rng(3).standard_normal((2, 6, 5)).astype(np.float32)
    want = jseq.rollout(qtree, jnp.asarray(prefix), 5, compute_dtype=jnp.float32)
    got = tseq.rollout(qparams, torch.from_numpy(prefix), 5, compute_dtype=torch.float32)
    _close(got, want)


def test_rollout_validates_lengths():
    _, params = _params(obs_dim=4)
    prefix = torch.zeros((1, 30, 4))
    with pytest.raises(ValueError, match="exceeds max_len"):
        tseq.rollout(params, prefix, 3)
    with pytest.raises(ValueError, match="n_steps"):
        tseq.rollout(params, prefix, 0)

"""The port's 1F1B step at the MPMD operating points, against the JAX
package's: the twins of the 5 cases of ``tests/test_1f1b_numerics.py``.

The port's ``make_pipeline_train(schedule="1f1b")`` over ``{"pipe": 4}``
(4 real gloo ranks, ``helpers/torch_ranks.py``, started once for the
module) runs :func:`blendjax_torch.parallel.mpmd.reference_pieces`'
factoring on the JAX package's ``build_full_params(spec)`` (carried as
numpy), at ``M == n_stages`` and ``M == 2 * n_stages``, for the ``mse``
and ``pg`` families.  Its loss and every gradient leaf are held to the
JAX package's 1F1B step and to its plain full-model autodiff within the
reference's tolerances (loss 1e-5 relative, gradients 1e-4 relative and
1e-5 absolute); a ragged split is refused with the reference's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blendjax.parallel import make_mesh as jmake_mesh
from blendjax.parallel.mpmd import build_full_params as jbuild_full_params
from blendjax.parallel.mpmd import normalize_spec as jnormalize_spec
from blendjax.parallel.mpmd import reference_pieces as jreference_pieces
from blendjax.parallel.mpmd import reference_stacked as jreference_stacked
from blendjax.parallel.pipeline import make_pipeline_train as jmake_pipeline_train
from blendjax.parallel.pipeline import unstack_stage_params as junstack
from blendjax_torch.parallel import microbatch
from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks

N = 4


def _spec(family="mse"):
    return jnormalize_spec({"family": family, "d_in": 6, "wire": 8, "d_out": 3,
                            "n_layers": N, "n_procs": N, "seed": 3})


def _data(spec, m, mb=4, seed=1):
    """Microbatched inputs and the family's targets, pg's packed into one
    (M, mb, 3) array (action, advantage, weight), as the reference's."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    x = jax.random.normal(ks[0], (m, mb, spec["d_in"]), jnp.float32)
    if spec["family"] == "mse":
        tgt = jax.random.normal(ks[1], (m, mb, spec["d_out"]), jnp.float32)
    else:
        tgt = jnp.stack([
            jax.random.randint(ks[1], (m, mb), 0, spec["d_out"]).astype(jnp.float32),
            jax.random.normal(ks[2], (m, mb), jnp.float32),
            jnp.ones((m, mb), jnp.float32),
        ], axis=-1)
    return x, tgt


def _array_loss_fn(spec):
    _, _, _, loss_fn = jreference_pieces(spec)
    if spec["family"] == "mse":
        return lambda pred, t: loss_fn(pred, {"y": t})
    return lambda pred, t: loss_fn(pred, {"action": t[..., 0].astype(jnp.int32),
                                          "adv": t[..., 1], "w": t[..., 2]})


def _plain_loss(stacked, proj, x, tgt, spec):
    in_proj, stage_fn, out_proj, _ = jreference_pieces(spec)
    loss_fn = _array_loss_fn(spec)
    stages = junstack(stacked, spec["n_procs"])

    def one(mb, t):
        h = in_proj(proj[0], mb)
        for sp in stages:
            h = stage_fn(sp, h)
        return loss_fn(out_proj(proj[1], h), t)

    return jnp.mean(jax.vmap(one)(x, tgt))


CASES = [(family, m) for family in ("mse", "pg") for m in (N, 2 * N)]


def _case(family, m):
    spec = _spec(family)
    stacked, proj = jreference_stacked(jbuild_full_params(spec), spec)
    x, tgt = _data(spec, m)
    return spec, stacked, proj, x, tgt


def _args():
    out = {}
    for family, m in CASES:
        spec, stacked, proj, x, tgt = _case(family, m)
        out[(family, m)] = jax.tree.map(np.asarray, {
            "stacked": stacked, "proj": proj, "x": x, "tgt": tgt})
        out[(family, m)]["spec"] = dict(spec)
    return out


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.onef1b_cases, N, _args())
    try:
        yield r
    finally:
        r.close()


@pytest.mark.parametrize("family", ["mse", "pg"])
@pytest.mark.parametrize("m", [N, 2 * N])
@time_limit(120)
def test_1f1b_grads_match_plain_reference(ranks, family, m):
    """Loss and every gradient leaf match the JAX package's 1F1B step and
    its plain full-model autodiff at M == n_stages and M == 2*n_stages."""
    out = ranks.result((family, m), 110)
    spec, stacked, proj, x, tgt = _case(family, m)
    in_proj, stage_fn, out_proj, _ = jreference_pieces(spec)
    train = jmake_pipeline_train(stage_fn, _array_loss_fn(spec), jmake_mesh({"pipe": N}),
                                 schedule="1f1b", in_proj=in_proj, out_proj=out_proj)
    jloss, (jgs, jgp) = jax.jit(train)(stacked, proj, x, tgt)
    ref_loss, (rgs, rgp) = jax.value_and_grad(_plain_loss, argnums=(0, 1))(
        stacked, proj, x, tgt, spec)
    assert sorted(rec["row"] for rec in out.values()) == list(range(N))
    for rec in out.values():
        i = rec["row"]
        for loss, gs, gp in ((ref_loss, rgs, rgp), (jloss, jgs, jgp)):
            np.testing.assert_allclose(rec["loss"], float(loss), rtol=1e-5)
            for leaf in ("w", "b"):
                np.testing.assert_allclose(rec["stage_grads"][leaf], np.asarray(gs[leaf][i]),
                                           rtol=1e-4, atol=1e-5)
            for got, want in zip(rec["proj_grads"], gp):
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(got[leaf], np.asarray(want[leaf]), rtol=1e-4,
                                               atol=1e-5)


def test_ragged_microbatch_rejected_with_shapes():
    """A batch that does not divide into M names the leaf's shape, the
    remainder and the two nearest batch sizes that work, in the
    reference's words."""
    from blendjax.parallel.pipeline import microbatch as jmicrobatch

    texts = []
    for split, zeros in ((microbatch, np.zeros), (jmicrobatch, jnp.zeros)):
        with pytest.raises(ValueError, match="divisible") as ei:
            split({"obs": zeros((22, 6))}, 4)
        text = str(ei.value)
        assert "(22, 6)" in text
        assert "remainder 2" in text
        assert "batch 20 or 24" in text
        texts.append(text)
        with pytest.raises(ValueError, match=">= 1"):
            split(zeros((8, 2)), 0)
    assert texts[0] == texts[1]

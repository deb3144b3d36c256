"""The port's int8 quantization (``blendjax_torch.ops.quant``) against the
JAX package's ``blendjax.ops.quant`` on the same seeded numpy inputs and
converted params.

Tolerances:

- quantized weights (``w_q``) bit-equal and scales equal to 0 ulp: both
  sides divide by the same f32 scale, round half to even and clip;
- int32 accumulators exact on the same int8 operands;
- dequantized outputs of one layer within 1e-6 (absolute, plus 1e-6
  relative): the same f32 multiplies in the same order;
- whole int8 models (detector, policy) within 1e-5 (absolute, plus 1e-5
  relative): the GELU and tanh between the layers round differently in
  the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from blendjax.models import detector as jdet
from blendjax.models import policy as jpol
from blendjax.models import seqformer as jseq
from blendjax.ops import quant as jq
from blendjax_torch.models import detector as tdet
from blendjax_torch.models import policy as tpol
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.ops import quant as tq


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_flat_equal(got, want):
    """Port params ``got`` equal to ``want`` leaf for leaf: same keys,
    dtypes and bits."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,axes", [
    ((64, 48), (0,)),
    ((32, 4, 8), (0,)),
    ((4, 8, 32), (0, 1)),
    ((9, 33), (1,)),
    ((5, 7, 3), (1, 2)),
])
def test_quantize_tensor_bit_equal(shape, axes):
    rng = np.random.default_rng(0)
    w = _rand(rng, shape) * rng.uniform(0.01, 3.0, shape).astype(np.float32)
    w[0] = 0.0  # an all-zero slice takes the 1e-8 floor
    jqv, js = jq.quantize_tensor(jnp.asarray(w), axes)
    tqv, ts = tq.quantize_tensor(torch.from_numpy(w), axes)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_dense_and_conv_bit_equal():
    rng = np.random.default_rng(1)
    dense = {"w": _rand(rng, (40, 24)), "b": _rand(rng, (24,))}
    conv = {"w": _rand(rng, (3, 3, 16, 32)), "b": _rand(rng, (32,))}
    for jfn, tfn, p in ((jq.quantize_dense, tq.quantize_dense, dense),
                        (jq.quantize_conv, tq.quantize_conv, conv)):
        want = params_from_jax(_np_tree(jfn(jax.tree.map(jnp.asarray, p))), device="cpu")
        got = tfn(params_from_jax(p, device="cpu"))
        _assert_flat_equal(got, want)


def _seqformer_tree(**kw):
    return _np_tree(jseq.init(jax.random.PRNGKey(0), obs_dim=5, d_model=32, n_heads=4,
                              n_layers=2, max_len=32, **kw))


def _detector_tree():
    return _np_tree(jdet.init(jax.random.PRNGKey(1), num_keypoints=4, channels=(8, 16),
                              hidden=32))


def _policy_tree(continuous=False):
    return _np_tree(jpol.init(jax.random.PRNGKey(2), 6, 3, continuous=continuous))


@pytest.mark.parametrize("kind", ["seqformer", "seqformer-gqa-rope", "policy",
                                  "policy-gaussian", "detector"])
def test_model_quantizers_bit_equal(kind):
    """Every leaf of the port's quantized params equals the converted JAX
    quantization: int8 ``w_q`` bit for bit, scales to 0 ulp, and the float
    leaves (layer norms, position table, biases, ``log_std``) unchanged."""
    tree, jfn, tfn = {
        "seqformer": (_seqformer_tree(), jq.quantize_seqformer, tq.quantize_seqformer),
        "seqformer-gqa-rope": (_seqformer_tree(n_kv_heads=2, pos_encoding="rope"),
                               jq.quantize_seqformer, tq.quantize_seqformer),
        "policy": (_policy_tree(), jq.quantize_policy, tq.quantize_policy),
        "policy-gaussian": (_policy_tree(True), jq.quantize_policy, tq.quantize_policy),
        "detector": (_detector_tree(), jq.quantize_detector, tq.quantize_detector),
    }[kind]
    want = params_from_jax(_np_tree(jfn(jax.tree.map(jnp.asarray, tree))), device="cpu")
    got = tfn(params_from_jax(tree, device="cpu"))
    _assert_flat_equal(got, want)
    assert any(v.dtype == torch.int8 for v in got.values())


@pytest.mark.parametrize("kind", ["seqformer", "detector"])
def test_convert_keeps_int8_leaves_both_ways(kind):
    """A quantized pytree crosses unchanged: int8 leaves stay int8 (conv
    kernels HWIO <-> OIHW), scales and biases float32."""
    tree = _seqformer_tree() if kind == "seqformer" else _detector_tree()
    jfn = jq.quantize_seqformer if kind == "seqformer" else jq.quantize_detector
    qtree = _np_tree(jfn(jax.tree.map(jnp.asarray, tree)))
    flat = params_from_jax(qtree, device="cpu")
    back = params_to_jax(flat)
    jl, jdef = jax.tree.flatten(qtree)
    bl, bdef = jax.tree.flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if kind == "detector":
        assert flat["convs.0.w_q"].dtype == torch.int8
        assert flat["convs.0.w_q"].shape == (8, 3, 3, 3)  # OIHW


def test_dense_apply_int8_accumulators_exact():
    rng = np.random.default_rng(3)
    p = {"w": _rand(rng, (72, 40)), "b": _rand(rng, (40,))}
    x = _rand(rng, (6, 72), 2.0)
    qp_j = jq.quantize_dense(jax.tree.map(jnp.asarray, p))
    qp_t = tq.quantize_dense(params_from_jax(p, device="cpu"))
    xq, _ = jq.quantize_act(jnp.asarray(x))
    want = lax.dot_general(xq, qp_j["w_q"], (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    got = tq.dense_accumulate(torch.from_numpy(np.array(xq)), qp_t["w_q"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tq.dense_apply_int8(qp_t, torch.from_numpy(x)).numpy(),
                               np.asarray(jq.dense_apply_int8(qp_j, jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c_in,hw", [(3, (13, 18)), (64, (8, 7))])
def test_conv_apply_int8_accumulators_exact(stride, c_in, hw):
    rng = np.random.default_rng(4 + c_in)
    p = {"w": _rand(rng, (3, 3, c_in, 24)), "b": _rand(rng, (24,))}
    x = rng.uniform(0, 1, (2, *hw, c_in)).astype(np.float32)
    qp_j = jq.quantize_conv(jax.tree.map(jnp.asarray, p))
    qp_t = tq.quantize_conv(params_from_jax(p, device="cpu"))
    xq, _ = jq.quantize_act(jnp.asarray(x))
    want = lax.conv_general_dilated(
        xq, qp_j["w_q"], window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    got = tq.conv_accumulate(torch.from_numpy(np.array(xq)), qp_t["w_q"], stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tq.conv_apply_int8(qp_t, torch.from_numpy(x), stride=stride).numpy(),
        np.asarray(jq.conv_apply_int8(qp_j, jnp.asarray(x), stride=stride)),
        atol=1e-6, rtol=1e-6)


#: every equation the SeqFormer runs through maybe_quantized_einsum, with
#: (x shape, w shape, the weight scale's reduce axes)
EQS = {
    "dense": ("...d,df->...f", (2, 5, 24), (24, 16), (0,)),
    "proj": ("btd,dhk->bthk", (2, 5, 24), (24, 4, 6), (0,)),
    "wo": ("bthk,hkd->btd", (2, 5, 4, 6), (4, 6, 24), (0, 1)),
    "decode_proj": ("bd,dhk->bhk", (3, 24), (24, 4, 6), (0,)),
    "decode_wo": ("bhk,hkd->bd", (3, 4, 6), (4, 6, 24), (0, 1)),
}


@pytest.mark.parametrize("name", sorted(EQS))
def test_maybe_quantized_einsum_matches_reference(name):
    eq, xs, ws, axes = EQS[name]
    rng = np.random.default_rng(5)
    x, w = _rand(rng, xs), _rand(rng, ws)
    wq_j, wscale_j = jq.quantize_tensor(jnp.asarray(w), axes)
    wq_t, wscale_t = tq.quantize_tensor(torch.from_numpy(w), axes)
    wq_t = tq._weight_layout(wq_t, len(axes))  # as quantize_seqformer stores it
    # the accumulator on the same int8 operands is exact
    xq, _ = jq.quantize_tensor(jnp.asarray(x), jq._x_contracted_axes(eq, x.ndim))
    want_acc = jnp.einsum(eq, xq, wq_j, preferred_element_type=jnp.int32)
    got_acc = tq._int8_einsum(eq, torch.from_numpy(np.array(xq)), wq_t)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    want = jq.maybe_quantized_einsum(eq, jnp.asarray(x), {"w_q": wq_j, "w_scale": wscale_j},
                                     jnp.float32)
    got = tq.maybe_quantized_einsum(eq, torch.from_numpy(x),
                                    {"w_q": wq_t, "w_scale": wscale_t}, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # the float branch is a plain einsum in the compute dtype
    got_f = tq.maybe_quantized_einsum(eq, torch.from_numpy(x), {"w": torch.from_numpy(w)},
                                      torch.float32)
    np.testing.assert_allclose(got_f.numpy(), np.einsum(eq, x, w), atol=1e-5, rtol=1e-5)


def test_int8_products_reject_other_forms():
    """An int8 einsum that is not a trailing-against-leading contraction, and
    a row-major weight, are refused rather than computed another way."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(_rand(rng, (4, 24, 6)))
    wq, ws = tq.quantize_tensor(w, (1,))
    with pytest.raises(NotImplementedError, match="trailing axes"):
        tq.maybe_quantized_einsum("bd,hdk->bhk", torch.ones(3, 24),
                                  {"w_q": wq, "w_scale": ws}, torch.float32)
    b = torch.randint(-127, 128, (24, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="column-major"):
        tq.int8_matmul(torch.ones(3, 24, dtype=torch.int8), b)
    got = tq.int8_matmul(torch.ones(3, 24, dtype=torch.int8), tq._weight_layout(b, 1))
    np.testing.assert_array_equal(got.numpy(),
                                  np.ones((3, 24), np.int64) @ b.numpy().astype(np.int64))


def test_maybe_quantized_einsum_rejects_flat_scales():
    rng = np.random.default_rng(6)
    qp = tq.quantize_dense({"w": torch.from_numpy(_rand(rng, (8, 4))),
                            "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="keepdims weight scales"):
        tq.maybe_quantized_einsum("bd,df->bf", torch.ones(2, 8), qp, torch.float32)


def test_quantize_for_wire_dispatch():
    trees = {"seqformer": _seqformer_tree(), "policy": _policy_tree(),
             "detector": _detector_tree()}
    direct = {"seqformer": tq.quantize_seqformer, "policy": tq.quantize_policy,
              "detector": tq.quantize_detector}
    for kind, tree in trees.items():
        p = params_from_jax(tree, device="cpu")
        _assert_flat_equal(tq.quantize_for_wire(p, kind), direct[kind](p))
        assert tq.quantize_for_wire(p, None) is p
    with pytest.raises(ValueError, match="unknown wire-quantization kind"):
        tq.quantize_for_wire({}, "vision")


def test_detector_apply_int8_matches_reference():
    tree = _detector_tree()
    images = np.random.default_rng(7).uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    want = np.asarray(jq.detector_apply_int8(
        jq.quantize_detector(jax.tree.map(jnp.asarray, tree)), jnp.asarray(images)))
    qp = tq.quantize_detector(params_from_jax(tree, device="cpu"))
    got = tq.detector_apply_int8(qp, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (3, 4, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the seams default to the float layers
    float_t = tdet.apply(params_from_jax(tree, device="cpu"), torch.from_numpy(images),
                         compute_dtype=torch.float32).numpy()
    float_j = np.asarray(jdet.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
                                    compute_dtype=jnp.float32))
    np.testing.assert_allclose(float_t, float_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("continuous", [False, True])
def test_int8_policy_logits_match_reference(continuous):
    tree = _policy_tree(continuous)
    obs = np.random.default_rng(8).standard_normal((16, 6)).astype(np.float32)
    want = np.asarray(jpol.logits(jq.quantize_policy(jax.tree.map(jnp.asarray, tree)),
                                  jnp.asarray(obs)))
    got = tpol.logits(tq.quantize_policy(params_from_jax(tree, device="cpu")),
                      torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # and it tracks the float policy within the reference's 5% of the scale
    ref = tpol.logits(params_from_jax(tree, device="cpu"), torch.from_numpy(obs)).numpy()
    assert np.abs(got - ref).max() < 0.05 * max(float(np.abs(ref).max()), 1.0)


def test_int8_weights_are_stored_for_the_fast_product():
    """The quantizers keep each int8 weight's shape and values but store its
    contracted axes fastest, so the product's (k, n) operand is a
    column-major view (``torch._int_mm``'s fast layout on the card)."""
    seq = tq.quantize_seqformer(params_from_jax(_seqformer_tree(), device="cpu"))
    det = tq.quantize_detector(params_from_jax(_detector_tree(), device="cpu"))
    cases = [(seq["blocks.0.wq.w_q"], 1), (seq["blocks.0.wo.w_q"], 2),
             (seq["blocks.1.mlp.proj.w_q"], 1), (det["fc.w_q"], 1),
             (det["convs.1.w_q"].permute(2, 3, 1, 0), 3)]
    for w, nc in cases:
        k = int(np.prod(w.shape[:nc]))
        assert tq._column_major(w.reshape(k, -1)), w.stride()

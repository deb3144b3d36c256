"""The port's TinyDetector and train step against the JAX package's: the
same seeded numpy inputs and the same JAX-initialized parameters (carried
across by ``params_from_jax``) through ``blendjax.models.detector`` +
``make_train_step(optax.adam(1e-3))`` and through the port.

Tolerances: float32 compute agrees to atol 1e-5 on outputs and parameters
and rtol 1e-4 on gradients, with an absolute floor of 1e-8 for elements
that cancel to ~0 (the two frameworks sum convolutions in different
orders).  bf16 compute is held on the forward and the loss only,
at rtol 2e-2 (bf16 keeps ~3 significant digits and rounds at different
places in the two frameworks); Adam's sign-like first step makes bf16
parameters after a step too fragile to compare."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blendjax.models import detector as jdet
from blendjax.models import layers as jlayers
from blendjax.models.train import TrainState as JTrainState
from blendjax.models.train import make_train_step as jmake_train_step
from blendjax_torch.models import detector as tdet
from blendjax_torch.models import layers as tlayers
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState, make_train_step

CFG = dict(num_keypoints=2, channels=(8, 16), hidden=32)
SHAPE = (2, 33, 48, 3)  # odd H and even W: both SAME-padding cases


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random(SHAPE, dtype=np.float32)
    xy = rng.random((SHAPE[0], CFG["num_keypoints"], 2), dtype=np.float32)
    return images, xy


def _jax_params():
    tree = jdet.init(jax.random.PRNGKey(0), **CFG)
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_params_round_trip():
    tree = _jax_params()
    params = params_from_jax(tree, device="cpu")
    assert params["convs.0.w"].shape == (8, 3, 3, 3)  # HWIO -> OIHW
    assert params["fc.w"].shape == (16, 32)  # dense stays (in, out)
    back = params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [33, 48, 1, 2])
def test_same_padding_matches_xla(size):
    """Stride-2 SAME pads (0, 1) on even sizes, (1, 1) on odd ones."""
    rng = np.random.default_rng(size)
    x = rng.random((1, size, size + 1, 2), dtype=np.float32)
    w = rng.random((3, 3, 2, 4), dtype=np.float32)
    p = {"w": w, "b": np.zeros(4, np.float32)}
    ref = jlayers.conv_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=2)
    tp = {"w": _t(w.transpose(3, 2, 0, 1)), "b": _t(p["b"])}
    out = tlayers.conv_apply(tp, _t(x), stride=2)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(tlayers.gelu(_t(x)).numpy(),
                               np.asarray(jlayers.gelu(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
    tree = _jax_params()
    images, xy = _inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jdet.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(images), jdt)
    ref_loss = jdet.loss_fn(jax.tree.map(jnp.asarray, tree),
                            {"image": jnp.asarray(images), "xy": jnp.asarray(xy)}, jdt)
    params = params_from_jax(tree, device="cpu")
    out = tdet.apply(params, _t(images), tdt)
    loss = tdet.loss_fn(params, {"image": _t(images), "xy": _t(xy)}, tdt)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-2)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-2)


def test_grads_match_jax():
    tree = _jax_params()
    images, xy = _inputs()
    jgrads = jax.grad(jdet.loss_fn)(
        jax.tree.map(jnp.asarray, tree),
        {"image": jnp.asarray(images), "xy": jnp.asarray(xy)}, jnp.float32)
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(tree, device="cpu").items()}
    tdet.loss_fn(params, {"image": _t(images), "xy": _t(xy)}, torch.float32).backward()
    grads = params_to_jax({k: v.grad for k, v in params.items()})
    for path, a, b in zip(
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jgrads)],
        jax.tree.leaves(grads), jax.tree.leaves(jgrads),
    ):
        # atol: a floor for elements that cancel to ~0, where any
        # reordering of the float32 sums is a large relative change
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-8,
                                   err_msg=path)


def test_train_steps_match_optax_adam():
    """Parameters after 1 and after 3 Adam steps (float32 compute)."""
    tree = _jax_params()
    batches = [_inputs(seed) for seed in range(3)]

    def jloss(p, b):
        return jdet.loss_fn(p, b, jnp.float32)

    jstep = jmake_train_step(jloss, optax.adam(1e-3), donate=False)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, tree), optax.adam(1e-3))

    state = TrainState.create(params_from_jax(tree, device="cpu"))
    step = make_train_step(lambda p, b: tdet.loss_fn(p, b, torch.float32))

    for i, (images, xy) in enumerate(batches):
        jstate, jl = jstep(jstate, {"image": jnp.asarray(images), "xy": jnp.asarray(xy)})
        state, loss = step(state, {"image": _t(images), "xy": _t(xy)})
        np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=1e-5)
        if i in (0, 2):
            got = params_to_jax(state.params)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate.params)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    assert state.step == 3


def test_train_flops_matches_reference():
    for args in [(8, 480, 640), (2, 33, 48)]:
        assert tdet.train_flops(*args) == jdet.train_flops(*args)


def test_init_uses_the_given_generator_and_device():
    a = tdet.init(torch.Generator().manual_seed(3), device="cpu", **CFG)
    b = tdet.init(torch.Generator().manual_seed(3), device="cpu", **CFG)
    assert set(a) == set(params_from_jax(_jax_params(), device="cpu"))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in a.values())

"""The densityopt slice of the port against the JAX package, on the CPU.

Inputs come from seeded numpy draws; parameters are the JAX package's,
converted (``models/convert.py``).  Held, with the tolerance each states:

- the discriminator (``apply``, ``d_loss_fn``, ``sim_scores``, the gradient
  of ``d_loss_fn``) at f32 compute and at bf16;
- the ProbModel (``log_prob``, the ``score_loss`` gradient, ``mean``,
  ``ema_update``, and the transform of the normal draws);
- one Adam discriminator step and one ProbModel step against optax;
- 5 iterations of the loop, driven by the samples the JAX loop drew;
- the reference's example and model tests on the port;
- the whole slice: ``densityopt.main`` over 2 fake-Blender producers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blendjax.models import discriminator as jdisc
from blendjax.models import probmodel as jpm
from blendjax_torch import densityopt
from blendjax_torch.models import discriminator, probmodel
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState
from helpers import FAKE_BLENDER, fake_bpy, load_example
from helpers.producers import free_port


def _free_block(n):
    """The first of ``n`` consecutive free ports."""
    import socket

    for _ in range(50):
        base = free_port()
        try:
            for k in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
    raise RuntimeError(f"no {n} consecutive free ports")


#: the limits: f32 compute runs the same arithmetic up to summation order.
#: bf16 compute rounds every activation to 8 bits, and XLA and PyTorch
#: round the convs' reductions differently (XLA sums a bias gradient's
#: N*H*W bf16 terms in bf16, PyTorch in f32), so bf16 holds the logits and
#: losses to about 2 bf16 ulps of their scale, and each gradient entry to
#: 1/8 of the largest entry with the whole gradient's cosine above 0.99.
#: The ProbModel's values reach ~100 in magnitude, so its limit is 1e-6
#: absolute and relative.
F32_ATOL = 1e-5
BF16_LOGIT_ATOL = 8e-3
BF16_LOSS_ATOL = 4e-3
BF16_GRAD_REL = 0.125
BF16_GRAD_COSINE = 0.99
PM_ATOL = 1e-6
PM_RTOL = 1e-6

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _disc(seed=0, in_channels=3, widths=(32, 64, 128)):
    jparams = jdisc.init(jax.random.PRNGKey(seed), in_channels=in_channels, widths=widths)
    return jparams, params_from_jax(_np_tree(jparams), device="cpu")


def _images(seed, n, hw=32, c=3):
    return np.random.default_rng(seed).random((n, hw, hw, c), dtype=np.float32)


def _assert_close(tree, params, atol, rtol=0.0):
    want = params_from_jax(_np_tree(tree), device="cpu")
    assert want.keys() == params.keys()
    for k in want:
        np.testing.assert_allclose(params[k].detach().numpy(), want[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _max_diff(tree, params):
    conv = params_from_jax(_np_tree(tree), device="cpu")
    assert conv.keys() == params.keys()
    return max((conv[k] - params[k].detach()).abs().max().item() for k in conv)


# -- the discriminator --------------------------------------------------------


def test_discriminator_init_layout_matches_the_jax_package():
    jparams, _ = _disc()
    params = discriminator.init(torch.Generator().manual_seed(0), in_channels=3, device="cpu")
    want = {k: tuple(v.shape) for k, v in params_from_jax(_np_tree(jparams), "cpu").items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert want["convs.0.w"] == (32, 3, 4, 4) and want["head.w"] == (128, 1)
    # He-normal scale, as conv_init's
    assert abs(params["convs.2.w"].std().item() - (2.0 / (16 * 64)) ** 0.5) < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_discriminator_matches_the_jax_package(dtype, seed):
    jdt, tdt = _DT[dtype]
    jparams, params = _disc(seed)
    real, fake = _images(seed, 6), _images(seed + 10, 4)
    logit_atol = F32_ATOL if dtype == "float32" else BF16_LOGIT_ATOL
    loss_atol = F32_ATOL if dtype == "float32" else BF16_LOSS_ATOL

    logits = discriminator.apply(params, torch.from_numpy(real), tdt)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (6,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jdisc.apply(jparams, real, jdt)),
                               rtol=0, atol=logit_atol)
    np.testing.assert_allclose(
        discriminator.sim_scores(params, torch.from_numpy(fake), tdt).numpy(),
        np.asarray(jdisc.sim_scores(jparams, fake, jdt)), rtol=0, atol=loss_atol)

    jloss, jgrads = jax.value_and_grad(jdisc.d_loss_fn)(jparams, real, fake, jdt)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = discriminator.d_loss_fn(p, torch.from_numpy(real), torch.from_numpy(fake), tdt)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= loss_atol
    grads = {k: v.grad for k, v in p.items()}
    if dtype == "float32":
        assert _max_diff(jgrads, grads) <= F32_ATOL
        return
    want = params_from_jax(_np_tree(jgrads), device="cpu")
    largest = max(v.abs().max().item() for v in want.values())
    assert _max_diff(jgrads, grads) <= BF16_GRAD_REL * largest
    flat = torch.cat([grads[k].reshape(-1) for k in want])
    wflat = torch.cat([want[k].reshape(-1) for k in want])
    assert torch.nn.functional.cosine_similarity(flat, wflat, dim=0).item() > BF16_GRAD_COSINE


def test_bce_logits_matches_the_jax_package():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal(64) * 30).astype(np.float32)  # |x| up to ~100
    targets = rng.integers(0, 2, 64).astype(np.float32)
    got = discriminator.bce_logits(torch.from_numpy(logits), torch.from_numpy(targets))
    want = jdisc.bce_logits(jnp.asarray(logits), jnp.asarray(targets))
    assert np.isfinite(got.item()) and abs(got.item() - float(want)) <= F32_ATOL


def test_discriminator_runs_the_two_batches_separately():
    """d_loss_fn on a real batch of 32 and a fake batch of 8 (the example's
    sizes) equals the two BCE terms computed apart."""
    _, params = _disc()
    real, fake = torch.from_numpy(_images(0, 32)), torch.from_numpy(_images(1, 8))
    lr = discriminator.apply(params, real, torch.float32)
    lf = discriminator.apply(params, fake, torch.float32)
    want = (discriminator.bce_logits(lr, torch.ones_like(lr))
            + discriminator.bce_logits(lf, torch.zeros_like(lf)))
    assert discriminator.d_loss_fn(params, real, fake, torch.float32).item() == want.item()


# -- the ProbModel ------------------------------------------------------------


def _pm(mu=(0.3, 1.1), sigma=(0.4, 0.7)):
    return jpm.init(mu=mu, sigma=sigma), probmodel.init(mu=mu, sigma=sigma, device="cpu")


def test_probmodel_init_and_transform_match_the_jax_package():
    jparams, params = _pm()
    assert _max_diff(jparams, params) <= PM_ATOL
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, (64, 2)))  # the draws jpm.sample makes
    got = probmodel.transform(params, torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(jpm.sample(jparams, key, 64)),
                               rtol=0, atol=PM_ATOL)
    draws = probmodel.sample(params, torch.Generator().manual_seed(0), 4096)
    assert tuple(draws.shape) == (4096, 2) and bool((draws > 0).all())
    np.testing.assert_allclose(torch.log(draws).mean(0).numpy(), [0.3, 1.1], atol=0.05)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probmodel_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-0.5, 1.5, 2).astype(np.float32)
    sigma = rng.uniform(0.2, 0.8, 2).astype(np.float32)
    jparams, params = _pm(mu, sigma)
    x = np.exp(rng.normal(size=(16, 2))).astype(np.float32)
    losses = rng.random(16).astype(np.float32)
    baseline = float(rng.random())

    np.testing.assert_allclose(probmodel.log_prob(params, torch.from_numpy(x)).numpy(),
                               np.asarray(jpm.log_prob(jparams, x)), rtol=PM_RTOL,
                               atol=PM_ATOL)
    np.testing.assert_allclose(probmodel.mean(params).numpy(),
                               np.asarray(jpm.mean(jparams)), rtol=PM_RTOL, atol=PM_ATOL)
    got = probmodel.ema_update(baseline, torch.from_numpy(losses))
    assert abs(got.item() - float(jpm.ema_update(baseline, jnp.asarray(losses)))) <= PM_ATOL

    jgrads = jax.grad(jpm.score_loss)(jparams, x, losses, baseline)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = probmodel.score_loss(p, torch.from_numpy(x), torch.from_numpy(losses),
                                torch.tensor(baseline))
    loss.backward()
    assert abs(loss.item() - float(jpm.score_loss(jparams, x, losses, baseline))) <= PM_ATOL
    _assert_close(jgrads, {k: v.grad for k, v in p.items()}, PM_ATOL, PM_RTOL)


def test_parameters_cross_both_ways():
    """The discriminator's pytree (conv kernels HWIO <-> OIHW, the head
    (in, 1)) and the ProbModel's {mu, log_sigma} go through
    ``params_from_jax`` / ``params_to_jax`` and back unchanged."""
    jparams, params = _disc(widths=(8, 16))
    back = params_to_jax(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        _np_tree(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np_tree(jparams))):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert back["convs"][0]["w"].shape == (4, 4, 3, 8) and back["head"]["w"].shape == (16, 1)
    jpm_params, pm = _pm()
    pm_back = params_to_jax(pm)
    assert set(pm_back) == {"mu", "log_sigma"}
    for k in pm_back:
        np.testing.assert_array_equal(pm_back[k], np.asarray(jpm_params[k]))
    assert params_from_jax(pm_back, "cpu").keys() == pm.keys()


# -- one Adam step of each against optax ----------------------------------------


def test_one_d_step_and_p_step_match_optax():
    """``make_steps``' discriminator and ProbModel steps (torch Adam with
    optax's defaults) against ``optax.adam`` on the same params and
    batches, three steps each at f32 compute."""
    d_step, p_step, scores = densityopt.make_steps(torch.float32)
    jparams, params = _disc(widths=(8, 16))
    d_opt = optax.adam(2e-4)
    d_state_j = d_opt.init(jparams)
    d_state = TrainState.create(params, lr=2e-4)
    jpm_params, pm = _pm()
    p_opt = optax.adam(5e-2)
    p_state_j = p_opt.init(jpm_params)
    p_state = TrainState.create(pm, lr=5e-2)
    rng = np.random.default_rng(0)
    for i in range(3):
        real, fake = _images(i, 8), _images(i + 10, 4)
        jloss, g = jax.value_and_grad(jdisc.d_loss_fn)(jparams, real, fake, jnp.float32)
        upd, d_state_j = d_opt.update(g, d_state_j, jparams)
        jparams = optax.apply_updates(jparams, upd)
        d_state, loss = d_step(d_state, {"real": torch.from_numpy(real),
                                         "fake": torch.from_numpy(fake)})
        assert abs(loss.item() - float(jloss)) <= F32_ATOL
        assert _max_diff(jparams, d_state.params) <= 1e-6

        sim = scores(d_state.params, {"fake": torch.from_numpy(fake)})
        np.testing.assert_allclose(
            sim.numpy(), np.asarray(jdisc.sim_scores(jparams, fake, jnp.float32)),
            rtol=0, atol=F32_ATOL)
        x = np.exp(rng.normal(size=(8, 2))).astype(np.float32)
        losses = rng.random(8).astype(np.float32)
        g = jax.grad(jpm.score_loss)(jpm_params, x, losses, 0.25)
        upd, p_state_j = p_opt.update(g, p_state_j, jpm_params)
        jpm_params = optax.apply_updates(jpm_params, upd)
        p_state, _ = p_step(p_state, {"samples": torch.from_numpy(x),
                                      "losses": torch.from_numpy(losses),
                                      "baseline": torch.tensor(0.25)})
        _assert_close(jpm_params, p_state.params, PM_ATOL, PM_RTOL)
    assert d_state.step == p_state.step == 3


# -- the loop -------------------------------------------------------------------


def _synthetic_renderer(target, seed=0, hw=16):
    """Brightness encodes |m1 - target| (the reference's test renderer)."""
    rng = np.random.default_rng(seed)

    def render_batch(params_np):
        m1 = params_np[:, 0]
        g = np.clip(np.exp(-np.abs(m1 - target)), 0.0, 1.0) * 255
        noise = rng.normal(0, 4, size=(len(m1), hw, hw, 1))
        return np.clip(g[:, None, None, None] + noise, 0, 255).astype(np.uint8)

    return render_batch


#: the 5-iteration loop against the JAX loop: both compute in bf16 (the
#: example's setting), so the losses hold to the bf16 loss limit and the
#: ProbModel's mean, moved by Adam at 5e-2 from those losses, to 1e-3
LOOP_LOSS_ATOL = 2 * BF16_LOSS_ATOL
LOOP_MEAN_ATOL = 1e-3


def test_loop_driven_by_the_jax_samples_matches_the_jax_loop():
    dopt = load_example("densityopt/densityopt.py")
    target = 4.0
    drawn = []
    render = _synthetic_renderer(target, seed=1)

    def jax_render(params_np):
        drawn.append(np.array(params_np))
        return render(params_np)

    real = _synthetic_renderer(target, seed=2)(np.full((32, 2), target, np.float32))
    _, jhist = dopt.optimize(jax_render, real, iterations=5, batch_size=8, log_every=0)
    frames = iter([_synthetic_renderer(target, seed=1)(s) for s in drawn])
    samples = iter(drawn)

    def draw(pm_params, n):
        return torch.from_numpy(next(samples))

    d0 = params_from_jax(_np_tree(jdisc.init(jax.random.PRNGKey(1), in_channels=1)), "cpu")
    _, hist = densityopt.optimize(lambda p: next(frames), real, iterations=5, batch_size=8,
                                  log_every=0, device="cpu", d_params=d0, draw=draw)
    assert len(hist) == len(jhist) == 5
    for (d, s, m), (jd, js, jm) in zip(hist, jhist):
        assert abs(d - jd) <= LOOP_LOSS_ATOL and abs(s - js) <= LOOP_LOSS_ATOL
        np.testing.assert_allclose(m, np.asarray(jm), rtol=0, atol=LOOP_MEAN_ATOL)


class _FakeDuplex:
    def __init__(self, log):
        self.log = log

    def send(self, **kwargs):
        self.log.append(kwargs)


def test_densityopt_renderer_matching_out_of_order():
    sent = []
    duplexes = [_FakeDuplex(sent), _FakeDuplex(sent)]

    def stream_gen():
        while True:
            if not sent:
                yield {"shape_id": -99, "image": np.zeros((4, 4, 1), np.uint8)}
                continue
            batch = list(sent)
            sent.clear()
            for msg in reversed(batch):
                yield {"shape_id": msg["shape_id"],
                       "image": np.full((4, 4, 1), msg["shape_id"] % 251, np.uint8)}

    render = densityopt.make_blender_renderer(duplexes, stream_gen(), batch_size=4)
    out = render(np.ones((4, 2), np.float32))
    assert out.shape == (4, 4, 4, 1)
    np.testing.assert_array_equal(out[:, 0, 0, 0], [0, 1, 2, 3])  # id order
    out2 = render(np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(out2[:, 0, 0, 0], [4, 5, 6])  # ids continue
    assert render.stale == 0


def test_renderer_skips_and_counts_stale_frames():
    """A producer republishes its last shape every frame: frames of ids
    already joined, or never asked for, are skipped and counted."""
    sent = []

    def stream_gen():
        last = -1
        while True:
            for msg in list(sent):
                sent.remove(msg)
                yield {"shape_id": last, "image": np.zeros((2, 2, 1), np.uint8)}
                last = msg["shape_id"]
                yield {"shape_id": last, "image": np.full((2, 2, 1), last, np.uint8)}
            yield {"shape_id": last, "image": np.zeros((2, 2, 1), np.uint8)}

    render = densityopt.make_blender_renderer([_FakeDuplex(sent)], stream_gen(), 2)
    np.testing.assert_array_equal(render(np.ones((2, 2)))[:, 0, 0, 0], [0, 1])
    assert render.stale == 2  # the -1 before 0, and 0 again before 1
    np.testing.assert_array_equal(render(np.ones((2, 2)))[:, 0, 0, 0], [2, 3])
    assert render.stale >= 4


def test_densityopt_score_function_moves_toward_target():
    """The reference's convergence test on the port: brightness encodes
    |m1 - target|; the EMA-baselined score-function loop pushes the mean
    from 2.0 toward 4.0."""
    target = 4.0
    render_batch = _synthetic_renderer(target)
    real = render_batch(np.full((32, 2), target, np.float32))
    _, history = densityopt.optimize(render_batch, real, iterations=40, batch_size=16,
                                     target_init=(2.0, 2.0), sigma_init=(0.5, 0.5),
                                     p_lr=8e-2, log_every=0, device="cpu")
    means = np.stack([h[2] for h in history])
    assert np.isfinite(means).all()
    assert means[-1][0] > means[0][0] + 0.3, means[[0, -1]]


def test_densityopt_supershape_producer_duplex_roundtrip(monkeypatch):
    """The port's supershape producer through the port's launcher: shape
    params over the port's duplex channel, ``{image, shape_id}`` back."""
    from blendjax_torch.btt.dataset import RemoteIterableDataset
    from blendjax_torch.btt.duplex import DuplexChannel
    from blendjax_torch.btt.launcher import BlenderLauncher

    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")
    with BlenderLauncher(scene="", script=str(densityopt.SCRIPT), num_instances=1,
                         named_sockets=["DATA", "CTRL"], start_port=_free_block(2),
                         background=True) as bl:
        duplex = DuplexChannel(bl.launch_info.addresses["CTRL"][0])
        try:
            duplex.send(shape_params=(4.0, 6.0), shape_id=7)
            items = list(RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                               max_items=1, timeoutms=30000))
        finally:
            duplex.close()
    assert len(items) == 1
    assert items[0]["shape_id"] == 7
    assert items[0]["image"].shape == (128, 128, 3) and items[0]["image"].dtype == np.uint8


def test_supershape_mesh_matches_the_reference_producer():
    """The producer's Gielis mesh is the JAX example's, vertex for vertex."""
    import runpy

    here = os.path.dirname(os.path.abspath(__file__))
    ref = os.path.join(os.path.dirname(here), "examples", "densityopt", "supershape.blend.py")
    src = open(ref).read()
    ns = {}
    fake_bpy.install()  # the reference script imports bpy first
    exec(compile(src[:src.index("def make_mesh")], ref, "exec"), ns)  # the pure part
    port = runpy.run_path(str(densityopt.SCRIPT), run_name="supershape")
    for m1, m2 in ((3.0, 3.0), (4.0, 6.0), (5.5, 2.25)):
        v, n = port["supershape_vertices"](m1, m2)
        rv, rn = ns["supershape_vertices"](m1, m2)
        assert n == rn == 48 and v.shape == (48 * 48, 3)
        np.testing.assert_array_equal(v, rv)
    faces = port["supershape_faces"](48)
    assert len(faces) == 47 * 47 and faces[0] == (0, 1, 49, 48)


# -- the reference's model tests on the port ---------------------------------------


def test_discriminator_separates():
    params = discriminator.init(torch.Generator().manual_seed(2), in_channels=1,
                                widths=(8, 16), device="cpu")
    real = torch.ones((8, 32, 32, 1)) * 0.9
    fake = torch.zeros((8, 32, 32, 1))
    d_step, _, _ = densityopt.make_steps()
    state = TrainState.create(params, lr=1e-2)
    for _ in range(40):
        state, _ = d_step(state, {"real": real, "fake": fake})
    lr = discriminator.apply(state.params, real)
    lf = discriminator.apply(state.params, fake)
    assert float(lr.mean()) > float(lf.mean())
    s = discriminator.sim_scores(state.params, fake)
    assert s.shape == (8,) and bool(torch.isfinite(s).all())


def test_probmodel_score_gradient_direction():
    """If larger samples get lower loss, the estimator must push mu up."""
    params = probmodel.init(mu=[0.0], sigma=[0.5], device="cpu")
    samples = probmodel.sample(params, torch.Generator().manual_seed(3), 512)
    losses = -torch.log(samples[:, 0])
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    probmodel.score_loss(p, samples, losses, baseline=losses.mean()).backward()
    assert float(p["mu"].grad[0]) < 0
    lp = probmodel.log_prob(params, torch.tensor([[1.0]]))
    expected = -np.log(0.5) - 0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(float(lp[0]), expected, atol=1e-5)
    assert tuple(probmodel.mean(params).shape) == (1,)


# -- the whole slice ----------------------------------------------------------------


def test_main_over_two_fake_blender_producers(monkeypatch, capsys):
    """``python -m blendjax_torch.densityopt --device cpu`` as a user runs
    it: 2 supershape producers, the real frames at the target, 3
    iterations of the loop."""
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")
    pm_params, history = densityopt.main(
        ["--instances", "2", "--iterations", "3", "--batch", "4", "--background",
         "--device", "cpu", "--start-port", str(_free_block(4))])
    assert len(history) == 3
    for d_loss, sim_mean, pm_mean in history:
        assert np.isfinite(d_loss) and np.isfinite(sim_mean) and pm_mean.shape == (2,)
        assert np.isfinite(pm_mean).all()
    assert set(pm_params) == {"mu", "log_sigma"}
    assert "final mean:" in capsys.readouterr().out

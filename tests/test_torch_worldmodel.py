"""The port's world-model slice as a whole on the CPU: pendulum episodes
from ``btb/episodes.blend.py`` producers launched through fake Blender ->
``RemoteIterableDataset`` -> ``TorchStream(transform=episode_transform)``
-> ``worldmodel.train_on_episodes``, held against
``examples/worldmodel/train_worldmodel.py`` where the two meet: the
episodes, the feed's transform, the attention choice and the training
route on the same batches.

Tolerance: the training route runs in the default bf16 compute on both
sides, so its losses agree to rtol 2e-2 (bf16 keeps about three
significant digits and the frameworks round at different places)."""

import importlib.util
import socket
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from blendjax.models import seqformer as jseq
from blendjax.models.train import TrainState as JTrainState
from blendjax_torch import worldmodel
from blendjax_torch.btb.pendulum import simulate_episode
from blendjax_torch.btt.dataset import RemoteIterableDataset
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.prefetch import TorchStream, device_prefetch
from blendjax_torch.models.convert import params_from_jax
from blendjax_torch.models.train import TrainState

HERE = Path(__file__).resolve().parent
FAKE_BLENDER = HERE / "helpers" / "fake_blender.py"
SEED, SEQ_LEN, BATCH = 5, 17, 4


def _example():
    path = HERE.parent / "examples" / "worldmodel" / "train_worldmodel.py"
    spec = importlib.util.spec_from_file_location("train_worldmodel_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_pair():
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
    raise RuntimeError("no free port pair")


@pytest.fixture
def fleet(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", str(FAKE_BLENDER))
    args = ["--seq-len", str(SEQ_LEN), "--obs-dim", "8"]
    with BlenderLauncher(scene="", script=str(worldmodel.SCRIPT), num_instances=2,
                         named_sockets=["DATA"], start_port=_port_pair(), background=True,
                         seed=SEED, instance_args=[args, args]) as bl:
        yield bl.launch_info.addresses["DATA"]


@pytest.mark.parametrize("batch,steps,seed", [(3, 64, 0), (1, 7, 123)])
def test_simulate_episode_equals_the_example(batch, steps, seed):
    ref = _example().simulate_episode(np.random.default_rng(seed), batch, T_steps=steps)
    got = worldmodel.simulate_episode(np.random.default_rng(seed), batch, T_steps=steps)
    assert got.dtype == np.float32 and got.shape == (batch, steps + 1, 8)
    np.testing.assert_array_equal(got, ref)
    wide = simulate_episode(np.random.default_rng(seed), batch, steps, obs_dim=32)
    np.testing.assert_array_equal(wide[..., :8], ref)
    assert not wide[..., 8:].any()


def test_episode_transform_and_attention_choice_match_the_example():
    ex = _example()
    batch = {"obs_seq": np.random.default_rng(0).standard_normal((2, 5, 8)).astype(np.float32),
             "episode": np.arange(2)}
    got, want = worldmodel.episode_transform(batch), ex.episode_transform(batch)
    assert set(got) == set(want) == {"episode"}
    assert got["episode"].dtype == np.float16
    np.testing.assert_array_equal(got["episode"], want["episode"])
    assert worldmodel.make_attn("full", 64) is None and ex.make_attn("full", 64) is None
    for name in worldmodel.PARALLEL_ATTN:
        with pytest.raises(ValueError, match="parallel scheme"):
            worldmodel.make_attn(name, 64)
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 2, 16))
                         .astype(np.float32))
    for window in (None, 24):
        got = worldmodel.make_attn("flash", 64, window=window)(q, q, q)
        want = ex.make_attn("flash", 64, window=window)(*(q.numpy(),) * 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    full = worldmodel.make_attn("full", 64, window=24)(q, q, q)
    np.testing.assert_allclose(full.numpy(), np.asarray(ex.make_attn("full", 64, window=24)(
        *(q.numpy(),) * 3)), atol=2e-5, rtol=2e-5)


def test_prefetch_applies_the_transform_before_staging():
    batches = [{"x": np.full((2, 3), i, np.float32), "drop": np.zeros(1)} for i in range(3)]
    out = list(device_prefetch(iter(batches), device="cpu",
                               transform=lambda b: {"x": b["x"].astype(np.float16)}))
    assert [set(b) for b in out] == [{"x"}] * 3
    assert all(b["x"].dtype == torch.float16 for b in out)
    assert [float(b["x"][0, 0]) for b in out] == [0.0, 1.0, 2.0]


def test_streamed_episodes_arrive_as_the_producers_made_them(fleet):
    def keep_ids(batch):
        return {**worldmodel.episode_transform(batch), "btid": batch["btid"],
                "n": batch["episode"]}

    ds = RemoteIterableDataset(fleet, max_items=4 * BATCH)
    seen = 0
    with TorchStream(ds, batch_size=BATCH, num_workers=2, device="cpu",
                     transform=keep_ids) as stream:
        for batch in stream:
            ep = batch["episode"]
            assert ep.dtype == torch.float16 and tuple(ep.shape) == (BATCH, SEQ_LEN, 8)
            for i in range(BATCH):
                btid, n = int(batch["btid"][i]), int(batch["n"][i])
                rng = np.random.default_rng(SEED + btid)
                want = simulate_episode(rng, n + 1, SEQ_LEN - 1)[n]
                np.testing.assert_array_equal(ep[i].numpy(), want.astype(np.float16))
            seen += BATCH
    assert seen == 4 * BATCH
    assert stream.timer.count("device_put") == 4


def test_train_on_streamed_episodes(fleet):
    ds = RemoteIterableDataset(fleet, max_items=3 * BATCH)
    with TorchStream(ds, batch_size=BATCH, num_workers=1, device="cpu",
                     transform=worldmodel.episode_transform) as stream:
        state, losses = worldmodel.train_on_episodes(
            stream, attn=worldmodel.make_attn("flash", SEQ_LEN - 1), d_model=32, n_heads=2,
            n_layers=2, seq_len=SEQ_LEN - 1, log_every=0, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert state.step == 3
    assert state.optimizer.param_groups[0]["lr"] == 3e-4


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_training_route_matches_the_example(attn):
    """The example's ``train_on_episodes`` and the port's on the same
    float16 episode batches from the same JAX-initialized parameters:
    Adam(3e-4), bf16 compute, three steps."""
    ex = _example()
    rng = np.random.default_rng(9)
    batches = [worldmodel.episode_transform(
        {"obs_seq": simulate_episode(rng, 2, ex.T)}) for _ in range(3)]
    tree = jseq.init(jax.random.PRNGKey(0), obs_dim=8, d_model=32, n_heads=2, n_layers=2,
                     max_len=ex.T)
    state = TrainState.create(params_from_jax(jax.tree.map(np.asarray, tree), device="cpu"),
                              lr=3e-4)
    jstate = JTrainState.create(tree, optax.adam(3e-4))
    _, jlosses = ex.train_on_episodes(
        [{"episode": jax.numpy.asarray(b["episode"])} for b in batches], state=jstate,
        attn=ex.make_attn(attn, ex.T), log_every=0)
    _, losses = worldmodel.train_on_episodes(
        [{"episode": torch.from_numpy(b["episode"])} for b in batches], state=state,
        attn=worldmodel.make_attn(attn, worldmodel.T), log_every=0, device="cpu")
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2,2,2"], "ROADMAP Queue 1, item 7"),
    (["--dream", "8"], "ROADMAP Queue 1, item 5"),
    (["--dream-int8"], "ROADMAP Queue 1, item 5"),
    (["--attn", "ring_flash"], "ROADMAP Queue 1, item 7"),
])
def test_options_not_ported_exit_with_their_roadmap_item(argv, match):
    with pytest.raises(SystemExit, match=match):
        worldmodel.main(argv)

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
from helpers.time_limit import time_limit

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


@time_limit(180)
def test_mesh_trains_ring_flash_on_two_ranks(monkeypatch):
    """``--mesh 1,2,1 --attn ring_flash`` on 2 gloo ranks at a small size:
    one producer behind the first rank, whose batches both ranks train on,
    each on its half of the sequence; both print the same finite losses.
    A ``--mesh`` whose product is not the world's size exits with the
    reference's message."""
    from helpers import torch_parallel_ranks
    from helpers.torch_ranks import Ranks

    ranks = Ranks(torch_parallel_ranks.worldmodel_mesh, 2,
                  {"blender": str(FAKE_BLENDER), "port": _port_pair()})
    try:
        lines = ranks.result("ring_flash", 160)
        wrong = ranks.result("wrong_size", 20)
    finally:
        ranks.close()
    trained = [next(ln for ln in lines[r] if ln.startswith("trained ")) for r in (0, 1)]
    assert trained[0] == trained[1] and trained[0].startswith("trained 3 batches; loss ")
    assert all(np.isfinite(float(x)) for x in trained[0].split("loss ")[1].split(" -> "))
    assert any(ln.startswith("stage timing:") for ln in lines[0])
    assert not any(ln.startswith("stage timing:") for ln in lines[1])
    assert wrong == {r: "mesh {'data': 2, 'seq': 2, 'model': 2} needs 8 devices, have 2"
                     for r in (0, 1)}


@pytest.mark.parametrize("argv,match", [
    (["--attn", "ring_flash"], "--attn ring_flash is a parallel scheme; pass --mesh"),
    (["--attn", "ulysses"], "--attn ulysses is a parallel scheme; pass --mesh"),
])
def test_parallel_attn_without_mesh_is_refused(argv, match):
    with pytest.raises(SystemExit, match=match):
        worldmodel.main(argv)


@pytest.mark.parametrize("int8", [False, True], ids=["dream", "dream-int8"])
def test_dream_options_run_at_a_small_size(int8, monkeypatch, capsys):
    """``--dream`` (and ``--dream-int8``) after two training batches from
    one fake-Blender producer, on the CPU: the open-loop rollout prints a
    finite MSE."""
    monkeypatch.setenv("BLENDJAX_BLENDER", str(FAKE_BLENDER))
    argv = ["--instances", "1", "--batch", "2", "--batches", "2", "--device", "cpu",
            "--start-port", str(_port_pair()), "--dream", "8"]
    worldmodel.main(argv + (["--dream-int8"] if int8 else []))
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("dream:"))
    assert "8 open-loop steps from a 32-step prefix" in line
    assert np.isfinite(float(line.rsplit(" ", 1)[1]))


@pytest.mark.parametrize("int8,window", [(False, None), (True, None), (False, 8)])
def test_dream_matches_the_example(int8, window):
    """The port's ``dream`` against the example's on the same params and
    held-out episode: predictions and MSE within 1e-5 (absolute, plus 1e-5
    relative), f32 and int8."""
    ex = _example()
    tree = jax.device_get(jseq.init(jax.random.PRNGKey(0), obs_dim=8, d_model=32,
                                    n_heads=2, n_layers=2, max_len=ex.T))
    episode = ex.simulate_episode(np.random.default_rng(123), batch=2, T_steps=40)

    class _State:
        params = tree

    want, want_mse = ex.dream(_State, episode, 32, 8, window=window, int8=int8)
    state = TrainState.create(params_from_jax(tree, device="cpu"))
    got, mse = worldmodel.dream(state, episode, 32, 8, window=window, int8=int8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mse, want_mse, atol=1e-5, rtol=1e-5)

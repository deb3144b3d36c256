"""The port's datagen slice as a whole on the CPU: fake-Blender producers
launched by the port's launcher -> RemoteIterableDataset -> TorchStream ->
decode -> TinyDetector train steps, held against the JAX route on the same
batches; plus the feed's aliasing hazard and the record/replay route."""

import os
import runpy
import socket
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blendjax.models import detector as jdet
from blendjax.models.train import TrainState as JTrainState
from blendjax.models.train import make_train_step as jmake_train_step
from blendjax.ops.image import decode_frames as jdecode
from blendjax_torch import datagen
from blendjax_torch.btt.dataset import FileDataset, RemoteIterableDataset
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.prefetch import TorchStream, TransferGate, device_prefetch
from blendjax_torch.models.convert import params_from_jax
from blendjax_torch.models.train import TrainState
from blendjax_torch.utils.timing import EventCounters

HERE = Path(__file__).resolve().parent
FAKE_BLENDER = HERE / "helpers" / "fake_blender.py"
H, W, K = 24, 32, 2
SEED = 7


def _port_pair():
    """A start port whose successor is free too (the launcher takes one
    port per producer)."""
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
    args = ["--height", str(H), "--width", str(W), "--keypoints", str(K)]
    with BlenderLauncher(
        scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=2,
        named_sockets=["DATA"], start_port=_port_pair(), background=True,
        seed=SEED, instance_args=[args, args],
    ) as bl:
        yield bl.launch_info.addresses["DATA"]


def _make_frame():
    return runpy.run_path(str(datagen.FRAMES_SCRIPT), run_name="frames")["make_frame"]


def _keep_ids(item):
    return {**datagen.item_transform(item), "btid": item["btid"],
            "frameid": item["frameid"]}


def test_stream_batches_arrive_complete_and_equal(fleet):
    make_frame = _make_frame()
    ds = RemoteIterableDataset(fleet, max_items=32, item_transform=_keep_ids)
    seen = 0
    # the gate on: workers pause at batch boundaries during each transfer
    with TorchStream(ds, batch_size=4, num_workers=2, device="cpu",
                     transfer_gate=True) as stream:
        for batch in stream:
            assert batch["image"].dtype == torch.uint8
            assert tuple(batch["image"].shape) == (4, H, W, 3)
            assert tuple(batch["xy"].shape) == (4, K, 2)
            for i in range(4):
                btid, fid = int(batch["btid"][i]), int(batch["frameid"][i])
                image, xy = make_frame(SEED + btid, fid, H, W, K)
                np.testing.assert_array_equal(batch["image"][i].numpy(), image)
                np.testing.assert_array_equal(
                    batch["xy"][i].numpy(),
                    (xy / np.array([640, 480], np.float32)).astype(np.float32))
            seen += 4
    assert seen == 32
    assert stream.timer.count("device_put") == 8


def test_held_batch_keeps_its_values():
    """A producer that refills one buffer in place (a recycled arena)
    must not rewrite a batch already handed out: CPU batches own their
    memory instead of aliasing the host array."""
    buf = np.zeros((4, 3), np.float32)

    def recycled():
        for i in range(3):
            buf[...] = i
            yield {"x": buf}

    it = device_prefetch(recycled(), size=1, device="cpu")
    first = next(it)
    rest = list(it)
    assert [float(b["x"][0, 0]) for b in rest] == [1.0, 2.0]
    np.testing.assert_array_equal(first["x"].numpy(), np.zeros((4, 3), np.float32))


def test_transfer_gate_opens_when_the_last_transfer_ends():
    counters = EventCounters()
    gate = TransferGate(timeout=0.2, counters=counters)
    assert gate.wait() is True  # open: nothing in flight
    with gate.transfer():
        with gate.transfer():
            pass
        assert gate.wait() is False  # one transfer still holds it: backstop
        assert counters.get("transfer_gate_backstops") == 1
        stop = threading.Event()
        stop.set()
        assert gate.wait(timeout=10, stop=stop) is False  # stop ends the wait
    assert gate.wait() is True
    assert counters.get("transfer_gate_backstops") == 1


def test_device_prefetch_propagates_errors_and_passes_non_arrays():
    def bad():
        yield {"x": np.ones(2), "name": ["a", "b"]}
        raise KeyError("boom")

    it = device_prefetch(bad(), device="cpu")
    first = next(it)
    assert first["name"] == ["a", "b"] and isinstance(first["x"], torch.Tensor)
    with pytest.raises(KeyError):
        next(it)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(device_prefetch(iter([{"x": np.ones(2)}])))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        datagen.train_on_stream(iter([]))


def test_three_steps_match_the_jax_route(fleet):
    """generate.py's route (decode inside the loss, Adam 1e-3) and the
    port's on the same streamed batches, float32 compute: losses agree
    to rtol 1e-4."""
    ds = RemoteIterableDataset(fleet, max_items=12, item_transform=datagen.item_transform)
    with TorchStream(ds, batch_size=4, num_workers=1, device="cpu") as stream:
        batches = list(stream)
    assert len(batches) == 3

    cfg = dict(num_keypoints=K, channels=(8, 16), hidden=32)
    tree = jdet.init(jax.random.PRNGKey(0), **cfg)

    def jloss(params, batch):
        images = jdecode(batch["image"], dtype=jnp.float32)
        return jdet.loss_fn(params, {"image": images, "xy": batch["xy"]}, jnp.float32)

    jstep = jmake_train_step(jloss, optax.adam(1e-3), donate=False)
    jstate = JTrainState.create(tree, optax.adam(1e-3))
    jlosses = []
    for b in batches:
        jstate, loss = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        jlosses.append(float(loss))

    state = TrainState.create(params_from_jax(jax.tree.map(np.asarray, tree),
                                              device="cpu"))
    _, losses = datagen.train_on_stream(batches, state=state, log_every=0,
                                        dtype=torch.float32)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_record_and_replay(fleet, tmp_path):
    prefix = str(tmp_path / "rec")
    ds = RemoteIterableDataset(fleet, max_items=8, record_path_prefix=prefix)
    live = list(ds)
    replay = FileDataset(prefix)
    assert len(replay) == 8 and os.path.exists(f"{prefix}_00.btr")
    for a, b in zip(live, replay):
        assert a["frameid"] == b["frameid"] and a["btid"] == b["btid"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["xy"], b["xy"])


def _generate_example():
    import importlib.util

    path = HERE.parent / "examples" / "datagen" / "generate.py"
    spec = importlib.util.spec_from_file_location("generate_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_infer_int8_matches_the_example_on_replayed_frames(fleet, tmp_path):
    """``datagen.infer_int8`` (decode to f32, then the int8 detector) on
    recorded frames replayed from disk, against ``generate.py``'s
    ``infer_int8`` on the same frames and converted params: keypoints
    within 1e-5 (absolute, plus 1e-5 relative)."""
    from blendjax_torch.btt.collate import collate

    prefix = str(tmp_path / "rec")
    list(RemoteIterableDataset(fleet, max_items=4, record_path_prefix=prefix))
    raw = collate([FileDataset(prefix)[i] for i in range(4)])["image"]
    assert raw.dtype == np.uint8 and raw.shape == (4, H, W, 3)
    tree = jax.device_get(jdet.init(jax.random.PRNGKey(3), num_keypoints=K,
                                    channels=(8, 16), hidden=32))
    state = TrainState.create(params_from_jax(tree, device="cpu"))
    got = datagen.infer_int8(state, torch.from_numpy(raw))
    want = _generate_example().infer_int8(JTrainState.create(tree, optax.adam(1e-3)),
                                          jnp.asarray(raw))
    assert tuple(got.shape) == (4, K, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

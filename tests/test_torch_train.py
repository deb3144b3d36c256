"""The port's step builders on the CPU: ``make_eval_step`` against the
reference's ``blendjax.models.train.make_eval_step`` on the TinyDetector
and a small SeqFormer from the same converted params; CPU parameters give
eager steps with no capture attempted; a call that needs CUDA raises on a
host without it; and the captured step's bookkeeping (warm-up, one capture
per batch signature, recapture on rebound state, launch counts per
replay), with the graph stood in by the eager step it records."""

import copy
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import detector as jdet
from blendjax.models import seqformer as jseq
from blendjax.models.train import make_eval_step as jmake_eval_step
from blendjax.ops.flash_attention import make_flash_attention as jmake_flash
from blendjax_torch.models import detector as tdet
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.models import train
from blendjax_torch.models.convert import params_from_jax
from blendjax_torch.models.train import TrainState, make_eval_step, make_train_step
from blendjax_torch.ops.flash_attention import make_flash_attention as tmake_flash
from blendjax_torch.utils import launches

DET = dict(num_keypoints=2, channels=(8, 16), hidden=32)
DET_SHAPE = (2, 33, 48, 3)
SEQ = dict(obs_dim=6, d_model=64, n_heads=4, n_layers=2, max_len=64)


def _det_case(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random(DET_SHAPE, dtype=np.float32)
    xy = rng.random((DET_SHAPE[0], DET["num_keypoints"], 2), dtype=np.float32)
    tree = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0), **DET))
    return tree, {"image": images, "xy": xy}


def _seq_case(seed=1):
    ep = np.random.default_rng(seed).standard_normal((2, 65, SEQ["obs_dim"])).astype(np.float32)
    tree = jax.tree.map(np.asarray, jseq.init(jax.random.PRNGKey(0), **SEQ))
    return tree, {"episode": ep}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax_on_the_detector(dtype):
    """Tolerances of tests/test_torch_detector.py's loss check."""
    tree, batch = _det_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jmake_eval_step(functools.partial(jdet.loss_fn, compute_dtype=jdt))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    evaluate = make_eval_step(functools.partial(tdet.loss_fn, compute_dtype=tdt))
    params = params_from_jax(tree, device="cpu")
    loss = evaluate(params, _torch_batch(batch))
    assert loss.shape == () and not loss.requires_grad
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(ref), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(float(loss), float(ref), rtol=2e-2)
    assert evaluate.graphs == {}  # CPU params: eager, nothing captured


@pytest.mark.parametrize("attn", ["full", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax_on_a_small_seqformer(attn, dtype):
    """Tolerances of tests/test_torch_seqformer.py's loss check; the
    reference's flash kernels run in interpret mode."""
    tree, batch = _seq_case()
    jattn, tattn = None, None
    if attn == "flash":
        jattn = jmake_flash(causal=True, block_q=64, block_kv=64, interpret=True)
        tattn = tmake_flash(causal=True, block_q=64, block_kv=64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jmake_eval_step(functools.partial(jseq.episode_loss_fn, attn_fn=jattn,
                                            compute_dtype=jdt))(
        tree, {"episode": jnp.asarray(batch["episode"])})
    evaluate = make_eval_step(functools.partial(tseq.episode_loss_fn, attn_fn=tattn,
                                                compute_dtype=tdt))
    loss = evaluate(params_from_jax(tree, device="cpu"), _torch_batch(batch))
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss), float(ref), rtol=rtol)


def test_eval_step_leaves_no_gradient():
    tree, batch = _det_case()
    state = TrainState.create(params_from_jax(tree, device="cpu"))
    loss = make_eval_step(functools.partial(tdet.loss_fn, compute_dtype=torch.float32))(
        state.params, _torch_batch(batch))
    assert loss.grad_fn is None
    assert all(p.grad is None for p in state.params.values())


def test_cpu_params_give_an_eager_step(monkeypatch):
    """No capture is attempted for CPU parameters: the step never touches
    a CUDA graph, and it equals the eager step it always was."""
    def no_graphs(*args, **kwargs):
        raise AssertionError("a CPU step tried to capture")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graphs)
    monkeypatch.setattr(torch.cuda, "graph", no_graphs)
    tree, batch = _det_case()
    loss_fn = functools.partial(tdet.loss_fn, compute_dtype=torch.float32)
    states = [TrainState.create(params_from_jax(tree, device="cpu")) for _ in range(2)]
    assert not states[0].optimizer.defaults["capturable"]  # CPU: the eager Adam
    losses = {}
    for capture, state in zip((None, False), states):
        step = make_train_step(loss_fn, capture=capture)
        out = []
        for _ in range(3):
            state, loss = step(state, _torch_batch(batch))
            out.append(float(loss))
        assert state.step == 3 and step.graphs == {}
        losses[capture] = out
    assert losses[None] == losses[False]
    for k in states[0].params:
        assert torch.equal(states[0].params[k], states[1].params[k])


def test_cuda_only_calls_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree, batch = _det_case()
    state = TrainState.create(params_from_jax(tree, device="cpu"))
    loss_fn = functools.partial(tdet.loss_fn, compute_dtype=torch.float32)
    before = {k: v.clone() for k, v in state.params.items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(loss_fn, capture=True)(state, _torch_batch(batch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(loss_fn, capture=True)(state.params, _torch_batch(batch))
    # nothing ran on the host instead
    assert state.step == 0
    assert all(torch.equal(before[k], v) for k, v in state.params.items())


def test_a_captured_step_takes_tensor_leaves_only():
    ok = list(train._leaves({"x": torch.ones(2), "t": (torch.zeros(1),)}))
    assert [p for p, _ in ok] == [("x",), ("t", 0)]
    with pytest.raises(TypeError, match="tensor leaves only"):
        list(train._leaves({"x": torch.ones(2), "names": ["a", "b"]}))


@pytest.fixture
def counted_kernel():
    def kernel(route="tc"):
        kernel.launches += 1
        kernel.launches_by_route[route] += 1

    launches.counted(kernel, ("tc", "f32"))
    yield kernel
    launches._COUNTED.remove(kernel)


def test_launch_counts_move_from_capture_to_replay(counted_kernel):
    before = launches.snapshot()
    counted_kernel()
    counted_kernel("f32")
    per = launches.since(before)
    assert per == [(counted_kernel, 2, {"tc": 1, "f32": 1})]
    launches.add(per, times=-1)  # a capture launches nothing
    assert counted_kernel.launches == 0
    launches.add(per)
    launches.add(per)  # two replays
    assert counted_kernel.launches == 4
    assert counted_kernel.launches_by_route == {"tc": 2, "f32": 2}


class _RecordedGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the step it
    recorded over the static inputs, into the static output."""

    def __init__(self, run, static, output):
        self.run, self.static, self.output = run, static, output

    def replay(self):
        self.output.copy_(self.run(self.static))


def _stand_in_graphs(monkeypatch, counted_kernel):
    """Warm-up steps and captures on the CPU, each logged to the returned
    list; a capture records a :class:`_RecordedGraph` that counts one
    launch of ``counted_kernel`` per replay."""
    events = []

    def warm(run, batch, leaves, device):
        events.append("warm")
        return run(batch)

    def capture(run, batch, leaves, device):
        events.append(("capture", tuple(t.shape for _, t in leaves)))
        inputs = [torch.empty_like(t) for _, t in leaves]
        static = train._rebuild(batch, iter(inputs))
        output = torch.zeros(())
        return train._Graph(_RecordedGraph(run, static, output), inputs, output,
                            [(counted_kernel, 1, {"tc": 1, "f32": 0})])

    monkeypatch.setattr(train, "_on_side_stream", warm)
    monkeypatch.setattr(train, "_capture", capture)
    monkeypatch.setattr(train, "_captures", lambda capture, tensors: capture is not False)
    return events


def test_captured_step_bookkeeping(monkeypatch, counted_kernel):
    """Warm-up steps, then one capture per batch signature, replays after
    it, a fresh loss tensor per call, launch counts per replay, and a new
    capture when the state is rebound."""
    events = _stand_in_graphs(monkeypatch, counted_kernel)

    tree, batch = _det_case()
    loss_fn = functools.partial(tdet.loss_fn, compute_dtype=torch.float32)
    state = TrainState.create(params_from_jax(tree, device="cpu"))
    eager_state = TrainState.create(params_from_jax(tree, device="cpu"))
    assert train.WARMUP_STEPS == 2
    step, eager = make_train_step(loss_fn), make_train_step(loss_fn, capture=False)
    got, want = [], []
    for i in range(5):
        b = _torch_batch(_det_case(seed=i)[1])
        state, loss = step(state, b)
        eager_state, ref = eager(eager_state, b)
        got.append(loss)
        want.append(float(ref))
    assert events == ["warm", "warm", ("capture", ((2, 33, 48, 3), (2, 2, 2)))]
    assert counted_kernel.launches == 3  # one per replay: calls 3, 4 and 5
    assert [float(x) for x in got] == want
    assert len({id(x) for x in got}) == 5  # each call its own loss tensor
    assert state.step == 5 and len(step.graphs) == 1

    # a new batch signature: its own warm-up and capture
    small = _torch_batch(_det_case()[1])
    small = {"image": small["image"][:1], "xy": small["xy"][:1]}
    for _ in range(3):
        state, _ = step(state, small)
    assert events[3:] == ["warm", "warm", ("capture", ((1, 33, 48, 3), (1, 2, 2)))]
    assert len(step.graphs) == 2

    # rebound parameters: the graphs are dropped and captured anew
    state = TrainState.create({k: v.detach().clone() for k, v in state.params.items()})
    events.clear()
    for _ in range(3):
        state, _ = step(state, small)
    assert events == ["warm", "warm", ("capture", ((1, 33, 48, 3), (1, 2, 2)))]
    assert len(step.graphs) == 1


def test_capture_gate_holds_the_collector_off():
    """While any capture is open Python's cyclic collector is off (a dead
    cycle holding an old CUDA graph, collected in the capturing thread,
    would destroy it mid-capture), and its state comes back once the last
    capture closes."""
    gate = train.CaptureGate()
    assert gc.isenabled()
    with gate.capturing():
        assert not gc.isenabled()
        with gate.capturing():
            assert not gc.isenabled()
        assert not gc.isenabled()  # one capture still open
    assert gc.isenabled()
    gc.disable()
    try:
        with gate.capturing():
            pass
        assert not gc.isenabled()  # a collector that was off stays off
    finally:
        gc.enable()


def test_captured_step_recaptures_after_optimizer_load_state_dict(monkeypatch,
                                                                  counted_kernel):
    """Resuming Adam with ``load_state_dict`` replaces its state tensors in
    the same optimizer object: the graphs, which hold the old tensors'
    addresses, are dropped and the step captured anew over the new ones."""
    events = _stand_in_graphs(monkeypatch, counted_kernel)
    tree, _ = _det_case()
    loss_fn = functools.partial(tdet.loss_fn, compute_dtype=torch.float32)
    state = TrainState.create(params_from_jax(tree, device="cpu"))
    eager_state = TrainState.create(params_from_jax(tree, device="cpu"))
    step, eager = make_train_step(loss_fn), make_train_step(loss_fn, capture=False)
    batches = [_torch_batch(_det_case(seed=i)[1]) for i in range(6)]
    for b in batches[:3]:
        state, _ = step(state, b)
        eager_state, _ = eager(eager_state, b)
    assert events == ["warm", "warm", ("capture", ((2, 33, 48, 3), (2, 2, 2)))]

    # a checkpoint's optimizer state, loaded into the same optimizers
    saved = copy.deepcopy(eager_state.optimizer.state_dict())
    old = dict(train._optimizer_tensors(state.optimizer))
    state.optimizer.load_state_dict(copy.deepcopy(saved))
    eager_state.optimizer.load_state_dict(copy.deepcopy(saved))
    new = train._optimizer_tensors(state.optimizer)
    assert new.keys() == old.keys() and all(new[k] is not old[k] for k in old)
    events.clear()
    got, want = [], []
    for b in batches[3:]:
        state, loss = step(state, b)
        eager_state, ref = eager(eager_state, b)
        got.append(float(loss))
        want.append(float(ref))
    assert events == ["warm", "warm", ("capture", ((2, 33, 48, 3), (2, 2, 2)))]
    assert len(step.graphs) == 1
    assert got == want
    for k, v in state.params.items():
        torch.testing.assert_close(v, eager_state.params[k], rtol=0, atol=0)

"""The port's region ranges and their attribution
(``blendjax_torch.obs.regions``), on the CPU with a tiny SeqFormer.

1. **One eager step under the profiler** (CPU activity): ``kernel_table``'s
   CPU-op path gives every leaf ``aten::`` op of the forward, the backward
   and Adam a region; backward ops take the region of the forward op whose
   autograd node ran them (the layer norms' in ``seqformer.norm``).
2. **No profiler, no range**: ``region`` opens no profiler range while none
   records, and a profiled step computes the same bits as one without.
3. **The device path** on stand-in profiler events: device ops take the
   region of the runtime call that launched them, a graph's kernels group
   by their ``cudaGraphLaunch``, and ``place`` aligns replays with the
   table, counting what it cannot place.
4. **The captured step's dispatch** with the graph stood in by the step it
   records: one range of each dispatch part a replayed call, and none in the
   eval step.
"""

import collections
import functools
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval
from torch.profiler import ProfilerActivity, profile

from blendjax_torch.models import seqformer, train
from blendjax_torch.models.train import TrainState, make_eval_step, make_train_step
from blendjax_torch.obs import regions

TINY = dict(obs_dim=6, d_model=32, n_heads=4, n_layers=2, max_len=32)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return TrainState.create(seqformer.init(g, device="cpu", **TINY))


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"episode": torch.randn(2, 17, TINY["obs_dim"], generator=g)}


LOSS = functools.partial(seqformer.episode_loss_fn, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def profiled_step():
    """A tiny SeqFormer's second eager step under the profiler (the first
    makes Adam's state): its events and ``kernel_table``."""
    state, step = _state(), make_train_step(LOSS)
    state, _ = step(state, _batch())
    batch = _batch(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = list(prof.events())
    return events, regions.kernel_table(events)


def _leaf_ops(events):
    return sorted((e for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("aten::")
                   and not any(c.name.startswith("aten::") for c in e.cpu_children)),
                  key=lambda e: e.time_range.start)


def _under(e, prefix):
    """The name after ``prefix`` of the innermost event above ``e`` whose
    name starts with it, or None."""
    return next((p.name[len(prefix):] for p in regions._chain(e) if p.name.startswith(prefix)),
                None)


def test_an_eager_step_puts_every_op_in_one_region(profiled_step):
    """Every leaf op has a region but the step's last, the ``detach`` of the
    loss it returns, which is outside the forward, the backward and Adam."""
    events, table = profiled_step
    assert [n for n, _ in table] == [e.name for e in _leaf_ops(events)]
    assert table[-1] == ("aten::detach", None)
    assert all(r in regions.NAMES for _, r in table[:-1])
    assert {r for _, r in table[:-1]} == set(regions.MODEL) | {"train.backward", "train.adam"}


@pytest.mark.parametrize("node, want", [
    ("VarBackward0", "seqformer.norm"),
    ("RsqrtBackward0", "seqformer.norm"),
    ("MeanBackward1", "seqformer.norm"),
    ("GeluBackward0", "seqformer.mlp"),
    ("SoftmaxBackward0", "seqformer.attention"),
    ("MeanBackward0", "seqformer.io"),
    ("torch::autograd::AccumulateGrad", "train.backward"),
])
def test_backward_ops_take_their_forward_region(profiled_step, node, want):
    events, _ = profiled_step
    regions_of = regions._Profile(events).region
    got = collections.Counter(regions_of(e) for e in _leaf_ops(events)
                              if _under(e, regions._BACKWARD) == node)
    assert got and set(got) == {want}


def test_adam_ops_land_in_adam(profiled_step):
    events, _ = profiled_step
    regions_of = regions._Profile(events).region
    got = {regions_of(e) for e in _leaf_ops(events) if _under(e, "Optimizer.step#")}
    assert got == {"train.adam"}


def test_region_enters_no_range_without_a_profiler(monkeypatch):
    entered = []
    fast = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return fast(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    state, step = _state(), make_train_step(LOSS)
    state, _ = step(state, _batch())
    assert entered == []
    assert regions.region("seqformer.norm") is regions.region(None)
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    per_block = ["seqformer.attention", "seqformer.norm", "seqformer.mlp", "seqformer.norm"]
    want = (["train.zero_grad", "seqformer.io", "seqformer.io"] + per_block * TINY["n_layers"]
            + ["seqformer.norm", "seqformer.io", "seqformer.io", "train.backward",
               "train.adam"])
    assert entered == want


def test_a_profiled_step_computes_the_same_bits():
    a, b = _state(), _state()
    step_a, step_b = make_train_step(LOSS), make_train_step(LOSS)
    for i in range(2):
        batch = _batch(i)
        a, loss_a = step_a(a, batch)
        with profile(activities=[ProfilerActivity.CPU]):
            b, loss_b = step_b(b, batch)
        assert torch.equal(loss_a, loss_b)
        for k, p in a.params.items():
            assert torch.equal(p.grad, b.params[k].grad), k
            assert torch.equal(p, b.params[k]), k


# -- the device path on stand-in events ----------------------------------------


class _Events:
    """Stand-in profiler events: host events nest by time on their thread
    (``cpu_parent``, as the profiler's tree), device events stand alone."""

    def __init__(self):
        self.events = []

    def add(self, name, start, end, thread=1, device=False, seq=-1, fwd_thread=0, id=0,
            annotation=False):
        e = types.SimpleNamespace(
            name=name, time_range=Interval(start, end), thread=thread, sequence_nr=seq,
            fwd_thread=fwd_thread, id=id, is_user_annotation=annotation,
            device_type=DeviceType.CUDA if device else DeviceType.CPU, cpu_parent=None,
            cpu_children=[])
        self.events.append(e)
        return e

    def done(self):
        host = sorted((e for e in self.events if e.device_type == DeviceType.CPU),
                      key=lambda e: (e.thread, e.time_range.start, -e.time_range.end))
        for e in host:
            around = [p for p in host if p is not e and p.thread == e.thread
                      and p.time_range.start <= e.time_range.start
                      and e.time_range.end <= p.time_range.end]
            if around:
                e.cpu_parent = max(around, key=lambda p: p.time_range.start)
                e.cpu_parent.cpu_children.append(e)
        return self.events


def _eager_step():
    """One eager step: a norm's forward kernel, a GEMM in attention, their
    backward kernels on the autograd thread (2), Adam's kernel, and the
    device annotation a user range would add."""
    ev = _Events()
    ev.add("seqformer.attention", 0, 40)
    ev.add("seqformer.norm", 1, 10)
    ev.add("aten::mul", 2, 9, seq=7)
    ev.add("cudaLaunchKernel", 3, 4, id=101)
    ev.add("aten::mm", 12, 20, seq=8)
    ev.add("cudaLaunchKernel", 13, 14, id=102)
    ev.add("train.backward", 50, 90)
    ev.add("autograd::engine::evaluate_function: MmBackward0", 51, 60, thread=2, seq=8,
           fwd_thread=1)
    ev.add("cudaLaunchKernel", 52, 53, thread=2, id=103)
    ev.add("autograd::engine::evaluate_function: MulBackward0", 61, 70, thread=2, seq=7,
           fwd_thread=1)
    ev.add("cudaLaunchKernel", 62, 63, thread=2, id=104)
    ev.add("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", 71, 75,
           thread=2)
    ev.add("cudaLaunchKernel", 72, 73, thread=2, id=105)
    ev.add("train.adam", 100, 120)
    ev.add("cudaLaunchKernel", 101, 102, id=106)
    for i, name in enumerate(["k_mul", "k_gemm", "k_gemm_bwd", "k_mul_bwd", "k_acc", "k_adam"]):
        ev.add(name, 200 + 10 * i, 205 + 10 * i, device=True, id=101 + i)
    ev.add("seqformer.attention", 200, 220, device=True, id=101, annotation=True)
    return ev.done()


TABLE = [("k_mul", "seqformer.norm"), ("k_gemm", "seqformer.attention"),
         ("k_gemm_bwd", "seqformer.attention"), ("k_mul_bwd", "seqformer.norm"),
         ("k_acc", "train.backward"), ("k_adam", "train.adam")]


def test_device_ops_take_the_region_of_their_launch():
    assert regions.kernel_table(_eager_step()) == TABLE


def _replays(n, names=None):
    """``n`` replayed calls: input copy, the graph's kernels (5 us each),
    the loss's clone, and the harness's marker spins around them."""
    ev = _Events()
    names = names or [n for n, _ in TABLE]
    ev.add("spin_kernel", 0, 1, device=True, id=1)
    ev.add("cudaLaunchKernel", 0, 1, id=1)
    for r in range(n):
        t, base = 1000 * (r + 1), 10 * (r + 1)
        ev.add("train.guard", t, t + 5)
        ev.add("train.copy_inputs", t + 5, t + 10)
        ev.add("cudaMemcpyAsync", t + 6, t + 7, id=base + 1)
        ev.add("train.replay", t + 10, t + 20)
        ev.add("cudaGraphLaunch", t + 11, t + 19, id=base + 2)
        ev.add("train.output", t + 20, t + 30)
        ev.add("aten::clone", t + 21, t + 29)
        ev.add("cudaLaunchKernel", t + 22, t + 23, id=base + 3)
        ev.add("Memcpy DtoD", t + 100, t + 102, device=True, id=base + 1)
        for i, name in enumerate(names):
            ev.add(name, t + 110 + 10 * i, t + 115 + 10 * i, device=True, id=base + 2)
        ev.add("k_copy", t + 900, t + 901, device=True, id=base + 3)
    ev.add("spin_kernel", 99000, 99001, device=True, id=2)
    return ev.done()


def test_split_places_each_replay_and_its_dispatch():
    steps, by = regions.split(_replays(3), TABLE, lo=1, hi=99000)
    assert steps == 3
    want = {"seqformer.norm": [10e-6, 2], "seqformer.attention": [10e-6, 2],
            "train.backward": [5e-6, 1], "train.adam": [5e-6, 1], regions.UNPLACED: [0, 0],
            "train.copy_inputs": [2e-6, 1], "train.output": [1e-6, 1]}
    assert by.keys() == want.keys()
    for k, (s, n) in want.items():
        assert by[k][0] == pytest.approx(s) and by[k][1] == pytest.approx(n), k


def test_split_keys_by_region_and_class():
    _, by = regions.split(_replays(2), TABLE, lo=1, hi=99000,
                          classify=lambda n: "gemm" if "gemm" in n else "other")
    assert by[("seqformer.attention", "gemm")] == pytest.approx([10e-6, 2])
    assert by[("seqformer.norm", "other")] == pytest.approx([10e-6, 2])
    assert ("seqformer.norm", "gemm") not in by


def _ops(names, us=5):
    return [(n, us * 1e-6) for n in names]


NAMES = [n for n, _ in TABLE]


@pytest.mark.parametrize("case, replay, unplaced", [
    ("exact", NAMES, []),
    ("one op more", NAMES[:2] + ["k_new"] + NAMES[2:], ["k_new"]),
    ("one op fewer", NAMES[:3] + NAMES[4:], []),
    ("one op renamed", NAMES[:1] + ["k_other"] + NAMES[2:], ["k_other"]),
])
def test_place_aligns_a_replay_with_the_table(case, replay, unplaced):
    by = regions.place([_ops(replay)] * 2, TABLE)
    assert by[regions.UNPLACED] == pytest.approx([5e-6 * len(unplaced), len(unplaced)])
    assert sum(s for s, _ in by.values()) == pytest.approx(5e-6 * len(replay))
    assert sum(n for _, n in by.values()) == len(replay)
    placed = collections.Counter(r for n, r in TABLE if n in replay)
    for r, k in placed.items():
        assert by[r][1] == k, case


# -- the captured step's dispatch ----------------------------------------------


class _RecordedGraph:
    def __init__(self, run, static, output):
        self.run, self.static, self.output = run, static, output

    def replay(self):
        self.output.copy_(self.run(self.static))


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Warm-up steps and captures on the CPU: a capture records the step it
    would capture, and a replay runs it."""
    def capture(run, batch, leaves, device):
        inputs = [torch.empty_like(t) for _, t in leaves]
        static = train._rebuild(batch, iter(inputs))
        output = run(static).clone()
        return train._Graph(_RecordedGraph(run, static, output), inputs, output, [])

    monkeypatch.setattr(train, "_on_side_stream", lambda run, batch, leaves, device: run(batch))
    monkeypatch.setattr(train, "_capture", capture)
    monkeypatch.setattr(train, "_captures", lambda capture, tensors: capture is not False)


def _ranges(prof):
    return collections.Counter(e.name for e in prof.events() if e.name in regions.NAMES)


def test_a_replayed_call_opens_each_dispatch_range_once(stand_in_graphs):
    state, step = _state(), make_train_step(LOSS)
    for i in range(3):  # two warm-ups and the capture
        state, _ = step(state, _batch(i))
    batches = [_batch(i) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in batches:
            state, _ = step(state, batch)
    got = _ranges(prof)
    assert all(got[name] == 2 for name in regions.DISPATCH), got


def test_the_eval_step_opens_no_dispatch_range(stand_in_graphs):
    state = _state()
    evaluate = make_eval_step(LOSS)
    for i in range(3):
        evaluate(state.params, _batch(i))
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        evaluate(state.params, batch)
    assert not any(name in regions.DISPATCH for name in _ranges(prof))

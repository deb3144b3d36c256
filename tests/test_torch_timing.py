"""The port's ``StageTimer`` and ``LatencyHistogram`` against the reference's
``tests/test_timing.py`` and the histogram and timer cases of
``tests/test_obs.py``, on the CPU; then across the packages and through the
feed.

1. **The reference's cases** on the port: accumulation, duty cycle, thread
   safety, the Chrome trace-event export and its refusal with tracing off,
   ``reset``; histogram quantiles within the bucket error, the bucket range,
   merge as the union, the dict round trip; the timer's percentiles, its
   histograms' ``n``/``sum_s`` kept with its counts, ``add_bulk`` at the
   mean, the bounded trace ring.
2. **Across the packages**: one fixed sequence of ``add``/``add_bulk``
   calls gives equal ``summary()``, percentiles, serialized snapshots,
   exported ``(name, dur)`` lists and ``trace_dropped`` in both timers (a
   small trace ring too); ``BatchLoader``'s
   length equals the reference's.
3. **The traced feed**: ``TorchStream(timer=StageTimer(trace=True),
   device="cpu")`` over one fake-Blender producer records every feed stage
   on the thread that did the work, and the caller's ``step`` on its own.
"""

import json
import threading
import time

import numpy as np
import pytest

from blendjax.btt.loader import BatchLoader as JBatchLoader
from blendjax.utils.timing import StageTimer as JStageTimer
from blendjax_torch.btt.loader import BatchLoader
from blendjax_torch.obs.histogram import LatencyHistogram, bucket_bounds, bucket_index
from blendjax_torch.utils import timing
from blendjax_torch.utils.timing import DEFAULT_TRACE_CAP, StageTimer

# -- tests/test_timing.py ------------------------------------------------------


def test_summary_and_means():
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["total_s"] >= 0.02
    assert s["a"]["mean_ms"] >= 10
    assert s["b"]["count"] == 1
    assert t.duty_cycle("a") > 0
    assert t.total_s("a") >= 0.02 and t.mean_ms("a") >= 10
    assert 0 < t.duty_cycle("a") <= 1 and t.wall_s >= t.total_s("a")


def test_concurrent_stages():
    t = StageTimer()

    def work():
        for _ in range(100):
            with t.stage("x"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert t.count("x") == 400


def test_chrome_trace_export(tmp_path):
    t = StageTimer(trace=True)
    with t.stage("recv"):
        time.sleep(0.005)
    with t.stage("collate"):
        time.sleep(0.002)
    path = tmp_path / "trace.json"
    n = t.export_chrome_trace(str(path))
    assert n == 2
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert {e["name"] for e in events} == {"recv", "collate"}
    for e in events:
        assert e["ph"] == "X"
        assert e["dur"] > 0
        assert e["ts"] >= 0
    # events from this (single) thread share a row
    assert len({e["tid"] for e in events}) == 1


def test_trace_off_raises(tmp_path):
    t = StageTimer()
    with t.stage("a"):
        pass
    with pytest.raises(RuntimeError):
        t.export_chrome_trace(str(tmp_path / "never.json"))
    assert not (tmp_path / "never.json").exists()


def test_reset_clears_events(tmp_path):
    t = StageTimer(trace=True)
    with t.stage("a"):
        pass
    t.reset()
    path = tmp_path / "trace.json"
    assert t.export_chrome_trace(str(path)) == 0
    assert t.count("a") == 0 and t.summary() == {}


# -- tests/test_obs.py: histograms -------------------------------------------------


def _quantile_err(values, hist, q):
    values = sorted(values)
    true = values[min(int(q * len(values)), len(values) - 1)]
    est = hist.quantile(q)
    return abs(est - true) / true


@pytest.mark.parametrize("dist", ["uniform", "exponential", "bimodal"])
def test_histogram_quantiles_within_bucket_error(dist):
    rng = np.random.default_rng(42)
    if dist == "uniform":
        values = rng.uniform(1e-4, 1e-1, 20000)
    elif dist == "exponential":
        values = rng.exponential(5e-3, 20000) + 1e-6
    else:
        values = np.concatenate([
            rng.normal(2e-4, 2e-5, 18000).clip(1e-5),
            rng.normal(5e-2, 5e-3, 2000).clip(1e-3),
        ])
    h = LatencyHistogram()
    for v in values:
        h.add(float(v))
    assert h.n == len(values)
    for q in (0.5, 0.9, 0.99):
        assert _quantile_err(values, h, q) < 0.10, (dist, q)
    assert h.max_s == pytest.approx(float(values.max()))
    p = h.percentiles()
    assert p["p50_ms"] <= p["p90_ms"] <= p["p99_ms"] <= p["max_ms"]


def test_histogram_buckets_and_range():
    assert bucket_index(0.0) == 0
    assert bucket_index(1e-9) == 0
    lo, hi = bucket_bounds(bucket_index(1e-3))
    assert lo <= 1e-3 < hi
    assert hi / lo <= 1.2
    h = LatencyHistogram()
    h.add(5000.0)  # beyond the top octave
    assert h.n == 1 and h.max_s == 5000.0
    assert h.quantile(0.5) > 1000.0


def test_histogram_merge_equals_union():
    rng = np.random.default_rng(7)
    a_vals = rng.exponential(1e-3, 5000)
    b_vals = rng.exponential(5e-2, 5000)
    a, b, u = LatencyHistogram(), LatencyHistogram(), LatencyHistogram()
    for v in a_vals:
        a.add(float(v))
        u.add(float(v))
    for v in b_vals:
        b.add(float(v))
        u.add(float(v))
    merged = LatencyHistogram()
    merged.merge(a).merge(b)
    assert merged.n == u.n
    assert merged.counts == u.counts
    assert merged.quantile(0.99) == u.quantile(0.99)
    assert merged.max_s == u.max_s


def test_histogram_dict_round_trip():
    h = LatencyHistogram()
    for v in (1e-5, 2e-4, 3e-3, 0.5):
        h.add(v)
    d = json.loads(json.dumps(h.to_dict()))
    r = LatencyHistogram.from_dict(d)
    assert r.counts == h.counts
    assert r.n == h.n and r.max_s == h.max_s
    assert LatencyHistogram.from_dict(None).n == 0


def test_histogram_add_many_equals_the_reference():
    from blendjax.obs.histogram import LatencyHistogram as JLatencyHistogram

    ours, ref = LatencyHistogram(), JLatencyHistogram()
    for seconds, k in ((3e-6, 4), (0.0, 2), (1e-2, 100), (5000.0, 1)):
        ours.add_many(seconds, k)
        ref.add_many(seconds, k)
    assert ours.to_dict() == ref.to_dict()
    assert ours.percentiles() == ref.percentiles()


# -- tests/test_obs.py: the timer -------------------------------------------------


def test_stagetimer_summary_has_percentiles():
    t = StageTimer()
    for ms in (1, 1, 2, 50):
        t.add("recv", ms / 1e3)
    s = t.summary()["recv"]
    assert s["count"] == 4
    for key in ("p50_ms", "p90_ms", "p99_ms", "max_ms"):
        assert key in s
    assert s["max_ms"] == pytest.approx(50.0, rel=1e-6)
    assert 0.8 <= s["p50_ms"] <= 2.2
    assert t.percentiles("never")["p99_ms"] == 0.0


def test_stagetimer_histograms_count_with_the_timer():
    """The port keeps every stage's histogram (the reference's
    ``histograms=False`` has no caller in the port), with its ``n`` and
    ``sum_s`` kept by the histogram itself."""
    t = StageTimer()
    for s in (0.01, 2e-4, 3e-3):
        t.add("recv", s)
    t.add_bulk("recv", 0.5, 4)
    h = t.snapshot()["recv"]["hist"]
    assert h.n == t.count("recv") == 7 and sum(h.counts) == 7
    assert h.sum_s == pytest.approx(t.total_s("recv"), rel=1e-12)
    assert h.max_s == 0.5 / 4
    assert t.snapshot_serialized()["recv"]["hist"] == h.to_dict()


def test_stagetimer_add_bulk_lands_at_mean():
    t = StageTimer()
    t.add_bulk("scatter", 1.0, 100)  # 100 intervals of 10 ms mean
    s = t.summary()["scatter"]
    assert s["count"] == 100
    assert 9.0 <= s["p50_ms"] <= 11.0
    t.add_bulk("scatter", 0.0, 0)  # no-op, no div-by-zero
    assert t.count("scatter") == 100


def test_trace_ring_bounded_with_drop_count(monkeypatch):
    assert StageTimer()._trace_cap == DEFAULT_TRACE_CAP == 65536
    monkeypatch.setattr(timing, "DEFAULT_TRACE_CAP", 64)
    t = StageTimer(trace=True)
    for i in range(200):
        t.add("x", 1e-6, _t0=float(i))
    assert t.trace_dropped == 200 - 64
    with t._lock:
        events = list(t._events)
    assert len(events) == 64
    assert events[0][1] == pytest.approx(200 - 64)  # the recent window survives
    t.reset()
    assert t.trace_dropped == 0


# -- across the packages -----------------------------------------------------------

#: one fixed call sequence: (method, name, args)
_CALLS = ([("add", "recv", (2e-4,)), ("add", "recv", (3e-3,)), ("add", "scatter", (4.5e-5,)),
           ("add_bulk", "scatter", (1.2e-3, 24)), ("add", "step", (0.0191,)),
           ("add", "recv", (0.0,)), ("add_bulk", "arena_wait", (0.0, 0)),
           ("add", "step", (2.5e3,)), ("add_bulk", "recycle", (7e-4, 3))]
          + [("add", "device_put", (1e-6 * (1 + (7 * i) % 97),)) for i in range(150)])


def _drive(timer):
    for method, name, args in _CALLS:
        getattr(timer, method)(name, *args)
    return timer


def _exported(timer, path):
    n = timer.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert n == len(events)
    return [(e["name"], e["dur"]) for e in events]


@pytest.mark.parametrize("cap", [DEFAULT_TRACE_CAP, 16, 3, 1])
def test_timer_equals_the_reference_on_one_call_sequence(tmp_path, monkeypatch, cap):
    monkeypatch.setattr(timing, "DEFAULT_TRACE_CAP", cap)
    ours = _drive(StageTimer(trace=True))
    ref = _drive(JStageTimer(trace=True, trace_cap=cap))
    assert ours.summary() == ref.summary()
    assert ours.snapshot_serialized() == ref.snapshot_serialized()
    for name in ("recv", "scatter", "step", "device_put", "recycle", "arena_wait", "never"):
        assert ours.percentiles(name) == ref.percentiles(name)
        assert ours.count(name) == ref.count(name)
        assert ours.total_s(name) == ref.total_s(name)
        assert ours.mean_ms(name) == ref.mean_ms(name)
    assert ours.trace_dropped == ref.trace_dropped
    assert _exported(ours, tmp_path / "t.json") == _exported(ref, tmp_path / "j.json")


@pytest.mark.parametrize("max_items,batch_size,num_workers,shard,drop_last", [
    (64, 8, 2, (0, 1), True), (100, 8, 3, (1, 2), True), (100, 8, 3, (0, 2), False),
    (17, 4, 1, (0, 1), False)])
def test_loader_length_equals_the_reference(max_items, batch_size, num_workers, shard,
                                            drop_last):
    class Stub:
        pass

    ds = Stub()
    ds.max_items = max_items
    kw = dict(num_workers=num_workers, shard=shard, drop_last=drop_last)
    ours, ref = BatchLoader(ds, batch_size, **kw), JBatchLoader(ds, batch_size, **kw)
    assert len(ours) == len(ref)
    timer = StageTimer()
    assert BatchLoader(ds, batch_size, timer=timer, **kw).timer is timer


# -- the traced feed -----------------------------------------------------------------


def test_traced_stream_records_each_stage_on_its_own_thread(monkeypatch, tmp_path):
    from blendjax_torch import datagen
    from blendjax_torch.btt.dataset import RemoteIterableDataset
    from blendjax_torch.btt.launcher import BlenderLauncher
    from blendjax_torch.btt.prefetch import TorchStream
    from helpers import FAKE_BLENDER
    from test_torch_env import _free_block

    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    small = ["--height", "16", "--width", "24", "--keypoints", "2"]
    timer = StageTimer(trace=True)
    threads = {}
    with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=1,
                         named_sockets=["DATA"], start_port=_free_block(1), seed=0,
                         background=True, instance_args=[small]) as bl:
        ds = RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=32)
        with TorchStream(ds, batch_size=4, num_workers=1, device="cpu", timer=timer) as stream:
            assert stream.timer is timer and len(stream) == 8
            batches = 0
            for batch in stream:
                with timer.stage("step"):
                    assert tuple(batch["image"].shape) == (4, 16, 24, 3)
                    batches += 1
                threads.update({t.name: t.ident for t in threading.enumerate()})
            duty = stream.duty_cycle("step")
    assert batches == 8 and stream.arena_pool is not None
    n = timer.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert n == len(events)
    by_name = {}
    for e in events:
        assert e["ph"] == "X" and e["dur"] > 0 and 0 <= e["ts"] <= timer.wall_s * 1e6
        by_name.setdefault(e["name"], set()).add(e["tid"])
    for name in ("recv", "scatter", "device_put", "recycle", "step"):
        assert sum(e["name"] == name for e in events) == timer.count(name) > 0, name
    assert timer.trace_dropped == 0
    main, worker, feed = (threading.main_thread().ident, threads["bjx-loader-0"],
                          threads["bjx-prefetch"])
    assert by_name["step"] == {main}
    assert by_name["scatter"] == {worker}
    # the loader's consumer is the prefetch thread: its queue wait is ``recv``
    assert by_name["recv"] == by_name["device_put"] == by_name["recycle"] == {feed}
    steps = sum(e["dur"] for e in events if e["name"] == "step") * 1e-6
    assert steps == pytest.approx(timer.total_s("step"), rel=1e-9)
    # duty_cycle read during the run, over a shorter wall time than now
    assert steps / timer.wall_s <= duty <= 1

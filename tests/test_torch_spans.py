"""The port's span recorder and chrome-trace exports
(``blendjax_torch.obs.spans``) against the span cases of the reference's
``tests/test_obs.py``, on the CPU, and across the packages.

1. **The reference's cases** on the port: the bounded ring and its export,
   the merge of files, recorders and span lists sorted by time, a tracing
   pool over a producer that ignores span contexts, an untraced pool's
   requests carrying none, and the multi-process merge of a traced pool
   over two fake-Blender producers (``tests/blender/torch_env.blend.py``).
2. **Across the packages**: the same ``make_span`` inputs export to
   byte-equal files, each package's ``load_chrome_trace`` reads the other's
   file (the dict form and the bare-array form), and ``SpanRecorder.span``,
   ``drain`` and ``capacity`` behave as the reference's.
3. **A shared recorder**: a ``ShardClient(span_recorder=)`` given to
   ``ShardedReplay`` takes the recorder of a tracing ``EnvPool``, so one
   export holds both.
"""

import json
import threading

import pytest

from blendjax.obs import spans as jspans
from blendjax_torch import wire
from blendjax_torch.obs import export_chrome_trace, load_chrome_trace
from blendjax_torch.obs.spans import SpanRecorder, make_span, span_trace
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _free_block

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


# -- tests/test_obs.py ----------------------------------------------------------


def test_span_recorder_ring_and_export(tmp_path):
    rec = SpanRecorder(capacity=8)
    for i in range(12):
        rec.record(make_span(f"s{i}", 1000 + i, dur_us=5, trace=f"t{i}"))
    assert len(rec) == 8 and rec.dropped == 4
    path = tmp_path / "t.json"
    n = rec.export_chrome_trace(str(path))
    assert n == 8
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    assert span_trace(events[0]) == "t4"  # oldest survivors kept in order


def test_export_merges_files_and_recorders(tmp_path):
    a = SpanRecorder()
    a.record(make_span("a", 100, dur_us=1, pid=1))
    f1 = tmp_path / "one.json"
    a.export_chrome_trace(str(f1))
    b = SpanRecorder()
    b.record(make_span("b", 50, dur_us=1, pid=2))
    out = tmp_path / "merged.json"
    n = export_chrome_trace(str(out), b, str(f1), [make_span("c", 75, dur_us=1, pid=3)])
    assert n == 3
    events = json.loads(out.read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["b", "c", "a"]  # ts-sorted
    assert {e["pid"] for e in events} == {1, 2, 3}


def test_span_round_trip_and_multiprocess_merge(fake_blender, tmp_path):
    """A tracing pool over two producer processes yields one file with
    client and producer spans for the same correlation ids across >= 3
    pids, each producer span inside its client span's window."""
    from blendjax_torch.btt.envpool import launch_env_pool

    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                         horizon=1_000_000, timeoutms=30000, start_port=_free_block(2),
                         pipeline_depth=2, trace=True) as pool:
        pool.reset()
        for step in range(4):  # both RPC modes leave spans
            if step % 2 == 0:
                pool.step([1.0, 2.0])
            else:
                pool.step_async([3.0, 4.0])
                pool.step_wait()
        spans = pool.spans.snapshot()
        path = tmp_path / "merged.json"
        n = pool.spans.export_chrome_trace(str(path))
    assert n == len(spans) > 0
    pids = {s["pid"] for s in spans}
    assert len(pids) >= 3  # consumer + 2 producer processes
    by_trace = {}
    for s in spans:
        if span_trace(s) is not None:
            by_trace.setdefault(span_trace(s), []).append(s)
    paired = 0
    for group in by_trace.values():
        client = [s for s in group if s.get("cat") == "envpool"]
        producer = [s for s in group if s.get("cat") == "producer"]
        if not (client and producer):
            continue
        paired += 1
        c, p = client[0], producer[0]
        assert p["pid"] != c["pid"]
        assert p["ts"] >= c["ts"] - 2000
        assert p["ts"] + p["dur"] <= c["ts"] + c["dur"] + 2000
    assert paired >= 4
    doc = json.loads(path.read_text())
    assert {e["pid"] for e in doc["traceEvents"]} == pids
    assert all(wire.SPANS_KEY not in s.get("args", {}) for s in spans)


def test_tracing_pool_against_legacy_producer_stays_clean():
    """A producer that ignores the span context (no mid echo either)
    neither breaks the tracing pool nor leaks span keys into infos; the
    client-side span still lands."""
    import zmq

    from blendjax_torch.btt.envpool import EnvPool
    from helpers.producers import free_port

    addr = f"tcp://127.0.0.1:{free_port()}"
    stop = threading.Event()

    def legacy_server():
        ctx = zmq.Context.instance()
        rep = ctx.socket(zmq.REP)
        rep.setsockopt(zmq.LINGER, 0)
        rep.setsockopt(zmq.RCVTIMEO, 100)
        rep.bind(addr)
        t = 0
        try:
            while not stop.is_set():
                try:
                    req = wire.recv_message(rep)
                except zmq.Again:
                    continue
                t += 1
                obs = 0.0 if req["cmd"] == "reset" else req["action"]
                wire.send_message(rep, {"obs": obs, "reward": 0.0, "done": False, "time": t})
        finally:
            rep.close(0)

    thread = threading.Thread(target=legacy_server, daemon=True)
    thread.start()
    pool = EnvPool([addr], timeoutms=5000, trace=True)
    try:
        obs, infos = pool.reset()
        obs, rew, done, infos = pool.step([2.0])
        assert infos[0]["healthy"]
        assert wire.SPANS_KEY not in infos[0]
        assert wire.SPAN_KEY not in infos[0]
        spans = pool.spans.snapshot()
        assert [s["name"] for s in spans] == ["env_rpc", "env_rpc"]
        assert all(s.get("cat") == "envpool" for s in spans)
    finally:
        stop.set()
        pool.close()
        thread.join(timeout=3)
    assert not thread.is_alive()


def test_untraced_pool_requests_carry_no_span_context(fake_blender):
    from blendjax_torch.btt.envpool import launch_env_pool

    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=1, background=True,
                         horizon=1_000_000, timeoutms=30000,
                         start_port=_free_block(1)) as pool:
        pool.reset()
        obs, rew, done, infos = pool.step([1.0])
        assert pool.spans is None
        assert wire.SPANS_KEY not in infos[0]


# -- across the packages --------------------------------------------------------

_SPANS = [dict(name="env_rpc", t0_us=1_700_000_000_000_000 + 37 * i, dur_us=11 + i,
               trace=f"m{i % 5}", cat=("envpool", "producer", None)[i % 3],
               pid=100 + i % 3, tid=7 + i % 2, args={"shard": i} if i % 4 == 0 else None)
          for i in range(23)] + [dict(name="tie", t0_us=1_700_000_000_000_000, dur_us=1,
                                      pid=99, tid=1)]


def _span_kwargs(d):
    return {k: v for k, v in d.items() if k not in ("name", "t0_us")}


def test_exports_are_byte_equal_across_packages(tmp_path):
    ours, ref = SpanRecorder(capacity=16), jspans.SpanRecorder(capacity=16)
    extra = [make_span("extra", 5, dur_us=2, pid=3, tid=4)]
    for d in _SPANS:
        ours.record(make_span(d["name"], d["t0_us"], **_span_kwargs(d)))
        ref.record(jspans.make_span(d["name"], d["t0_us"], **_span_kwargs(d)))
    assert ours.snapshot() == ref.snapshot() and ours.dropped == ref.dropped == 8
    assert ours.export_chrome_trace(str(tmp_path / "t.json"), extra=(extra,)) == 17
    assert ref.export_chrome_trace(str(tmp_path / "j.json"), extra=(extra,)) == 17
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    # the module-level merge of both files, in either package
    export_chrome_trace(str(tmp_path / "tm.json"), str(tmp_path / "t.json"), ours)
    jspans.export_chrome_trace(str(tmp_path / "jm.json"), str(tmp_path / "j.json"), ref)
    assert (tmp_path / "tm.json").read_bytes() == (tmp_path / "jm.json").read_bytes()


@pytest.mark.parametrize("form", ["dict", "array"])
def test_each_package_loads_the_others_file(tmp_path, form):
    events = [make_span(d["name"], d["t0_us"], **_span_kwargs(d)) for d in _SPANS]
    for writer, reader in ((export_chrome_trace, jspans.load_chrome_trace),
                           (jspans.export_chrome_trace, load_chrome_trace)):
        path = tmp_path / "x.json"
        writer(str(path), events)
        if form == "array":
            path.write_text(json.dumps(json.loads(path.read_text())["traceEvents"]))
        got = reader(str(path))
        assert got == sorted(events, key=lambda e: (e["ts"], e["pid"]))
        assert got == (load_chrome_trace if reader is jspans.load_chrome_trace
                       else jspans.load_chrome_trace)(str(path))


def test_span_context_drain_and_capacity_equal_the_reference():
    for mod in (jspans, __import__("blendjax_torch.obs.spans", fromlist=["x"])):
        rec = mod.SpanRecorder(capacity=3)
        assert rec.capacity == 3
        with rec.span("work", trace="m1", cat="learner", args={"k": 2}):
            pass
        with pytest.raises(KeyError):
            with rec.span("fails", trace="m2"):
                raise KeyError("x")
        got = rec.drain()
        assert [s["name"] for s in got] == ["work", "fails"]
        assert got[0]["cat"] == "learner" and got[0]["args"] == {"k": 2, "trace": "m1"}
        assert got[0]["dur"] >= 0 and span_trace(got[1]) == "m2"
        assert len(rec) == 0 and rec.drain() == [] and rec.dropped == 0


# -- a recorder shared by the replay client and the pool --------------------------


def test_shard_client_shares_a_pool_recorder(fake_blender, tmp_path):
    import numpy as np

    from blendjax_torch.btt.envpool import launch_env_pool
    from blendjax_torch.replay.service import start_shard_thread
    from blendjax_torch.replay.shard_client import ShardClient, ShardedReplay
    from blendjax_torch.utils.timing import EventCounters

    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=1, background=True,
                         horizon=1_000_000, timeoutms=30000, start_port=_free_block(1),
                         trace=True) as pool, start_shard_thread(64) as handle:
        counters = EventCounters()
        client = ShardClient(handle.address, 0, counters=counters, span_recorder=pool.spans)
        buf = ShardedReplay([client], seed=3, counters=counters)
        try:
            assert client.spans is pool.spans and buf.spans is None
            pool.reset()
            obs, rew, *_ = pool.step([1.0])
            for i in range(4):
                buf.append({"obs": np.full(4, i, np.float32), "reward": np.float32(rew[0])})
            buf.sample(2)
        finally:
            buf.close()
        n = pool.spans.export_chrome_trace(str(tmp_path / "shared.json"))
    cats = {e.get("cat") for e in load_chrome_trace(str(tmp_path / "shared.json"))}
    assert n > 0 and {"envpool", "producer", "replay_client", "replay_shard"} <= cats

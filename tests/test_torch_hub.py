"""The port's telemetry hub (``blendjax_torch.obs.hub``), its histogram wire
form and its counter and stage vocabulary, against the reference's
``tests/test_obs.py``, on the CPU.

1. **The reference's cases** against the port: the scrape's zero fill over
   the port's tuples (JSON and Prometheus), histograms merged across
   components as the union's quantile, remote fetches and their errors,
   the ZMQ scrape socket, a failing probe, a replay shard's ``telemetry``
   RPC merged as a remote with its spans, a shard quarantine in the flight
   recorder, the weight vocabulary locked to ``docs/weight_bus.md``, and
   the gateway and autoscale vocabularies zero-filled in a scrape.
2. **Across the packages**: the port's ``to_prometheus`` renders a snapshot
   line for line as the reference's does (string equality), the port's
   counters and stages zero-filled under the reference's names, and
   ``LatencyHistogram.to_dict`` equal to the reference's for the same
   durations (dict equality), so a remote scrape merges in either hub.
"""

import json
import os
import re

import numpy as np

from blendjax.obs.histogram import LatencyHistogram as JLatencyHistogram
from blendjax.obs.hub import TelemetryHub as JTelemetryHub
from blendjax.utils import timing as jtiming
from blendjax_torch.obs.flight import flight_recorder
from blendjax_torch.obs.histogram import LatencyHistogram, fold_stage_snapshot, stage_records
from blendjax_torch.obs.hub import TelemetryHub, scrape_socket
from blendjax_torch.utils.timing import (
    AUTOSCALE_EVENTS,
    AUTOSCALE_STAGES,
    FEED_STAGES,
    FLEET_EVENTS,
    GATEWAY_EVENTS,
    GATEWAY_STAGES,
    HA_EVENTS,
    HA_STAGES,
    REPLAY_EVENTS,
    REPLAY_STAGES,
    SCENARIO_EVENTS,
    SCENARIO_STAGES,
    SERVE_EVENTS,
    SERVE_STAGES,
    WEIGHT_EVENTS,
    WEIGHT_STAGES,
    EventCounters,
    StageTimer,
)
from helpers import REPO_ROOT


def test_stagetimer_snapshot_copies_histograms():
    t = StageTimer()
    t.add("recv", 0.001)
    snap = t.snapshot()["recv"]
    assert snap["count"] == 1
    snap["hist"].add(100.0)  # mutating the copy...
    assert t.summary()["recv"]["max_ms"] < 1e4  # ...never touches the live one


def test_scrape_zero_fill_contract():
    hub = TelemetryHub()
    hub.register("fresh", counters=EventCounters(), timer=StageTimer())
    snap = hub.scrape()
    for name in FLEET_EVENTS + REPLAY_EVENTS + SERVE_EVENTS + WEIGHT_EVENTS + HA_EVENTS:
        assert snap["counters"][name] == 0, name
    for stage in FEED_STAGES + REPLAY_STAGES + SERVE_STAGES + WEIGHT_STAGES + HA_STAGES:
        rec = snap["stages"][stage]
        assert rec["count"] == 0, stage
        assert rec["p99_ms"] == 0.0
    prom = hub.to_prometheus(snap)
    assert 'blendjax_events_total{event="quarantines"} 0' in prom
    assert 'blendjax_events_total{event="serve_cache_hits"} 0' in prom
    assert 'blendjax_events_total{event="weight_adopted"} 0' in prom
    assert 'blendjax_events_total{event="ha_ckpt_saves"} 0' in prom
    for stage in ("weight_swap", "shard_gather", "queue_wait", "ha_snapshot"):
        assert (f'blendjax_stage_latency_seconds{{stage="{stage}",'
                'quantile="0.99"} 0') in prom


def test_hub_merges_histograms_across_components():
    hub = TelemetryHub()
    fast, slow = StageTimer(), StageTimer()
    for _ in range(990):
        fast.add("recv", 1e-4)
    for _ in range(10):
        slow.add("recv", 1e-1)
    hub.register("fleet0", timer=fast)
    hub.register("fleet1", timer=slow)
    rec = hub.scrape()["stages"]["recv"]
    assert rec["count"] == 1000
    assert rec["p50_ms"] < 1.0
    assert rec["p99_ms"] > 50.0  # the slow mode, not the mean
    a, b = EventCounters(), EventCounters()
    a.incr("retries", 2)
    b.incr("retries", 3)
    hub.register("ca", counters=a)
    hub.register("cb", counters=b)
    assert hub.scrape()["counters"]["retries"] == 5


def test_hub_remote_fetch_and_errors():
    remote_timer = StageTimer()
    remote_timer.add("shard_gather", 0.002)

    def fetch():
        return {"counters": {"replay_shard_quarantined": 1},
                "stages": remote_timer.snapshot_serialized()}

    def dead():
        raise TimeoutError("shard 1 is dead")

    hub = TelemetryHub()
    hub.register_remote("shard0", fetch)
    hub.register_remote("shard1", dead)
    snap = hub.scrape()
    assert snap["counters"]["replay_shard_quarantined"] == 1
    assert snap["stages"]["shard_gather"]["count"] == 1
    assert snap["stages"]["shard_gather"]["p50_ms"] > 0
    assert "shard 1 is dead" in snap["remote_errors"]["shard1"]
    assert "shard0" in snap["components"]


def test_hub_zmq_scrape_socket():
    import zmq

    hub = TelemetryHub("socktest")
    counters = EventCounters()
    counters.incr("quarantines")
    hub.register("c", counters=counters)
    try:
        addr = hub.serve()
        snap = scrape_socket(addr, "json")
        assert snap["hub"] == "socktest"
        assert snap["counters"]["quarantines"] == 1
        prom = scrape_socket(addr, "prometheus")
        assert 'blendjax_events_total{event="quarantines"} 1' in prom
        s = zmq.Context.instance().socket(zmq.REQ)
        s.setsockopt(zmq.LINGER, 0)
        s.connect(addr)
        try:
            s.send(b"\x00garbage")  # a malformed request still gets a JSON scrape
            assert s.poll(2000, zmq.POLLIN)
            assert json.loads(s.recv())["hub"] == "socktest"
        finally:
            s.close(0)
    finally:
        hub.close()


def test_hub_probe_failure_survives_scrape():
    hub = TelemetryHub()
    hub.register("bad", probe=lambda: 1 / 0)
    snap = hub.scrape()
    assert "ZeroDivisionError" in snap["components"]["bad"]["probe_error"]


def test_shard_telemetry_rpc_and_hub_merge():
    from blendjax_torch.replay.service import start_shard_thread
    from blendjax_torch.replay.shard_client import ShardedReplay

    with start_shard_thread(64, shard_id=0) as handle:
        buf = ShardedReplay([handle.address], seed=3, counters=EventCounters(), trace=True)
        try:
            for i in range(8):
                buf.append({"obs": np.full(4, i, np.float32), "reward": np.float32(i)})
            buf.sample(4)
            spans = buf.spans.snapshot()
            cats = {s.get("cat") for s in spans}
            assert "replay_client" in cats and "replay_shard" in cats
            shard_names = {s["name"] for s in spans if s.get("cat") == "replay_shard"}
            assert "shard0:append" in shard_names and "shard0:gather" in shard_names
            tel = buf.shard_telemetry(0)
            assert tel["shard_id"] == 0
            assert tel["stages"]["shard_srv_append"]["count"] == 8
            assert tel["stages"]["shard_srv_append"]["hist"]["n"] == 8
            hub = TelemetryHub()
            buf.register_with_hub(hub)
            snap = hub.scrape()
            assert snap["stages"]["shard_srv_append"]["count"] == 8
            assert snap["stages"]["shard_srv_append"]["p99_ms"] > 0
            assert snap["stages"]["shard_append"]["count"] == 8
        finally:
            buf.close()


def test_shard_quarantine_lands_in_flight_recorder():
    from blendjax_torch.replay.service import start_shard_thread
    from blendjax_torch.replay.shard_client import ShardedReplay

    with start_shard_thread(32, shard_id=0) as handle:
        buf = ShardedReplay([handle.address], counters=EventCounters())
        try:
            buf.quarantine_shard(0, reason="test quarantine xyz")
            ours = [e for e in flight_recorder.snapshot()
                    if e["event"] == "replay_shard_quarantined"
                    and e["details"].get("reason") == "test quarantine xyz"]
            assert ours and ours[-1]["target"] == "shard0"
        finally:
            buf.close()


def _doc_table_names(path, heading):
    """Backticked names from the first column of the markdown table under
    ``heading``."""
    text = open(path).read()
    section = text.split(heading, 1)[1]
    section = re.split(r"\n#{1,6} ", section, 1)[0]
    names = []
    for line in section.splitlines():
        if not line.startswith("|") or line.startswith("|---"):
            continue
        names.extend(re.findall(r"`([a-z0-9_]+)`", line.split("|")[1]))
    return names


def test_scenario_vocabulary_zero_filled_in_a_scrape():
    """Every scenario counter and stage is in a scrape from a hub whose
    components never counted one, at zero, in JSON and in Prometheus."""
    hub = TelemetryHub()
    hub.register("fresh", counters=EventCounters(), timer=StageTimer())
    snap = hub.scrape()
    for name in SCENARIO_EVENTS:
        assert snap["counters"][name] == 0, name
    for stage in SCENARIO_STAGES:
        assert snap["stages"][stage]["count"] == 0, stage
    prom = hub.to_prometheus(snap)
    for name in SCENARIO_EVENTS:
        assert f'blendjax_events_total{{event="{name}"}} 0' in prom, name
    for stage in SCENARIO_STAGES:
        assert (f'blendjax_stage_latency_seconds{{stage="{stage}",'
                'quantile="0.99"} 0') in prom, stage


def test_scenario_plane_counts_merge_in_both_hubs():
    """A randomizer's and a curriculum's counts and stages, registered with
    the port's hub, scrape to what the reference's hub reports for them."""
    from blendjax_torch.scenario import CurriculumScheduler

    counters, timer = EventCounters(), StageTimer()
    cur = CurriculumScheduler(["a", "b"], counters=counters, timer=timer)
    cur.pin({"a": 0.25, "b": 0.75})
    cur.update()
    counters.incr("scenario_pushes", 3)
    counters.incr("scenario_push_failures")
    port, ref = TelemetryHub(), JTelemetryHub()
    port.register("scenario_curriculum", counters=counters, timer=timer, probe=cur.stats)
    ref.register_remote("scenario_curriculum", lambda: {
        "counters": counters.snapshot(), "stages": timer.snapshot_serialized()})
    snap, ref_snap = port.scrape(), ref.scrape()
    for name in SCENARIO_EVENTS:
        assert snap["counters"][name] == ref_snap["counters"][name], name
    assert snap["counters"]["scenario_mix_changes"] == 1
    assert snap["counters"]["scenario_pushes"] == 3
    for stage in SCENARIO_STAGES:
        assert snap["stages"][stage] == ref_snap["stages"][stage], stage
    assert snap["stages"]["scenario_reweight"]["count"] == 1
    assert snap["components"]["scenario_curriculum"]["probe"]["policy"] == "pinned"


def test_gateway_and_autoscale_vocabularies_zero_filled_in_a_scrape():
    """Every gateway and autoscale counter and stage is in a scrape from a
    hub whose components never counted one, at zero, in JSON and in
    Prometheus, in the reference's order among the canonical names."""
    from blendjax_torch.obs import hub as port_hub

    hub = TelemetryHub()
    hub.register("fresh", counters=EventCounters(), timer=StageTimer())
    snap = hub.scrape()
    prom = hub.to_prometheus(snap)
    for name in GATEWAY_EVENTS + AUTOSCALE_EVENTS:
        assert snap["counters"][name] == 0, name
        assert f'blendjax_events_total{{event="{name}"}} 0' in prom, name
    for stage in GATEWAY_STAGES + AUTOSCALE_STAGES:
        assert snap["stages"][stage]["count"] == 0, stage
        assert (f'blendjax_stage_latency_seconds{{stage="{stage}",'
                'quantile="0.99"} 0') in prom, stage
    # the reference's canonical order, its pipeline vocabulary included
    ref_counters = list(jtiming.FLEET_EVENTS + jtiming.REPLAY_EVENTS
                        + jtiming.SERVE_EVENTS + jtiming.GATEWAY_EVENTS
                        + jtiming.WEIGHT_EVENTS + jtiming.SCENARIO_EVENTS
                        + jtiming.HA_EVENTS + jtiming.AUTOSCALE_EVENTS
                        + jtiming.PIPE_EVENTS)
    ref_stages = list(jtiming.FEED_STAGES + jtiming.REPLAY_STAGES
                      + jtiming.SERVE_STAGES + jtiming.GATEWAY_STAGES
                      + jtiming.WEIGHT_STAGES + jtiming.SCENARIO_STAGES
                      + jtiming.HA_STAGES + jtiming.AUTOSCALE_STAGES
                      + jtiming.PIPE_STAGES)
    assert list(port_hub._canonical_counters()) == ref_counters
    assert list(port_hub._canonical_stages()) == ref_stages


def test_documented_scenario_counters_and_stages_exist_in_tuples():
    path = os.path.join(REPO_ROOT, "docs", "scenarios.md")
    for heading, vocab in (("## Counter vocabulary", SCENARIO_EVENTS),
                           ("## Stage vocabulary", SCENARIO_STAGES)):
        names = _doc_table_names(path, heading)
        assert sorted(names) == sorted(vocab), heading


def test_documented_weight_counters_exist_in_tuples():
    names = _doc_table_names(os.path.join(REPO_ROOT, "docs", "weight_bus.md"),
                             "## Counter vocabulary")
    vocab = set(WEIGHT_EVENTS)
    assert not [n for n in names if n not in vocab]
    assert not [n for n in vocab if n not in set(names)]


def test_documented_weight_stages_exist_in_tuples():
    names = _doc_table_names(os.path.join(REPO_ROOT, "docs", "weight_bus.md"),
                             "## Stage vocabulary")
    vocab = set(WEIGHT_STAGES)
    assert not [n for n in names if n not in vocab]
    assert not [n for n in vocab if n not in set(names)]


# -- across the packages -----------------------------------------------------------


def test_tuples_are_the_references():
    for name in ("FEED_STAGES", "FLEET_EVENTS", "REPLAY_EVENTS", "REPLAY_STAGES",
                 "WEIGHT_EVENTS", "WEIGHT_STAGES", "SERVE_EVENTS", "SERVE_STAGES",
                 "HA_EVENTS", "HA_STAGES", "SCENARIO_EVENTS", "SCENARIO_STAGES",
                 "GATEWAY_EVENTS", "GATEWAY_STAGES", "AUTOSCALE_EVENTS",
                 "AUTOSCALE_STAGES", "PIPE_EVENTS", "PIPE_STAGES"):
        from blendjax_torch.utils import timing

        assert getattr(timing, name) == getattr(jtiming, name), name


def test_histogram_wire_form_equals_the_reference():
    rng = np.random.default_rng(0)
    durations = np.concatenate([rng.exponential(1e-3, 500), rng.exponential(0.2, 20),
                                [0.0, 5e-7, 3000.0]])
    a, b = LatencyHistogram(), JLatencyHistogram()
    for d in durations:
        a.add(float(d))
        b.add(float(d))
    assert a.to_dict() == b.to_dict()
    assert a.percentiles() == b.percentiles()
    merged = LatencyHistogram.from_dict(b.to_dict()).merge(LatencyHistogram.from_dict(a.to_dict()))
    ref = JLatencyHistogram.from_dict(b.to_dict()).merge(JLatencyHistogram.from_dict(a.to_dict()))
    assert merged.to_dict() == ref.to_dict()
    recs = stage_records(fold_stage_snapshot({}, {"x": {"count": 3, "total_s": 0.5,
                                                        "hist": a.to_dict()}}))
    assert recs["x"]["count"] == 3 and recs["x"]["p99_ms"] == a.percentiles()["p99_ms"]


def test_prometheus_text_equals_the_reference():
    """The same counters and stages, scraped by the port's hub, render line
    for line as the reference's hub renders that snapshot; the reference's
    hub merging the port's counters and timers zero-fills the same names to
    the same values."""
    counters = EventCounters()
    for name, n in (("replay_appends", 40), ("weight_adopted", 3), ("deaths", 1),
                    ("serve_requests", 17), ("ha_ckpt_saves", 2)):
        counters.incr(name, n)
    timer = StageTimer()
    rng = np.random.default_rng(1)
    for stage in ("shard_append", "weight_swap", "queue_wait"):
        for d in rng.exponential(2e-3, 50):
            timer.add(stage, float(d))
    port, ref = TelemetryHub(), JTelemetryHub()
    port.register("c", counters=counters, timer=timer)
    # across processes a hub merges the other package's telemetry as a remote
    ref.register_remote("c", lambda: {"counters": counters.snapshot(),
                                      "stages": timer.snapshot_serialized()})
    snap = port.scrape()
    assert port.to_prometheus(snap) == ref.to_prometheus(snap)
    ref_snap = ref.scrape()
    for name, value in snap["counters"].items():
        assert ref_snap["counters"][name] == value, name
    for stage, rec in snap["stages"].items():
        assert ref_snap["stages"][stage] == rec, stage


def test_unregister_drops_components_and_remotes():
    """``TelemetryHub.unregister`` removes a component's and a remote's
    contributions from the next scrape (an unknown name is a no-op), as the
    reference's."""
    snaps = {}
    for label, hub_cls in (("port", TelemetryHub), ("ref", JTelemetryHub)):
        hub = hub_cls()
        counters = EventCounters()
        counters.incr("retries", 3)
        hub.register("fleet0", counters=counters)
        hub.register_remote("shard0", lambda: {"counters": {"retries": 2}, "stages": {}})
        before = hub.scrape()["counters"]["retries"]
        hub.unregister("shard0")
        after_remote = hub.scrape()
        hub.unregister("fleet0")
        hub.unregister("never")
        after = hub.scrape()
        snaps[label] = (before, after_remote["counters"]["retries"],
                        sorted(after_remote["components"]), after["counters"]["retries"],
                        sorted(after["components"]))
    assert snaps["port"] == snaps["ref"] == (5, 3, ["fleet0"], 0, [])


def test_flight_recorder_ring_and_dump(tmp_path):
    from blendjax_torch.obs.flight import FlightRecorder

    fr = FlightRecorder(capacity=4)
    for i in range(7):
        fr.note("retry", target=f"env{i}", attempt=i)
    assert len(fr) == 4 and fr.dropped == 3
    path = fr.dump(str(tmp_path / "pm.json"), reason="unit", extra={"target": "env6"})
    doc = json.loads(open(path).read())
    assert doc["format"] == "blendjax.postmortem/1"
    assert doc["reason"] == "unit"
    assert doc["events_dropped"] == 3
    assert [e["target"] for e in doc["events"]] == ["env3", "env4", "env5", "env6"]
    assert all(re.fullmatch(r"[0-9a-f]{12}", e["digest"]) for e in doc["events"])
    assert doc["extra"]["target"] == "env6"


def test_flight_dump_default_dir_env(tmp_path, monkeypatch):
    from blendjax_torch.obs import default_postmortem_dir
    from blendjax_torch.obs.flight import FlightRecorder

    fr = FlightRecorder()
    fr.note("quarantine", target="env0")
    monkeypatch.delenv("BJX_POSTMORTEM_DIR", raising=False)
    assert default_postmortem_dir() is None
    assert fr.dump(reason="nowhere") is None  # skipped, not scattered into cwd
    monkeypatch.setenv("BJX_POSTMORTEM_DIR", str(tmp_path))
    path = fr.dump(reason="via env!")
    assert path is not None and path.startswith(str(tmp_path))
    assert "via-env" in os.path.basename(path)

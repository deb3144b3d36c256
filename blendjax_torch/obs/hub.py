"""TelemetryHub: one scrapeable aggregation point for the whole plane, the
port of ``blendjax.obs.hub``.

Counters (:class:`~blendjax_torch.utils.timing.EventCounters`), stage timers
with latency histograms (:class:`~blendjax_torch.utils.timing.StageTimer`)
and health probes live per component: per fleet, per pool, per replay
buffer, per shard process, per policy server.  The hub merges them on
demand into one snapshot:

- :meth:`TelemetryHub.scrape` — a JSON-able dict with every canonical
  counter (``FLEET_EVENTS`` + ``REPLAY_EVENTS`` + ``SERVE_EVENTS`` +
  ``GATEWAY_EVENTS`` + ``WEIGHT_EVENTS`` + ``SCENARIO_EVENTS`` +
  ``HA_EVENTS`` + ``AUTOSCALE_EVENTS``) and every canonical stage
  (``FEED_STAGES`` + ``REPLAY_STAGES`` + ``SERVE_STAGES`` +
  ``GATEWAY_STAGES`` + ``WEIGHT_STAGES`` + ``SCENARIO_STAGES`` +
  ``HA_STAGES`` + ``AUTOSCALE_STAGES``) zero-filled, in the reference's
  order,
  histograms merged across components so the aggregate p99 is a quantile
  of the union;
- :meth:`TelemetryHub.to_prometheus` — the same snapshot in Prometheus
  text-exposition format (counters and latency summaries), line for line
  the reference's;
- :meth:`TelemetryHub.serve` — an optional ZMQ REP scrape socket speaking
  plain JSON (request ``{"format": "json"|"prometheus"}``, reply bytes);
- :meth:`TelemetryHub.register_remote` — pull telemetry from another
  process (a replay shard's ``telemetry`` RPC) and merge it like a local
  component; a fetch failure lands in ``remote_errors``, never raised.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from blendjax_torch.obs.histogram import fold_stage_snapshot, stage_records

logger = logging.getLogger("blendjax_torch")

#: Prometheus metric-name prefix for everything the hub exports.
PROM_PREFIX = "blendjax"


def _canonical_counters():
    from blendjax_torch.utils import timing

    return (timing.FLEET_EVENTS + timing.REPLAY_EVENTS
            + timing.SERVE_EVENTS + timing.GATEWAY_EVENTS
            + timing.WEIGHT_EVENTS + timing.SCENARIO_EVENTS
            + timing.HA_EVENTS + timing.AUTOSCALE_EVENTS
            + timing.PIPE_EVENTS)


def _canonical_stages():
    from blendjax_torch.utils import timing

    return (timing.FEED_STAGES + timing.REPLAY_STAGES
            + timing.SERVE_STAGES + timing.GATEWAY_STAGES
            + timing.WEIGHT_STAGES + timing.SCENARIO_STAGES
            + timing.HA_STAGES + timing.AUTOSCALE_STAGES
            + timing.PIPE_STAGES)


def _zero_stage():
    return {
        "count": 0, "total_s": 0.0, "mean_ms": 0.0,
        "p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0,
    }


class _Component:
    __slots__ = ("counters", "timer", "probe")

    def __init__(self, counters, timer, probe):
        self.counters = counters
        self.timer = timer
        self.probe = probe


class TelemetryHub:
    """Merge-and-serve aggregator over registered telemetry sources."""

    def __init__(self, name="blendjax"):
        self.name = name
        self._lock = threading.Lock()
        self._components = {}
        self._remotes = {}
        self._serve_thread = None
        self._serve_stop = None
        self.address = None

    # -- registration --------------------------------------------------------

    def register(self, name, *, counters=None, timer=None, probe=None):
        """Attach a local component's telemetry sources under ``name``.

        ``counters``/``timer`` merge into the aggregate; ``probe`` is an
        optional zero-arg callable (e.g. ``supervisor.health``) whose
        result rides in the component's snapshot verbatim.  Re-register
        under the same name to replace (component restarts)."""
        with self._lock:
            self._components[str(name)] = _Component(counters, timer, probe)
        return self

    def register_supervisor(self, name, supervisor):
        """Convenience: a :class:`~blendjax_torch.btt.supervise.FleetSupervisor`
        contributes its counters, its stage timer (when it has one) and
        its ``health()`` snapshot."""
        return self.register(
            name,
            counters=supervisor.counters,
            timer=getattr(supervisor, "timer", None),
            probe=supervisor.health,
        )

    def register_remote(self, name, fetch):
        """Attach a remote process's telemetry: ``fetch()`` returns a
        dict shaped like :meth:`StageTimer.snapshot` output wrapped as
        ``{"counters": {...}, "stages": {...}}`` (the replay shard
        ``telemetry`` RPC reply).  Fetched per scrape; failures land in
        the snapshot's ``remote_errors`` instead of failing it."""
        with self._lock:
            self._remotes[str(name)] = fetch
        return self

    def unregister(self, name):
        """Drop the component or remote registered under ``name`` (a no-op
        for an unknown name)."""
        with self._lock:
            self._components.pop(str(name), None)
            self._remotes.pop(str(name), None)

    # -- aggregation ---------------------------------------------------------

    def scrape(self):
        """One merged snapshot (see module docstring for the zero-fill
        contract)."""
        with self._lock:
            components = dict(self._components)
            remotes = dict(self._remotes)
        counters = dict.fromkeys(_canonical_counters(), 0)
        merged = {}  # the fold_stage_snapshot accumulator
        comp_out = {}
        remote_errors = {}

        def fold_counters(snap):
            for k, v in (snap or {}).items():
                counters[k] = counters.get(k, 0) + int(v)

        for name, comp in components.items():
            detail = {}
            if comp.counters is not None:
                snap = comp.counters.snapshot()
                detail["counters"] = snap
                fold_counters(snap)
            if comp.timer is not None:
                # one snapshot serves both the aggregate fold and the
                # per-component records (no second lock acquisition /
                # quantile recomputation via summary())
                stages_snap = comp.timer.snapshot()
                fold_stage_snapshot(merged, stages_snap)
                detail["stages"] = stage_records(
                    fold_stage_snapshot({}, stages_snap)
                )
            if comp.probe is not None:
                try:
                    detail["probe"] = comp.probe()
                except Exception as exc:  # noqa: BLE001 - scrape survives
                    detail["probe_error"] = f"{type(exc).__name__}: {exc}"
            comp_out[name] = detail
        for name, fetch in remotes.items():
            try:
                snap = fetch()
            except Exception as exc:  # noqa: BLE001 - scrape survives
                remote_errors[name] = f"{type(exc).__name__}: {exc}"
                continue
            fold_counters(snap.get("counters"))
            fold_stage_snapshot(merged, snap.get("stages"))
            comp_out[name] = {
                k: v for k, v in snap.items() if k not in ("stages",)
            }
        stages = {}
        for stage in _canonical_stages():
            stages[stage] = _zero_stage()
        stages.update(stage_records(merged))
        out = {
            "hub": self.name,
            "ts": time.time(),
            "pid": os.getpid(),
            "counters": counters,
            "stages": stages,
            "components": comp_out,
        }
        if remote_errors:
            out["remote_errors"] = remote_errors
        return out

    # -- prometheus ----------------------------------------------------------

    def to_prometheus(self, snapshot=None):
        """The scrape in Prometheus text-exposition format (0.0.4):
        counters as ``<prefix>_events_total`` and stage latencies as
        quantile summaries."""
        snap = snapshot or self.scrape()
        lines = [
            f"# HELP {PROM_PREFIX}_events_total "
            "Fleet/replay fault and lifecycle event counts.",
            f"# TYPE {PROM_PREFIX}_events_total counter",
        ]
        for event in sorted(snap["counters"]):
            lines.append(
                f'{PROM_PREFIX}_events_total{{event="{event}"}} '
                f'{int(snap["counters"][event])}'
            )
        metric = f"{PROM_PREFIX}_stage_latency_seconds"
        lines += [
            f"# HELP {metric} Per-stage latency quantiles.",
            f"# TYPE {metric} summary",
        ]
        for stage in sorted(snap["stages"]):
            rec = snap["stages"][stage]
            for q, key in (("0.5", "p50_ms"), ("0.9", "p90_ms"),
                           ("0.99", "p99_ms")):
                lines.append(
                    f'{metric}{{stage="{stage}",quantile="{q}"}} '
                    f'{rec[key] / 1e3:.9g}'
                )
            lines.append(
                f'{metric}_sum{{stage="{stage}"}} {rec["total_s"]:.9g}'
            )
            lines.append(
                f'{metric}_count{{stage="{stage}"}} {int(rec["count"])}'
            )
        lines += [
            f"# HELP {metric}_max Per-stage maximum observed latency.",
            f"# TYPE {metric}_max gauge",
        ]
        for stage in sorted(snap["stages"]):
            lines.append(
                f'{metric}_max{{stage="{stage}"}} '
                f'{snap["stages"][stage]["max_ms"] / 1e3:.9g}'
            )
        return "\n".join(lines) + "\n"

    # -- ZMQ scrape socket ---------------------------------------------------

    def serve(self, address="tcp://127.0.0.1:*"):
        """Serve scrapes on a ZMQ REP socket from a daemon thread — the
        no-HTTP-dependency exposition transport.  Protocol: the request
        is JSON bytes (``{}`` or ``{"format": "json"|"prometheus"}``;
        malformed/empty requests default to JSON), the reply is UTF-8
        JSON or Prometheus text bytes.  Returns the bound address
        (``:*`` binds an ephemeral port).  One server per hub."""
        import zmq

        if self._serve_thread is not None:
            raise RuntimeError("hub scrape socket already serving")
        ctx = zmq.Context.instance()
        sock = ctx.socket(zmq.REP)
        sock.setsockopt(zmq.LINGER, 0)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = sock.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            sock.bind(address)
            self.address = address
        stop = threading.Event()

        def loop():
            try:
                while not stop.is_set():
                    if not sock.poll(100, zmq.POLLIN):
                        continue
                    raw = sock.recv()
                    fmt = "json"
                    try:
                        req = json.loads(raw) if raw else {}
                        if isinstance(req, dict):
                            fmt = req.get("format", "json")
                    except ValueError:
                        pass
                    try:
                        if fmt == "prometheus":
                            body = self.to_prometheus().encode()
                        else:
                            body = json.dumps(
                                self.scrape(), default=repr
                            ).encode()
                    except Exception as exc:  # noqa: BLE001
                        logger.exception("hub scrape failed")
                        body = json.dumps(
                            {"error": f"{type(exc).__name__}: {exc}"}
                        ).encode()
                    sock.send(body)
            except zmq.ZMQError:
                pass  # socket closed under us: clean shutdown
            finally:
                sock.close(0)

        self._serve_stop = stop
        self._serve_thread = threading.Thread(
            target=loop, daemon=True, name="bjx-telemetry-hub"
        )
        self._serve_thread.start()
        return self.address

    def close(self):
        if self._serve_thread is not None:
            self._serve_stop.set()
            self._serve_thread.join(timeout=5)
            self._serve_thread = None
            self._serve_stop = None
            self.address = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def scrape_socket(address, fmt="json", timeout_ms=2000):
    """One scrape from a hub's REP socket (see :meth:`TelemetryHub.serve`).
    Returns the parsed dict for ``fmt="json"`` and the exposition text
    for ``fmt="prometheus"``; raises TimeoutError when nothing answers."""
    import zmq

    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.REQ)
    sock.setsockopt(zmq.LINGER, 0)
    try:
        sock.connect(address)
        sock.send(json.dumps({"format": fmt}).encode())
        if not sock.poll(timeout_ms, zmq.POLLIN):
            raise TimeoutError(
                f"no scrape reply from {address} within {timeout_ms} ms"
            )
        body = sock.recv()
        if fmt == "prometheus":
            return body.decode()
        return json.loads(body)
    finally:
        sock.close(0)

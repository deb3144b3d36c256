"""blendjax_torch.obs — telemetry building blocks: latency histograms,
cross-process trace spans, profiler region ranges, the flight recorder
and the telemetry hub.

Import-light (PEP 562 lazy attributes): producers inside Blender's
embedded Python import ``blendjax_torch.obs.spans`` alone.
"""

_EXPORTS = {
    "LatencyHistogram": ("blendjax_torch.obs.histogram", "LatencyHistogram"),
    "SpanRecorder": ("blendjax_torch.obs.spans", "SpanRecorder"),
    "make_span": ("blendjax_torch.obs.spans", "make_span"),
    "now_us": ("blendjax_torch.obs.spans", "now_us"),
    "span_trace": ("blendjax_torch.obs.spans", "span_trace"),
    "export_chrome_trace": ("blendjax_torch.obs.spans", "export_chrome_trace"),
    "load_chrome_trace": ("blendjax_torch.obs.spans", "load_chrome_trace"),
    "TelemetryHub": ("blendjax_torch.obs.hub", "TelemetryHub"),
    "scrape_socket": ("blendjax_torch.obs.hub", "scrape_socket"),
    "FlightRecorder": ("blendjax_torch.obs.flight", "FlightRecorder"),
    "flight_recorder": ("blendjax_torch.obs.flight", "flight_recorder"),
    "default_postmortem_dir": ("blendjax_torch.obs.flight", "default_postmortem_dir"),
}


def __getattr__(name):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'blendjax_torch.obs' has no attribute {name!r}"
        ) from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))

"""The one traffic generator: reads a mix's parameters
(``traffic/<name>.json``) and feeds the program's step from the source the
mix names, ``portbench/sources/<source>.py`` (its ``Feed``).

A feed is an iterator of device batches with ``reference_batches(n)``
(the first ``n`` batches as host arrays, for the reference) and
``close()``.
"""

from __future__ import annotations

from portbench.harness.spec import HERE, load_module


def make_feed(torch, traffic, cfg, seed, device):
    path = HERE / "sources" / f"{traffic['source']}.py"
    if not path.exists():
        raise SystemExit(f"portbench: unknown traffic source {traffic['source']!r}")
    mod = load_module(path, f"portbench_source_{traffic['source']}")
    return mod.Feed(torch, traffic, cfg, seed, device)

"""The benchmark's harness: general code, driven by ``BENCHMARK.json`` and
the files it names."""

"""The benchmark of ``blendjax_torch`` on an NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json`` once."""

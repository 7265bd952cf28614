"""The port's benchmark: cells of ``BENCHMARK.json`` run through
``perfbench/run.py``.  See ``perfbench/README.md``."""

"""One reader per metric, found by the metric's name in BENCHMARK.json.

Each module has `read(run) -> float | None` (run: benchmark.run.Run).  A
reader that finds nothing to read returns None, and the metric is left out
of the run's result line.
"""

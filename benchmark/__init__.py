"""The benchmark of golfaction_tpu_torch: `python3 -m benchmark.run` runs one cell (BENCHMARK.json)."""

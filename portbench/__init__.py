"""The port's benchmark: one cell of BENCHMARK.json, one run (see README.md)."""

"""The port's benchmark: cells, configurations, traffic and metrics as
files, read by name from ``BENCHMARK.json`` (see README.md)."""

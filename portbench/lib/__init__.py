"""The harness's arithmetic: weights from a seed, timing, the profiler's
trace, operation and byte counts, the card's peaks."""

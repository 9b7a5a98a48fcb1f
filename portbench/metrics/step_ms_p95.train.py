"""The 95th percentile of the milliseconds between CUDA events recorded on
the stream at the window's step boundaries, read after the window."""

from portbench.lib.timing import p95
from portbench.metrics._lib import of_job


def read(record):
    return p95(record.get("gaps_ms", [])) if of_job(record, "train") else None

"""Host milliseconds per training step inside the program's step call,
without a sync: the mean over the window's steps (host clock)."""

from portbench.metrics._lib import mean_ms, of_job


def read(record):
    return mean_ms(record.get("host_unit_s", [])) if of_job(
        record, "train") else None

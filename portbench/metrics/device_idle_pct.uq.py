"""The share of the traced sub-window of propagation in which no device
operation ran."""

from portbench.metrics._lib import idle_pct, of_job


def read(record):
    return idle_pct(record) if of_job(record, "propagate") else None

"""The least time of the traced propagation call's counted work over the
device's busy time in the traced sub-window."""

from portbench.metrics._lib import busy_roofline_pct, of_job


def read(record):
    return busy_roofline_pct(record) if of_job(record, "propagate") else None

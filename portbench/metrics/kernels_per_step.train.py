"""Device kernels per training step, in the traced sub-window."""

from portbench.metrics._lib import of_job, per_unit


def read(record):
    return per_unit(record, "kernels") if of_job(record, "train") else None

"""CUDA runtime calls per training step that block the host (stream,
device or event synchronise; blocking copies), in the traced sub-window."""

from portbench.metrics._lib import of_job, per_unit


def read(record):
    return per_unit(record, "syncs") if of_job(record, "train") else None

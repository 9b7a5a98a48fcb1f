"""The propagation's counted operations (encoder and reverse flow of
every chunk) over the window's seconds, as a share of the card's float32
peak."""

from portbench.metrics._lib import mfu_pct, of_job


def read(record):
    return mfu_pct(record) if of_job(record, "propagate") else None

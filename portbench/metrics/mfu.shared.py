"""The counted operations of every process's training steps over the
common window's seconds, as a share of the card's float32 peak."""

from portbench.metrics._lib import mfu_pct, of_job


def read(record):
    if not of_job(record, "train") or record.get("processes", 1) < 2:
        return None
    return mfu_pct(record)

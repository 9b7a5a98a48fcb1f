"""Host milliseconds per training step in the program's batch stream
(each ``next()`` of ``DeviceDataset.batches``), mean over the window."""

from portbench.metrics._lib import mean_ms, of_job


def read(record):
    return mean_ms(record.get("batch_s", [])) if of_job(
        record, "train") else None

"""Training samples completed per second by every process that shares the
card: their samples over the common window's seconds (host clock)."""


def read(record):
    if record.get("job") != "train" or record.get("processes", 1) < 2:
        return None
    return record["samples"] / record["window_s"]

"""Training samples completed per second: every sample of the window
over all of its seconds (host clock)."""


def read(record):
    if record.get("job") != "train":
        return None
    return record["samples"] / record["window_s"]

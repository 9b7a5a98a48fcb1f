"""Monte-Carlo input fields propagated per second, each with all of its
draws: every field of the window over all of its seconds (host clock)."""


def read(record):
    if record.get("job") != "propagate":
        return None
    return record["fields"] / record["window_s"]

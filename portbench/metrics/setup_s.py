"""Seconds from the process start to the opening of the window: imports,
the card, inputs, weights and warm-up (host clock)."""


def read(record):
    return record["setup_s"]

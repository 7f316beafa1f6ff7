"""Reads fetched in the measured window over the window's wall time."""


def read(record):
    w = record["window"]
    return w["reads"] / w["seconds"]

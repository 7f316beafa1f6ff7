"""Share of the traced pass, in %, in which no kernel or copy ran on the
card (the union of the profiler's device intervals)."""

from benchmark import tracing


def read(record):
    tr = record["trace"]
    if not tr or not tr["device"] or tr["window_ns"] <= 0:
        return None
    return 100.0 * (1.0 - tracing.busy_ns(tr) / tr["window_ns"])

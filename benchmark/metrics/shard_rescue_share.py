"""Share of the shard loop's shards that ran the rescue tier, in %: the
``monica.rescue`` spans that start inside a ``monica.shard`` span, over
the ``monica.shard`` spans of the traced pass (a shard runs the tier at
most once a batch)."""

import bisect

from benchmark import spans


def read(record):
    found = spans.spans(record, "shard")
    if not found:
        return None
    shards = sorted((s, s + d) for s, d, _ in found)
    starts = [s for s, _ in shards]
    nested = 0
    for start, _, _ in spans.spans(record, "rescue"):
        i = bisect.bisect_right(starts, start) - 1
        nested += i >= 0 and start < shards[i][1]
    return 100.0 * nested / len(found)

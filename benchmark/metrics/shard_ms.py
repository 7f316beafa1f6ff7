"""Mean host time of one shard of a stacked index, in ms: the
``monica.shard`` spans (``align/pipeline.py`` ``classify_groups``, one a
shard and batch) of the traced pass, summed over their number.  A
one-shard index opens none, so there is nothing to read."""

from benchmark import spans


def read(record):
    found = spans.spans(record, "shard")
    if not found:
        return None
    return sum(d for _, d, _ in found) / len(found) / 1e6

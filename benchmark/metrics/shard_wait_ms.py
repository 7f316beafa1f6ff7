"""Mean host time a batch spent waiting for the card inside the shard
loop, in ms: the blocking runtime calls (``spans.SYNCS``: each shard's
rescue tier pick) inside the ``monica.shard`` spans of the traced pass,
over its batches."""

from benchmark import spans


def read(record):
    found = spans.spans(record, "shard")
    if not found:
        return None
    return spans.per_batch_ms(record, sum(d for _, d in spans.syncs_inside(record, found)))

"""Mean host time a batch of the eager pipeline dispatch, in ms: the
``monica.pipeline`` spans of the traced pass less the time the host
waited for the card inside them (the rescue tier pick's copy and sync:
``spans.SYNCS``), over its batches."""

from benchmark import spans


def read(record):
    found = spans.spans(record, "pipeline")
    if not found:
        return None
    waits = sum(d for _, d in spans.syncs_inside(record, found))
    return spans.per_batch_ms(record, sum(d for _, d, _ in found) - waits)

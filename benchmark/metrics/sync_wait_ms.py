"""Mean host time a batch spent waiting for the card, in ms: the CUDA
runtime's synchronize calls (stream, device, event) and copies
(``cudaMemcpy``, ``cudaMemcpyAsync``: a copy to pageable host memory
returns only when done) inside the ``monica.classify`` and
``monica.fetch`` spans of the traced pass, over its batches."""

from benchmark import spans


def read(record):
    classify, fetch = spans.spans(record, "classify"), spans.spans(record, "fetch")
    if not classify or not fetch:
        return None
    waits = spans.syncs_inside(record, classify + fetch)
    return spans.per_batch_ms(record, sum(d for _, d in waits))

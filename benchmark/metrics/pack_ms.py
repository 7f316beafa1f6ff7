"""Mean host time a batch of the program's 2-bit pack, in ms: the
``monica.pack`` spans (``io/encode.pack_codes_2bit`` inside
``Classifier.classify``) of the traced pass over its batches."""

from benchmark import spans


def read(record):
    found = spans.spans(record, "pack")
    if not found:
        return None
    return spans.per_batch_ms(record, sum(d for _, d, _ in found))

"""Share of the rescue tier's SW rows that hold a candidate, in %: the
candidates over the slots of the tier each shard and batch picked,
summed over the ``monica.rescue`` spans (``cand=``, ``slots=``) of the
traced pass."""

from benchmark import spans


def read(record):
    found = spans.spans(record, "rescue")
    if not found:
        return None
    slots = sum(int(c["slots"]) for _, _, c in found)
    return 100.0 * sum(int(c["cand"]) for _, _, c in found) / slots

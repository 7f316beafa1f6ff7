"""``Classifier.__init__``: the index's tensors on the card (the stacking
of a sharded index), host clock, synchronised."""


def read(record):
    return record["upload_s"]

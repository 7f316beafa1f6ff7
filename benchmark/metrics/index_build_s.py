"""``build_index_from_arrays`` on the card, host clock, synchronised."""


def read(record):
    return record["build_s"]

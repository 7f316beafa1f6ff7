"""Process start to the first timed batch: the inputs drawn, the index
built, the Classifier made and every batch of the pool run once."""


def read(record):
    return record["setup_s"]

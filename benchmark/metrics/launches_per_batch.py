"""Device kernels, copies and memsets in the traced pass over the pool,
a batch."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["device"]:
        return None
    return len(tr["device"]) / tr["batches"]

"""Host syncs that torch's sync debug mode reports over one pass of
classify and fetch, a batch (the fetch's copy back is one)."""


def read(record):
    s = record["syncs"]
    if not s or not s["sites"]:
        return None
    return len(s["sites"]) / s["batches"]

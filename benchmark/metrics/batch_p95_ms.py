"""95th percentile, over every batch of the window, of the time from the
``classify`` call to the return of its ``fetch``, in ms."""

import numpy as np


def read(record):
    return float(np.percentile(record["window"]["latency_s"], 95)) * 1e3

"""Mean host time of a ``Classifier.fetch`` call over the window, in ms:
the wait for the device's work and the copy back."""

import numpy as np


def read(record):
    return float(np.mean(record["window"]["fetch_s"])) * 1e3

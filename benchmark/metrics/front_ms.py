"""Mean host time of a ``Classifier.classify`` call over the window, in
ms: the 2-bit pack, the upload and the eager dispatch until it returns."""

import numpy as np


def read(record):
    return float(np.mean(record["window"]["front_s"])) * 1e3

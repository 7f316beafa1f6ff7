"""The banded SW kernels' share of their roofline, in %: the least time
the card needs for the DP cells and bytes that the traced batches'
extensions need (``benchmark/roofline.py``, counted from the reads the
reference says each shard extends), over the device time of the
``banded_sw_*`` kernels in the traced pass."""

from benchmark import roofline


def read(record):
    tr, sw = record["trace"], record["sw"]
    if not tr or not sw or not sw["cells"]:
        return None
    t = sum(d for name, _, _, d in tr["device"] if "banded_sw" in name) / 1e9
    if t <= 0:
        return None
    return 100.0 * roofline.sw_bound_s(sw["cells"], sw["bytes"]) / t

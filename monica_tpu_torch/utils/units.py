"""Human-readable memory sizes — counterpart of
``monica_tpu/utils/units.py``: a number followed by one of ``B|K|M|G|T``
(powers of 1024), e.g. ``"2.45K"`` -> ``2508.8`` bytes, as the CLI's
``-im/--indexing_memory`` takes it.
"""

from __future__ import annotations

import re
from argparse import ArgumentTypeError

_UNITS = {"B": 1, "K": 1024, "M": 1024**2, "G": 1024**3, "T": 1024**4}


def human_readable(size: str) -> float:
    """Parse ``"<number><unit>"`` into bytes; raises ArgumentTypeError."""
    if not re.search(r"[BKMGT]$", size):
        raise ArgumentTypeError(
            "Wrong memory unit specified, it must end with one among B|K|M|G|T"
        )
    if not re.search(r"^\d", size):
        raise ArgumentTypeError("Should also put a number in front of memory unit..")
    return float(size[:-1]) * _UNITS[size[-1]]

"""32-bit unsigned arithmetic on ``int64`` tensors.

torch (2.x, CPU) raises ``NotImplementedError`` for ``uint32`` shifts
and comparisons, and ``int32 >>`` is arithmetic, so the port keeps
every 32-bit unsigned value (minimizer hash, packed table entry) in an
``int64`` tensor holding the value in its low 32 bits, always
non-negative.  Shifts, xors and comparisons are then exact; only
multiplication needs care (:func:`mul32`).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (e.g. an int32 bit pattern) -> its unsigned
    32-bit value in int64."""
    return x.to(torch.int64) & MASK32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a 32-bit constant c.

    Split into 16-bit halves of c so no int64 product overflows (each
    partial product is < 2^48): the result is exact without relying on
    signed-overflow wraparound."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32

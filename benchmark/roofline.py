"""The yardstick's peaks and the banded SW's work, counted from shapes.

Frozen here so that no later change to the program can move them.

* ``HBM_BYTES_PER_S``: the H100 SXM's published HBM3 bandwidth.
* ``DPX_OPS_PER_S``: the card's 32-bit integer max/add rate with the
  fused DPX forms, as ``ops/csrc/alu_ceiling.cu`` measured it on the
  H100 (16.2-17.2 T instructions/s over 2^21 lanes; 16.7 taken).
* ``OPS_PER_CELL``: the fewest 32-bit operations one cell of the banded
  local-alignment recurrence needs, whatever implements it.  A cell
  takes the substitution score of its two bases (one compare-select),
  adds it to the diagonal predecessor (one add), takes the vertical gap
  into the max (one fused add-max), and the horizontal gap with the
  floor at 0 (one fused add-max-relu).  The matched length rides in the
  low bits of the same word (the packed state); the running best, one
  three-way max for two cells, would add half an operation, left out so
  that the count stays a floor.  An
  implementation that packs several cells into one 32-bit word (8-bit
  difference lanes) could go below this count; none exists here.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
DPX_OPS_PER_S = 16.7e12
OPS_PER_CELL = 4


def sw_work(lengths, band: int) -> tuple[int, int]:
    """(DP cells, bytes) that extending reads of these lengths needs:
    length x band cells a read; its codes and its reference window
    (length + band) read once, its score and matched length written
    once."""
    cells = sum(int(n) * band for n in lengths)
    nbytes = sum(int(n) + int(n) + band + 8 for n in lengths)
    return cells, nbytes


def sw_bound_s(cells: int, nbytes: int) -> float:
    """The least time the card needs for that work."""
    return max(nbytes / HBM_BYTES_PER_S, cells * OPS_PER_CELL / DPX_OPS_PER_S)

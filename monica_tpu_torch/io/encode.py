"""Base encoding, the 2-bit wire format and reference packing (host
side, numpy) — counterpart of the parts of ``monica_tpu/io/encode.py``
that the single-shard classify path uses, with the same outputs.

Sequences are flat ``uint8`` code arrays: A, C, G, T -> 0..3, anything
else (N, padding) -> 4.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_CODE = 4
PAD_CODE = 4

_LUT = np.full(256, N_CODE, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    _LUT[ord(_b)] = _i
    _LUT[ord(_b.lower())] = _i


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode one sequence to uint8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """(B, L) uint8 codes -> (B, ceil(L/4)) uint8 wire format: 4 bases
    per byte, base i in bits 2*(i % 4) of byte i//4.  Non-ACGT codes map
    to 0; the device re-masks each row past its length."""
    B, L = codes.shape
    P4 = -(-L // 4) * 4
    c = np.zeros((B, P4), np.uint8)
    np.copyto(c[:, :L], np.where(codes < 4, codes, 0))
    c = c.reshape(B, P4 // 4, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


@dataclass
class PackedSeqs:
    """Reference records end to end in one flat code array, separated by
    runs of N_CODE so no seed or alignment bridges two records."""

    codes: np.ndarray  # (total,) uint8
    starts: np.ndarray  # (n_seqs,) int64 start offset of each record
    lengths: np.ndarray  # (n_seqs,) int64
    seq_accession_id: np.ndarray  # (n_seqs,) int32
    guard: int = 32  # separator length between records


class PackedSeqsBuilder:
    def __init__(self, guard: int = 32):
        self.guard = guard
        # leading guard: position 0 never hosts a minimizer, so the
        # packed hash-table rows can use payload 0 as the empty slot
        self._chunks: list[np.ndarray] = (
            [np.full(guard, N_CODE, dtype=np.uint8)] if guard else []
        )
        self._starts: list[int] = []
        self._lengths: list[int] = []
        self._acc_ids: list[int] = []
        self._off = guard

    def add(self, codes: np.ndarray, accession_id: int) -> None:
        self._starts.append(self._off)
        self._lengths.append(len(codes))
        self._acc_ids.append(accession_id)
        self._chunks.append(codes)
        self._chunks.append(np.full(self.guard, N_CODE, dtype=np.uint8))
        self._off += len(codes) + self.guard

    def build(self) -> PackedSeqs:
        codes = np.concatenate(self._chunks) if self._chunks else np.zeros(0, np.uint8)
        return PackedSeqs(
            codes=codes,
            starts=np.asarray(self._starts, dtype=np.int64),
            lengths=np.asarray(self._lengths, dtype=np.int64),
            seq_accession_id=np.asarray(self._acc_ids, dtype=np.int32),
            guard=self.guard,
        )

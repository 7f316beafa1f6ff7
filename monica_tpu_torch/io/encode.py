"""Base encoding, the 2-bit wire format, read bucketing and reference
packing (host side: numpy, and the wire pack in ``io.native``) —
counterpart of ``monica_tpu/io/encode.py``, with the same outputs.

Sequences are flat ``uint8`` code arrays: A, C, G, T -> 0..3, anything
else (N, padding) -> 4.  Reads are padded into power-of-two length
buckets; reads longer than the largest bucket become several window
rows that share one read index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from monica_tpu_torch.io import native

N_CODE = 4
PAD_CODE = 4

_LUT = np.full(256, N_CODE, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    _LUT[ord(_b)] = _i
    _LUT[ord(_b.lower())] = _i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode one sequence to uint8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    return _DECODE[np.minimum(codes, N_CODE)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (A<->T, C<->G; N stays N)."""
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return comp[::-1]


def pack_codes_2bit(codes: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """(B, L) uint8 codes -> (B, ceil(L/4)) uint8 wire format: 4 bases
    per byte, base i in bits 2*(i % 4) of byte i//4.  Non-ACGT codes map
    to 0; the device re-masks each row past its length.  Written into
    ``out`` (C-contiguous uint8 of that shape) when given, and returned.

    One native pass (``io.native.pack_2bit``) where the host library
    loads, else numpy; ``io.native.PACKED`` counts each route."""
    B, L = codes.shape
    shape = (B, -(-L // 4))
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8:
        raise ValueError(f"out must be uint8 {shape}, not {out.dtype} {out.shape}")
    if codes.dtype == np.uint8 and native.load() is not None:
        native.pack_2bit(np.ascontiguousarray(codes), out)
        native.count_pack("native")
        return out
    P4 = shape[1] * 4
    c = np.zeros((B, P4), np.uint8)
    np.copyto(c[:, :L], np.where(codes < 4, codes, 0))
    c = c.reshape(B, P4 // 4, 4)
    np.bitwise_or(c[..., 0] | (c[..., 1] << 2), (c[..., 2] << 4) | (c[..., 3] << 6), out=out)
    native.count_pack("numpy")
    return out


@dataclass
class ReadBatch:
    """A padded batch of reads: codes (n, L) uint8, PAD_CODE beyond each
    read's length; lengths (n,) int32; idx (n,) int32 index of each row's
    read in the originating read list (-1 for a padding row)."""

    codes: np.ndarray
    lengths: np.ndarray
    idx: np.ndarray

    @property
    def bucket_len(self) -> int:
        return self.codes.shape[1]

    def __len__(self) -> int:
        return self.codes.shape[0]


DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)

# a trailing window shorter than this is dropped when an ultra-long
# read is split (too few seeds to be informative on its own)
MIN_TAIL = 256


def bucket_for_length(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def window_plan(lengths, buckets=DEFAULT_BUCKETS,
                max_batch: int | None = None) -> list[tuple[int, list[tuple[int, int, int]]]]:
    """Device rows for a set of read lengths:
    ``[(bucket_len, [(read_idx, offset, wlen), ...]), ...]``, batches in
    ascending bucket order of at most ``max_batch`` rows.  A read that
    fits a bucket takes one row; a longer one is split into windows of
    the largest bucket that share its read_idx (the runtime merges their
    verdicts back into one per read)."""
    B = buckets[-1]
    per: dict[int, list[tuple[int, int, int]]] = {}
    for i, n in enumerate(lengths):
        n = int(n)
        if n <= B:
            per.setdefault(bucket_for_length(n, buckets), []).append((i, 0, n))
            continue
        off = 0
        while off < n:
            w = min(B, n - off)
            if w < MIN_TAIL:
                break
            per.setdefault(bucket_for_length(w, buckets), []).append((i, off, w))
            off += w
    out = []
    for blen in sorted(per):
        rows = per[blen]
        step = max_batch or len(rows)
        for s in range(0, len(rows), step):
            out.append((blen, rows[s : s + step]))
    return out


def bucketize_reads(seqs: list[str], buckets=DEFAULT_BUCKETS,
                    max_batch: int | None = None) -> list[ReadBatch]:
    """Group reads into per-bucket padded batches (see window_plan)."""
    out: list[ReadBatch] = []
    for blen, rows in window_plan([len(s) for s in seqs], buckets, max_batch):
        codes = np.full((len(rows), blen), PAD_CODE, dtype=np.uint8)
        lengths = np.zeros(len(rows), dtype=np.int32)
        idx = np.zeros(len(rows), dtype=np.int32)
        for row, (i, off, w) in enumerate(rows):
            c = encode_seq(seqs[i][off : off + w])
            codes[row, : len(c)] = c
            lengths[row] = len(c)
            idx[row] = i
        out.append(ReadBatch(codes, lengths, idx))
    return out


def pad_rows(batch: ReadBatch, multiple: int = 1, target: int | None = None) -> ReadBatch:
    """Pad the row count up to a multiple of ``multiple``, or to exactly
    ``target`` rows.  Padding rows have length 0 and idx -1."""
    n = len(batch)
    if target is None:
        target = -(-n // multiple) * multiple
    if target == n:
        return batch
    codes = np.full((target, batch.bucket_len), PAD_CODE, dtype=np.uint8)
    codes[:n] = batch.codes
    lengths = np.zeros(target, dtype=np.int32)
    lengths[:n] = batch.lengths
    idx = np.full(target, -1, dtype=np.int32)
    idx[:n] = batch.idx
    return ReadBatch(codes, lengths, idx)


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

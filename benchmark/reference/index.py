"""The plain reference's index: the port's index semantics rebuilt from
the genomes, in plain PyTorch, on whatever device it is given.

Frozen from the port (``index/build.py``, ``index/minimizer.py``,
``ops/lookup.py``, ``align/pipeline.py``'s stacking) and written the
straight way: each shard is sketched whole (no segments), sorted by
(hash, pos << 1 | strand), cut by the occurrence cap and dealt into
its hash rows.  Shards are assigned to genomes by the port's rule
(greedy LPT over a shard count, raised until each fits 2^26 bases),
packed with 32-base N guards, and, for more than one shard, padded to
the sizes of their power-of-2 size class as the port stacks them (the
padded reference length takes part in the extension's window clamp).
It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INVALID_HASH = MASK32
ROW_SLOTS = 8
OCC_CAP = ROW_SLOTS
SHARD_CAP = 1 << 26
SEG_LEN = 1 << 25
GUARD = 32
N_CODE = 4
MIN_TAG_BITS = 5


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 on int64-held u32 values, in 16-bit halves of c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kmer_hashes(codes: torch.Tensor, k: int):
    """Canonical k-mer hashes along the last axis -> (hash int64 holding a
    u32, strand bool), each (..., n - k + 1).  k-mer i packs bases
    i..i+k-1 two bits each, the first base highest; its reverse
    complement packs the complements with the first base lowest; the
    smaller is canonical (strand True when the reverse complement is).
    A k-mer with a non-ACGT base, or equal to its reverse complement,
    hashes to INVALID_HASH."""
    m = codes.shape[-1] - k + 1
    if m <= 0:
        raise ValueError(f"sequence shorter than k={k}")
    c = codes.to(torch.int64)
    fw_all = c & 3
    fwd = torch.zeros(c.shape[:-1] + (m,), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros(fwd.shape, dtype=torch.bool, device=c.device)
    for j in range(k):
        fw = fw_all[..., j: j + m]
        fwd = (fwd << 2) | fw
        rc = rc | ((3 - fw) << (2 * j))
        bad = bad | (c[..., j: j + m] >= 4)
    strand = rc < fwd
    h = fmix32(torch.minimum(fwd, rc))
    return torch.where(bad | (fwd == rc), INVALID_HASH, h), strand


def frac_threshold(frac: float) -> int:
    return min(max(int(frac * 4294967296.0), 1), 0xFFFFFFFE)


def select_minimizers(h: torch.Tensor, w: int, frac: float = 1.0) -> torch.Tensor:
    """Winnowing: keep position i when h[i] is the minimum of some window
    of w k-mers that holds i (windows running past the end are cut
    short); INVALID_HASH is never kept."""
    m = h.shape[-1]
    tail = torch.full(h.shape[:-1] + (w - 1,), INVALID_HASH, dtype=h.dtype, device=h.device)
    mins = torch.cat([h, tail], -1).unfold(-1, w, 1).min(-1).values
    head = torch.zeros(h.shape[:-1] + (w - 1,), dtype=h.dtype, device=h.device)
    maxs = torch.cat([head, mins], -1).unfold(-1, w, 1).max(-1).values[..., :m]
    keep = (maxs == h) & (h != INVALID_HASH)
    if frac < 1.0:
        keep = keep & (h <= frac_threshold(frac))
    return keep


def tag_bits_for(ref_len: int) -> int:
    payload_bits = 1 + max(int(np.ceil(np.log2(max(ref_len, 2)))), 1)
    tb = 32 - payload_bits
    if tb < MIN_TAG_BITS:
        raise ValueError(f"shard of {ref_len} bases leaves {tb} tag bits")
    return tb


def row_bits_for(n_entries: int) -> int:
    return max(int(np.ceil(np.log2(max(n_entries, 2)))) - 1, 1)


def _lpt(sizes: list[int], n_shards: int) -> list[list[int]]:
    order = np.argsort(sizes)[::-1]
    loads = [0] * n_shards
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for i in order:
        j = int(np.argmin(loads))
        shards[j].append(int(i))
        loads[j] += sizes[i]
    return [sorted(s) for s in shards]


def assign_shards(unit_sizes: list[int], n_shards: int) -> list[list[int]]:
    """Units (genome segments) per shard: LPT over ``n_shards``, the
    count raised until every packed shard fits SHARD_CAP with its
    guards; empty shards dropped."""
    cap = SHARD_CAP - 64 * (len(unit_sizes) + 2)
    n = max(n_shards, 1)
    while True:
        a = _lpt(unit_sizes, n)
        if all(sum(unit_sizes[i] for i in m) <= cap for m in a if m):
            return [m for m in a if m]
        n += 1


def units_of(genomes: list[np.ndarray]) -> list[tuple[int, np.ndarray]]:
    """(accession id, codes) units: each genome, cut at SEG_LEN."""
    out = []
    for gi, g in enumerate(genomes):
        for off in range(0, len(g), SEG_LEN):
            out.append((gi, g[off: off + SEG_LEN]))
    return out


def pack(members: list[int], units) -> tuple[np.ndarray, np.ndarray]:
    """The members' codes end to end, each followed by GUARD N's and the
    whole led by GUARD N's -> (codes uint8, accession id per position
    int32, 0 on the guards)."""
    parts = [np.full(GUARD, N_CODE, np.uint8)]
    acc = [np.zeros(GUARD, np.int32)]
    for ui in members:
        gi, c = units[ui]
        parts += [np.asarray(c, np.uint8), np.full(GUARD, N_CODE, np.uint8)]
        acc += [np.full(len(c), gi, np.int32), np.zeros(GUARD, np.int32)]
    return np.concatenate(parts), np.concatenate(acc)


def sorted_entries(codes: np.ndarray, k: int, w: int, frac: float, device):
    """The shard's minimizers sorted by (hash, pos << 1 | strand), runs
    of one hash longer than OCC_CAP dropped -> (hash, pos << 1 | strand)
    int64 tensors on ``device``."""
    c = torch.from_numpy(codes).to(device)
    h, s = kmer_hashes(c, k)
    keep = select_minimizers(h, w, frac)
    pos = torch.nonzero(keep)[:, 0]
    hh = h[pos]
    ps = (pos << 1) | s[pos].to(torch.int64)
    del h, s, keep, c
    # one int64 key; the hash biased by 2^31 so the shift cannot overflow
    key = torch.sort(((hh - (1 << 31)) << 32) | ps).values
    hh, ps = (key >> 32) + (1 << 31), key & MASK32
    if not len(hh):
        return hh, ps
    new = torch.ones(len(hh), dtype=torch.bool, device=hh.device)
    new[1:] = hh[1:] != hh[:-1]
    starts = torch.nonzero(new)[:, 0]
    runlen = torch.diff(torch.cat([starts, torch.tensor([len(hh)], device=hh.device)]))
    keep = torch.repeat_interleave(runlen <= OCC_CAP, runlen)
    return hh[keep], ps[keep]


def hash_table(h: torch.Tensor, ps: torch.Tensor, tag_bits: int, rbits: int) -> torch.Tensor:
    """(2^rbits, ROW_SLOTS) table as int32 bit patterns: entry
    (low tag_bits of the hash) << (32 - tag_bits) | pos << 1 | strand
    in row (top rbits of the hash), at its rank in that row; ranks past
    ROW_SLOTS dropped; 0 is an empty slot."""
    n_rows = 1 << rbits
    table = torch.zeros((n_rows, ROW_SLOTS), dtype=torch.int64, device=h.device)
    if len(h):
        row = h >> (32 - rbits)
        first = torch.searchsorted(row, torch.arange(n_rows, device=h.device))
        rank = torch.arange(len(h), device=h.device) - first[row]
        ok = rank < ROW_SLOTS
        entries = ((h & ((1 << tag_bits) - 1)) << (32 - tag_bits)) | ps
        table[row[ok], rank[ok]] = entries[ok]
    return torch.where(table >= 1 << 31, table - (1 << 32), table).to(torch.int32)


@dataclass
class RefShard:
    table: torch.Tensor  # (2^rbits, ROW_SLOTS) int32
    pos_acc: torch.Tensor  # (T,) int64 accession id of each position
    ref_codes: torch.Tensor  # (T,) uint8


@dataclass
class RefIndex:
    shards: list[RefShard]  # in the order the port classifies them
    tag_bits: int
    grouped: bool  # more than one shard: merged across shards
    n_accessions: int


def build(genomes: list[np.ndarray], n_shards: int, k: int, w: int, frac: float,
          device) -> RefIndex:
    units = units_of(genomes)
    assignment = assign_shards([len(u[1]) for u in units], n_shards)
    packed = [pack(m, units) for m in assignment]
    entries = [sorted_entries(codes, k, w, frac, device) for codes, _ in packed]
    if len(packed) == 1:
        (codes, acc), (h, ps) = packed[0], entries[0]
        tb = tag_bits_for(len(codes))
        shard = RefShard(hash_table(h, ps, tb, row_bits_for(len(h))),
                         torch.from_numpy(acc).long().to(device),
                         torch.from_numpy(codes).to(device))
        return RefIndex([shard], tb, False, len(genomes))
    tb = tag_bits_for(max(len(c) for c, _ in packed))
    by_class: dict[int, list[int]] = {}
    for i, (codes, _) in enumerate(packed):
        by_class.setdefault(1 << max(len(codes) - 1, 0).bit_length(), []).append(i)
    shards = []
    for cls in sorted(by_class):
        members = by_class[cls]
        T = max(len(packed[i][0]) for i in members)
        rbits = max(row_bits_for(len(entries[i][0])) for i in members)
        for i in members:
            codes, acc = packed[i]
            pc = np.full(T, N_CODE, np.uint8)
            pc[: len(codes)] = codes
            pa = np.zeros(T, np.int64)
            pa[: len(acc)] = acc
            shards.append(RefShard(hash_table(*entries[i], tb, rbits),
                                   torch.from_numpy(pa).to(device),
                                   torch.from_numpy(pc).to(device)))
    return RefIndex(shards, tb, True, len(genomes))

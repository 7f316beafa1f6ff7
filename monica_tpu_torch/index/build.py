"""Host index build — counterpart of the host path of
``monica_tpu/index/build.py``.

Genomes are packed into one flat uint8 code array per shard (records
separated by N guards), sketched on the CPU with the port's own sketch
(:mod:`monica_tpu_torch.index.minimizer`), hash-sorted, filtered by the
occurrence cap and attributed per position to an accession id.  The
arrays are bit-identical to the reference's host build.  A multi-shard
build runs one thread per shard (:func:`_build_shards_threaded`).  The
device-side build is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from monica_tpu_torch.index import minimizer as mz
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.io import seq as seqio
from monica_tpu_torch.ops.lookup import ROW_SLOTS

# a minimizer occurring more than OCC_CAP times in a shard is dropped
# wholesale (the minimap2 repetitive-seed cut); equal to the hash-row
# capacity so every kept run fits its row
OCC_CAP = ROW_SLOTS
# packed lookup entries need pos<<1|strand plus >= MIN_TAG_BITS of tag
SHARD_CAP = 1 << 26
# records longer than this are segmented before packing
SEG_LEN = 1 << 25


@dataclass
class IndexMeta:
    """Host-side metadata shared by all shards."""

    tax_units: list[str]  # per accession-id: species name
    accessions: list[str]  # per accession-id: accession
    genome_lengths: np.ndarray  # (n_accessions,) int64 total bp
    k: int = mz.K_DEFAULT
    w: int = mz.W_DEFAULT
    frac: float = mz.FRAC_DEFAULT
    occ_cap: int = OCC_CAP

    @property
    def n_accessions(self) -> int:
        return len(self.accessions)


@dataclass
class IndexShard:
    """One shard: packed reference + sorted minimizer table (numpy)."""

    ref_codes: np.ndarray  # (T,) uint8
    seq_starts: np.ndarray  # (n_seqs,) int64
    seq_lengths: np.ndarray  # (n_seqs,) int64
    seq_accession_id: np.ndarray  # (n_seqs,) int32
    mz_hash: np.ndarray  # (M,) uint32 sorted ascending
    mz_pos: np.ndarray  # (M,) int32 position within the shard reference
    mz_strand: np.ndarray  # (M,) uint8 (1 = canonical k-mer on the rc strand)
    pos_accession_id: np.ndarray = field(default=None)  # (T,) uint16

    @property
    def n_minimizers(self) -> int:
        return len(self.mz_hash)


@dataclass
class BuiltIndex:
    meta: IndexMeta
    shards: list[IndexShard]
    # device-resident tables of a device-side build, as in the reference;
    # that build is not ported yet, so the host build leaves it None
    device: list | None = None


def sketch_long_sequence(
    codes: np.ndarray, k: int, w: int, chunk: int = 1 << 19,
    frac: float = mz.FRAC_DEFAULT,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chunked CPU sketch of one flat code array -> (hash uint32, pos
    int64, strand uint8) of the selected minimizers in position order.
    Selection at k-mer position p depends only on hashes in
    [p-w+1, p+w-1], so chunks overlapping by 2w + k reproduce the global
    selection; the chunk size only affects speed and memory."""
    n = len(codes)
    if n < k:
        e = np.zeros(0)
        return e.astype(np.uint32), e.astype(np.int64), e.astype(np.uint8)
    overlap = 2 * w + k

    def sketch_chunk(start: int):
        stop = min(n, start + chunk)
        lo = max(0, start - overlap)
        hi = min(n, stop + overlap)
        h, s = mz.kmer_hashes(torch.from_numpy(codes[lo:hi]), k)
        keep = mz.select_minimizers(h, w, frac=frac)
        sel = torch.nonzero(keep)[:, 0].numpy()
        gpos = sel + lo
        own = (gpos >= start) & (gpos < stop)
        sel, gpos = sel[own], gpos[own]
        return (h.numpy()[sel].astype(np.uint32), gpos.astype(np.int64),
                s.numpy()[sel].astype(np.uint8))

    parts = [sketch_chunk(s0) for s0 in range(0, n - k + 1, chunk)]
    return (
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.concatenate([p[2] for p in parts]),
    )


def split_genomes(
    sizes: list[int], n_shards: int | None = None, max_shard_bytes: int | None = None
) -> list[list[int]]:
    """Partition genome indices into shards: a fixed count (greedy LPT)
    or a byte budget per shard (streaming greedy; an oversized genome
    gets its own shard)."""
    if n_shards is not None:
        order = np.argsort(sizes)[::-1]
        loads = [0] * n_shards
        shards: list[list[int]] = [[] for _ in range(n_shards)]
        for i in order:
            j = int(np.argmin(loads))
            shards[j].append(int(i))
            loads[j] += sizes[i]
        return [sorted(s) for s in shards]
    if max_shard_bytes is None:
        raise ValueError("split_genomes needs n_shards or max_shard_bytes")
    shards = []
    cur: list[int] = []
    cur_size = 0
    for i, size in enumerate(sizes):
        if size > max_shard_bytes:
            if cur:
                shards.append(cur)
                cur, cur_size = [], 0
            shards.append([i])
        elif cur_size + size <= max_shard_bytes:
            cur.append(i)
            cur_size += size
        else:
            shards.append(cur)
            cur, cur_size = [i], size
    if cur:
        shards.append(cur)
    return shards


def _segment_records(
    genome_records: list[list[np.ndarray]],
) -> list[tuple[int, np.ndarray]]:
    """Flatten genomes to (accession_id, codes) units, splitting records
    longer than SEG_LEN."""
    units: list[tuple[int, np.ndarray]] = []
    for gi, recs in enumerate(genome_records):
        for r in recs:
            r = np.asarray(r, dtype=np.uint8)
            if len(r) <= SEG_LEN:
                units.append((gi, r))
            else:
                for off in range(0, len(r), SEG_LEN):
                    units.append((gi, r[off : off + SEG_LEN]))
    return units


def _assign_units(
    unit_sizes: list[int], n_shards: int | None, max_shard_bytes: int | None
) -> list[list[int]]:
    """split_genomes over units with SHARD_CAP enforced: the shard count
    is raised until every packed shard fits."""
    slack = 64 * (len(unit_sizes) + 2)  # guard blocks
    cap = SHARD_CAP - slack
    if max_shard_bytes is not None:
        return split_genomes(unit_sizes, max_shard_bytes=min(max_shard_bytes, cap))
    n = max(n_shards or 1, 1)
    while True:
        assignment = split_genomes(unit_sizes, n_shards=n)
        if all(sum(unit_sizes[i] for i in m) <= cap for m in assignment if m):
            return [m for m in assignment if m]
        n += 1


def _build_shard(
    members: list[int],
    units: list[tuple[int, np.ndarray]],
    k: int,
    w: int,
    guard: int,
    frac: float,
    occ_cap: int = OCC_CAP,
) -> IndexShard:
    """Pack the member units, sketch, stable hash sort, occ cap,
    per-position accession fill."""
    builder = enc.PackedSeqsBuilder(guard=guard)
    for ui in members:
        gi, rec_codes = units[ui]
        builder.add(rec_codes, gi)
    packed = builder.build()
    if len(packed.codes) >= SHARD_CAP:
        raise ValueError(
            "index shard exceeds 64 Mbase; raise n_shards or lower max_shard_bytes"
        )
    h, pos, strand = sketch_long_sequence(packed.codes, k, w, frac=frac)
    order = np.argsort(h, kind="stable")
    h_s, pos_s, strand_s = h[order], pos[order], strand[order]
    if occ_cap and len(h_s):
        starts = np.flatnonzero(np.concatenate([[True], h_s[1:] != h_s[:-1]]))
        runlen = np.diff(np.concatenate([starts, [len(h_s)]]))
        keep = np.repeat(runlen <= occ_cap, runlen)
        h_s, pos_s, strand_s = h_s[keep], pos_s[keep], strand_s[keep]
    pos_acc = np.zeros(max(len(packed.codes), 1), dtype=np.uint16)
    for s0, ln, aid in zip(packed.starts, packed.lengths, packed.seq_accession_id):
        pos_acc[s0 : s0 + ln] = aid
    return IndexShard(
        ref_codes=packed.codes,
        seq_starts=packed.starts,
        seq_lengths=packed.lengths,
        seq_accession_id=packed.seq_accession_id,
        mz_hash=h_s,
        mz_pos=pos_s.astype(np.int32),
        mz_strand=strand_s,
        pos_accession_id=pos_acc,
    )


def _build_shards_threaded(assignment, units, k, w, guard, frac, occ_cap) -> list[IndexShard]:
    """Build the shards concurrently, one thread per shard (at most 8):
    _build_shard is pure, and the torch sketch and numpy's large array
    ops release the GIL, so the shards' sketch chains overlap.  Each
    shard is the same as from a serial build."""
    if len(assignment) <= 1:
        return [_build_shard(m, units, k, w, guard, frac, occ_cap) for m in assignment]
    with ThreadPoolExecutor(max_workers=min(len(assignment), 8)) as pool:
        return list(pool.map(
            lambda m: _build_shard(m, units, k, w, guard, frac, occ_cap), assignment))


def _build(units, n_shards, max_shard_bytes, k, w, guard, frac, occ_cap):
    assignment = _assign_units(
        [len(u[1]) for u in units],
        n_shards if max_shard_bytes is None else None,
        max_shard_bytes,
    )
    return _build_shards_threaded(assignment, units, k, w, guard, frac, occ_cap)


def build_index(
    genomes: list[tuple[str, list[str]]],
    n_shards: int = 1,
    max_shard_bytes: int | None = None,
    k: int = mz.K_DEFAULT,
    w: int = mz.W_DEFAULT,
    guard: int = 32,
    frac: float = mz.FRAC_DEFAULT,
    occ_cap: int = OCC_CAP,
) -> BuiltIndex:
    """Build a sharded index from genome FASTA files;
    ``genomes`` is a list of (fasta_path, [species_name, accession])."""
    if not genomes:
        raise ValueError("build_index: empty genome set (nothing to index)")
    genome_lengths = np.zeros(len(genomes), dtype=np.int64)
    all_codes: list[list[np.ndarray]] = []
    for gi, (path, _hdr) in enumerate(genomes):
        recs = [enc.encode_seq(r.seq) for r in seqio.read_fasta(path)]
        all_codes.append(recs)
        genome_lengths[gi] = int(sum(len(r) for r in recs))
    units = _segment_records(all_codes)
    if not units:
        raise ValueError("build_index: genomes contain no sequence records")
    meta = IndexMeta(
        tax_units=[g[1][0] for g in genomes],
        accessions=[g[1][1] for g in genomes],
        genome_lengths=genome_lengths,
        k=k, w=w, frac=frac, occ_cap=occ_cap,
    )
    shards = _build(units, n_shards, max_shard_bytes, k, w, guard, frac, occ_cap)
    return BuiltIndex(meta=meta, shards=shards)


def build_index_from_arrays(
    seqs: list[np.ndarray],
    tax_units: list[str] | None = None,
    accessions: list[str] | None = None,
    n_shards: int = 1,
    max_shard_bytes: int | None = None,
    k: int = mz.K_DEFAULT,
    w: int = mz.W_DEFAULT,
    guard: int = 32,
    frac: float = mz.FRAC_DEFAULT,
    occ_cap: int = OCC_CAP,
) -> BuiltIndex:
    """Build an index directly from uint8 code arrays (one per genome)."""
    if not seqs:
        raise ValueError("build_index_from_arrays: empty genome set")
    n = len(seqs)
    meta = IndexMeta(
        tax_units=tax_units or [f"Species_{i}" for i in range(n)],
        accessions=accessions or [f"ACC{i:04d}.1" for i in range(n)],
        genome_lengths=np.array([len(s) for s in seqs], dtype=np.int64),
        k=k, w=w, frac=frac, occ_cap=occ_cap,
    )
    units = _segment_records([[np.asarray(s, dtype=np.uint8)] for s in seqs])
    shards = _build(units, n_shards, max_shard_bytes, k, w, guard, frac, occ_cap)
    return BuiltIndex(meta=meta, shards=shards)

"""Index build — counterpart of ``monica_tpu/index/build.py``.

Genomes are packed into one flat uint8 code array per shard (records
separated by N guards), sketched with the port's own sketch
(:mod:`monica_tpu_torch.index.minimizer`), hash-sorted, filtered by the
occurrence cap and attributed per position to an accession id.

Every build, of any shard count on any device, gives host
``IndexShard`` arrays sorted by (hash, pos) and occurrence-filtered:
what artifacts save and load, and what the ``Classifier`` fills its
hash tables on the device from (``lookup.fill_hash_rows``).  On a CUDA
device each shard of at least 2^21 bases is sketched, sorted and
occurrence-filtered on the card and fetched; the rest of the build, and
every shard on a CPU device, runs on the host (a chunked sketch, a
stable argsort and the same filter on CPU tensors).  A multi-shard
build takes one thread per shard.

Both routes give bit-identical arrays.  As in the reference, a segment
whose selected minimizers overflow the compaction capacity (a
homopolymer-rich reference) sends its shard down the host route; the
routes are counted in :data:`BUILD_ROUTES`.  Under a profiler the phases
show as ``monica.build.*`` spans (``utils.metrics.span``).
"""

from __future__ import annotations

import hashlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from monica_tpu_torch._u32 import MASK32, i32_bits
from monica_tpu_torch.index import minimizer as mz
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.io import seq as seqio
from monica_tpu_torch.ops import lookup as lk
from monica_tpu_torch.utils.metrics import span

# a minimizer occurring more than OCC_CAP times in a shard is dropped
# wholesale (the minimap2 repetitive-seed cut); equal to the hash-row
# capacity so every kept run fits its row
OCC_CAP = lk.ROW_SLOTS
# packed lookup entries need pos<<1|strand plus >= MIN_TAG_BITS of tag
SHARD_CAP = 1 << 26
# records longer than this are segmented before packing
SEG_LEN = 1 << 25

# device sketch: segment length, per-segment entry capacity seg >> 2
# (~1.4x the expected 2/(w+1) winnowing density), and the shard size from
# which a multi-shard build sketches on the card
_DEV_SEG = 1 << 22
_DEV_CAP_SHIFT = 2
_DEV_MIN_SHARD = 1 << 21
_PAD = MASK32  # (hash, pos<<1|strand) of a pad entry: sorts after every real one

# device-build routes taken in this process: shards sketched and sorted
# on the card, and shards sent to the host by a segment's capacity overflow
BUILD_ROUTES = {"device_sketch_sort": 0, "overflow": 0}
_routes_lock = threading.Lock()


def _count_route(name: str) -> None:
    with _routes_lock:
        BUILD_ROUTES[name] += 1


def reset_build_routes() -> None:
    for name in BUILD_ROUTES:
        BUILD_ROUTES[name] = 0


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


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("index build on a CUDA device, but torch.cuda.is_available() is false")
    return device


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


# ---------------------------------------------------------------------------
# the build on the device: sketch and 2-key sort
# ---------------------------------------------------------------------------

def _sketch_segment(chunk: torch.Tensor, start_in_chunk: int, own_len: int, base: int,
                    k: int, w: int, frac: float, cap: int):
    """Sketch one overlap-extended segment and compact the minimizers it
    owns into ``cap`` slots -> (hash, pos<<1|strand, count), int64
    tensors on the chunk's device.  Slots past the owned entries hold
    pads; when count > cap the first cap entries are kept (the caller
    rejects that segment).  The compaction is a scatter into a spare
    slot, so nothing syncs with the host."""
    h, s = mz.kmer_hashes(chunk, k)
    keep = mz.select_minimizers(h, w, frac=frac)
    pos = torch.arange(keep.shape[0], device=chunk.device)
    own = keep & (pos >= start_in_chunk) & (pos < start_in_chunk + own_len)
    dest = torch.cumsum(own, 0) - 1
    ok = own & (dest < cap)
    dest = torch.where(ok, dest, cap)
    ps = ((pos + (base - start_in_chunk)) << 1) | s.to(torch.int64)
    out_h = torch.full((cap + 1,), _PAD, dtype=torch.int64, device=chunk.device)
    out_ps = torch.full((cap + 1,), _PAD, dtype=torch.int64, device=chunk.device)
    out_h.scatter_(0, dest, torch.where(ok, h, _PAD))
    out_ps.scatter_(0, dest, torch.where(ok, ps, _PAD))
    return out_h[:cap], out_ps[:cap], own.sum()


def _sort2(h: torch.Tensor, ps: torch.Tensor):
    """Sort (hash, pos<<1|strand) pairs by hash, then by the second key,
    both unsigned 32-bit values: one int64 key with the hash biased by
    2^31 so that the shift cannot overflow.  Pads (0xFFFFFFFF,
    0xFFFFFFFF) take the largest key and sort last, after a real entry
    whose hash is 0xFFFFFFFF."""
    key = torch.sort(((h - (1 << 31)) << 32) | ps).values
    return (key >> 32) + (1 << 31), key & MASK32


def _device_sketch_sort(codes: np.ndarray, k: int, w: int, frac: float, device):
    """Sketch and sort one packed reference of at least k bases on
    ``device``: (hash as int32 bit patterns, pos int64, strand uint8)
    tensors there, sorted by (hash, pos) as the host sketch and a stable
    argsort give them; or None when a segment overflows its compaction
    capacity (counted in BUILD_ROUTES["overflow"]).

    Each segment of _DEV_SEG bases, extended by 2w + k on both sides and
    padded with N to one length, is sketched and compacted to seg >> 2
    slots; the segments concatenate and one sort orders the pairs, the
    pads last, after the real entries.  The per-segment counts come back
    to the host in one transfer."""
    n = len(codes)
    seg = _DEV_SEG
    cap = seg >> _DEV_CAP_SHIFT
    overlap = 2 * w + k
    chunk_len = seg + 2 * overlap
    dev_codes = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(device)
    parts_h, parts_ps, counts = [], [], []
    for start in range(0, n - k + 1, seg):
        stop = min(n, start + seg)
        lo = max(0, start - overlap)
        hi = min(n, stop + overlap)
        chunk = torch.full((chunk_len,), enc.PAD_CODE, dtype=torch.uint8, device=device)
        chunk[: hi - lo] = dev_codes[lo:hi]
        hh, ps, count = _sketch_segment(chunk, start - lo, stop - start, start, k, w, frac, cap)
        parts_h.append(hh)
        parts_ps.append(ps)
        counts.append(count)
    counts = torch.stack(counts).tolist()
    if max(counts) > cap:
        _count_route("overflow")
        return None
    h_sorted, ps_sorted = _sort2(torch.cat(parts_h), torch.cat(parts_ps))
    _count_route("device_sketch_sort")
    total = sum(counts)
    ps = ps_sorted[:total]
    return i32_bits(h_sorted[:total]), ps >> 1, (ps & 1).to(torch.uint8)


def _occ_filter(h: torch.Tensor, *rest: torch.Tensor, occ_cap: int):
    """Drop equal-hash runs longer than occ_cap from hash-sorted tensors,
    on their device (occ_cap 0 keeps everything)."""
    n = h.shape[0]
    if not occ_cap or not n:
        return (h, *rest)
    idx = torch.arange(n, device=h.device)
    brk = h[1:] != h[:-1]
    one = torch.ones(1, dtype=torch.bool, device=h.device)
    run_start = torch.cummax(torch.where(torch.cat([one, brk]), idx, 0), 0).values
    last = torch.where(torch.cat([brk, one]), idx, n - 1)
    run_end = torch.cummin(last.flip(0), 0).values.flip(0)  # reverse cummin
    keep = run_end - run_start < occ_cap
    return tuple(a[keep] for a in (h, *rest))


def _on_device(device: torch.device) -> bool:
    """Whether a build on ``device`` takes the device route: on a CUDA
    device it does; the CPU device builds on the host."""
    return device.type == "cuda"


# ---------------------------------------------------------------------------
# genome bin-packing across shards
# ---------------------------------------------------------------------------

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


def _pack(members: list[int], units, guard: int):
    """Pack the member units into one code array -> (PackedSeqs, the
    per-position accession ids)."""
    builder = enc.PackedSeqsBuilder(guard=guard)
    for ui in members:
        gi, rec_codes = units[ui]
        builder.add(rec_codes, gi)
    packed = builder.build()
    if len(packed.codes) >= SHARD_CAP:
        raise ValueError(
            "index shard exceeds 64 Mbase; raise n_shards or lower max_shard_bytes"
        )
    pos_acc = np.zeros(max(len(packed.codes), 1), dtype=np.uint16)
    for s0, ln, aid in zip(packed.starts, packed.lengths, packed.seq_accession_id):
        pos_acc[s0 : s0 + ln] = aid
    return packed, pos_acc


def _build_shard(
    members: list[int],
    units: list[tuple[int, np.ndarray]],
    k: int,
    w: int,
    guard: int,
    frac: float,
    occ_cap: int,
    sketch_device: torch.device | None,
) -> IndexShard:
    """Pack the member units, sketch and sort by (hash, pos) (on
    ``sketch_device`` for a shard of at least _DEV_MIN_SHARD bases, on
    the host when it is None), filter by the occurrence cap where the
    sorted arrays are, fetch them, fill the per-position accession ids."""
    with span("build.pack", units=len(members)):
        packed, pos_acc = _pack(members, units, guard)
    mz = None
    if sketch_device is not None and len(packed.codes) >= _DEV_MIN_SHARD:
        with span("build.sketch_sort", bases=len(packed.codes)):
            mz = _device_sketch_sort(packed.codes, k, w, frac, sketch_device)
    if mz is None:
        with span("build.host_sketch_sort", bases=len(packed.codes)):
            h, pos, strand = sketch_long_sequence(packed.codes, k, w, frac=frac)
            order = np.argsort(h, kind="stable")
            mz = (torch.from_numpy(h[order].view(np.int32)), torch.from_numpy(pos[order]),
                  torch.from_numpy(strand[order]))
    with span("build.occ_filter"):
        h_s, pos_s, strand_s = _occ_filter(*mz, occ_cap=occ_cap)
    return IndexShard(
        ref_codes=packed.codes,
        seq_starts=packed.starts,
        seq_lengths=packed.lengths,
        seq_accession_id=packed.seq_accession_id,
        mz_hash=h_s.cpu().numpy().view(np.uint32),
        mz_pos=pos_s.to(torch.int32).cpu().numpy(),
        mz_strand=strand_s.cpu().numpy(),
        pos_accession_id=pos_acc,
    )


def _build_shards_threaded(assignment, units, k, w, guard, frac, occ_cap,
                           device: torch.device) -> list[IndexShard]:
    """Build the shards, one thread per shard (at most 8): _build_shard
    is pure, and the torch sketch and numpy's large array ops release
    the GIL, so the shards' sketch chains overlap.  Each shard is the
    same as from a serial build."""
    sketch_device = device if _on_device(device) else None
    if len(assignment) <= 1:
        return [_build_shard(m, units, k, w, guard, frac, occ_cap, sketch_device)
                for m in assignment]
    with ThreadPoolExecutor(max_workers=min(len(assignment), 8)) as pool:
        return list(pool.map(
            lambda m: _build_shard(m, units, k, w, guard, frac, occ_cap, sketch_device),
            assignment))


def _build(units, n_shards, max_shard_bytes, k, w, guard, frac, occ_cap, device):
    assignment = _assign_units(
        [len(u[1]) for u in units],
        n_shards if max_shard_bytes is None else None,
        max_shard_bytes,
    )
    return _build_shards_threaded(assignment, units, k, w, guard, frac, occ_cap,
                                  _check_device(device))


def build_index(
    genomes: list[tuple[str, list[str]]],
    n_shards: int = 1,
    max_shard_bytes: int | None = None,
    k: int = mz.K_DEFAULT,
    w: int = mz.W_DEFAULT,
    guard: int = 32,
    frac: float = mz.FRAC_DEFAULT,
    occ_cap: int = OCC_CAP,
    *,
    device,
) -> BuiltIndex:
    """Build a sharded index from genome FASTA files on ``device`` (see
    the module docstring); ``genomes`` is a list of (fasta_path,
    [species_name, accession]), and the accession id of a genome is its
    position in that list."""
    if not genomes:
        raise ValueError("build_index: empty genome set (nothing to index)")
    genome_lengths = np.zeros(len(genomes), dtype=np.int64)
    all_codes: list[list[np.ndarray]] = []
    with span("build.read", genomes=len(genomes)):
        for gi, (path, _hdr) in enumerate(genomes):
            recs = [enc.encode_seq(r.seq) for r in seqio.read_fasta(path)]
            all_codes.append(recs)
            genome_lengths[gi] = int(sum(len(r) for r in recs))
    with span("build.segment", genomes=len(genomes)):
        units = _segment_records(all_codes)
    if not units:
        raise ValueError("build_index: genomes contain no sequence records")
    meta = IndexMeta(
        tax_units=[g[1][0] for g in genomes],
        accessions=[g[1][1] for g in genomes],
        genome_lengths=genome_lengths,
        k=k, w=w, frac=frac, occ_cap=occ_cap,
    )
    return BuiltIndex(meta=meta, shards=_build(units, n_shards, max_shard_bytes, k, w, guard,
                                               frac, occ_cap, device))


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
    *,
    device,
) -> BuiltIndex:
    """Build an index on ``device`` directly from uint8 code arrays (one
    per genome)."""
    if not seqs:
        raise ValueError("build_index_from_arrays: empty genome set")
    n = len(seqs)
    meta = IndexMeta(
        tax_units=tax_units or [f"Species_{i}" for i in range(n)],
        accessions=accessions or [f"ACC{i:04d}.1" for i in range(n)],
        genome_lengths=np.array([len(s) for s in seqs], dtype=np.int64),
        k=k, w=w, frac=frac, occ_cap=occ_cap,
    )
    with span("build.segment", genomes=n):
        units = _segment_records([[np.asarray(s, dtype=np.uint8)] for s in seqs])
    return BuiltIndex(meta=meta, shards=_build(units, n_shards, max_shard_bytes, k, w, guard,
                                               frac, occ_cap, device))


def merge_built(parts: list[BuiltIndex]) -> BuiltIndex:
    """Combine independently built or cached index groups (guests,
    hosts) into one index, re-basing accession ids per part."""
    parts = [p for p in parts if p is not None]
    if len(parts) == 1:
        return parts[0]
    k, w, frac = parts[0].meta.k, parts[0].meta.w, parts[0].meta.frac
    for p in parts:
        if (p.meta.k, p.meta.w, p.meta.frac) != (k, w, frac):
            raise ValueError("cannot merge indexes with different k/w/frac")
    tax_units, accessions, lengths, shards = [], [], [], []
    base = 0
    for p in parts:
        tax_units += p.meta.tax_units
        accessions += p.meta.accessions
        lengths.append(p.meta.genome_lengths)
        for sh in p.shards:
            if base + p.meta.n_accessions > np.iinfo(np.uint16).max:
                raise ValueError("merged index exceeds 65535 accessions")
            shards.append(IndexShard(
                ref_codes=sh.ref_codes,
                seq_starts=sh.seq_starts,
                seq_lengths=sh.seq_lengths,
                seq_accession_id=sh.seq_accession_id + base,
                mz_hash=sh.mz_hash,
                mz_pos=sh.mz_pos,
                mz_strand=sh.mz_strand,
                pos_accession_id=(sh.pos_accession_id.astype(np.int32) + base).astype(np.uint16),
            ))
        base += p.meta.n_accessions
    meta = IndexMeta(
        tax_units=tax_units,
        accessions=accessions,
        genome_lengths=np.concatenate(lengths) if lengths else np.zeros(0, np.int64),
        k=k, w=w, frac=frac,
        occ_cap=parts[0].meta.occ_cap,
    )
    return BuiltIndex(meta=meta, shards=shards)


def content_key(
    genomes: list[tuple[str, list[str]]], k: int, w: int, n_shards: int,
    frac: float = mz.FRAC_DEFAULT,
) -> str:
    """Content-addressed artifact key: the build parameters, each
    genome's header and its file size."""
    hsh = hashlib.sha256()
    hsh.update(f"k={k},w={w},shards={n_shards},frac={frac}".encode())
    for path, hdr in genomes:
        hsh.update("|".join(hdr).encode())
        try:
            hsh.update(str(os.path.getsize(path)).encode())
        except OSError:
            pass
    return hsh.hexdigest()[:16]

"""Seed lookup on torch tensors — counterpart of
``monica_tpu/ops/lookup.py``.

Same direct-addressed bucketed hash table: 2^rbits rows indexed by the
TOP rbits of the minimizer hash, ROW_SLOTS packed entries per row
``(tag << payload_bits) | (pos << 1) | strand`` with the LOW tag_bits
of the hash as the verification tag, 0 = empty slot.  One row gather
per seed.  The table is stored as the int32 bit pattern of the
reference's uint32 entries (4 B/entry on the device) and widened to
int64 u32 values after the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from monica_tpu_torch._u32 import u32
from monica_tpu_torch.index.minimizer import INVALID_HASH

DIAG_SHIFT = 8  # 256-base diagonal bins
INVALID_KEY = 1 << 30
ROW_SLOTS = 8  # entries per hash-table row
MIN_TAG_BITS = 5  # shard size cap 2^26 bases (pos<<1|strand in 27 bits)


def tag_bits_for(ref_len: int) -> int:
    """Tag width for a shard: the bits the (pos << 1 | strand) payload
    does not need."""
    payload_bits = 1 + max(int(np.ceil(np.log2(max(ref_len, 2)))), 1)
    tb = 32 - payload_bits
    if tb < MIN_TAG_BITS:
        raise ValueError(
            f"shard of {ref_len} bases leaves only {tb} tag bits "
            f"(< {MIN_TAG_BITS}); raise n_shards / lower max_shard_bytes"
        )
    return tb


def pack_entries(mz_hash, mz_pos, mz_strand, tag_bits: int) -> np.ndarray:
    """Host-side: parallel arrays -> packed uint32 entries."""
    payload_bits = 32 - tag_bits
    tag = mz_hash.astype(np.uint32) & np.uint32((1 << tag_bits) - 1)
    ps = (mz_pos.astype(np.uint32) << 1) | mz_strand.astype(np.uint32)
    if len(mz_pos) and int(mz_pos.max()) >= 1 << (payload_bits - 1):
        raise ValueError("positions overflow payload bits")
    return ((tag << np.uint32(payload_bits)) | ps).astype(np.uint32)


def row_bits_for(n_entries: int) -> int:
    """rows = 2^rbits with load factor n/2^rbits in (1, 2]."""
    return max(int(np.ceil(np.log2(max(n_entries, 2)))) - 1, 1)


def build_hash_rows(
    mz_hash, mz_pos, mz_strand, tag_bits: int, rbits: int | None = None
) -> np.ndarray:
    """Host-side: hash-SORTED parallel arrays -> (2^rbits, ROW_SLOTS)
    uint32 table; entries beyond ROW_SLOTS per row are dropped."""
    rbits = rbits if rbits is not None else row_bits_for(len(mz_hash))
    n_rows = 1 << rbits
    table = np.zeros((n_rows, ROW_SLOTS), dtype=np.uint32)
    if not len(mz_hash):
        return table
    entries = pack_entries(mz_hash, mz_pos, mz_strand, tag_bits)
    row = (mz_hash.astype(np.uint64) >> np.uint64(32 - rbits)).astype(np.int64)
    first = np.searchsorted(row, np.arange(n_rows, dtype=np.int64))
    rank = np.arange(len(row)) - first[row]
    keep = rank < ROW_SLOTS
    table[row[keep], rank[keep]] = entries[keep]
    return table


def lookup_anchors(
    mz_rows: torch.Tensor,  # ([G,] R, ROW_SLOTS) int32 bit pattern of u32 entries
    q_hash: torch.Tensor,  # (B, S) int64 u32-valued read minimizer hashes
    q_pos: torch.Tensor,  # (B, S) int32
    q_strand: torch.Tensor,  # (B, S) bool
    q_valid: torch.Tensor,  # (B, S) bool
    tag_bits: int,
    bucket_len: int = 0,
    anchors_per_seed: int = 0,
):
    """Per-read anchors with packed chain keys; each output (B, S*A)
    int32 with A = anchors_per_seed (or ROW_SLOTS when 0):
    key (packed (strand, diag bin), INVALID_KEY when unused), diag,
    read_pos, ref_pos.  A stack of tables (G, R, ROW_SLOTS) that share
    ``tag_bits`` (``pipeline.stack_device_shards``) takes one gather for
    all G and gives (G, B, S*A) outputs, each table's anchors as it
    alone would give them.

    The verified-hits-first compaction sorts each row's entries
    descending AS UNSIGNED values: the tag sits in the top bits, so a
    signed int32 sort would rank every entry with a tag >= 2^31 below
    the empty 0 slots and drop real hits.  The sort runs on the
    int64-held u32 values."""
    B, S = q_hash.shape
    stack = mz_rows.shape[:-2]
    rbits = int(np.log2(mz_rows.shape[-2]))
    payload_bits = 32 - tag_bits

    row = q_hash >> (32 - rbits)
    e = u32(mz_rows[..., row, :])  # ([G,] B, S, ROW_SLOTS): the one gather per seed

    qtag = (q_hash & ((1 << tag_bits) - 1))[..., None]
    seed_ok = q_valid & (q_hash != INVALID_HASH)
    ps = e & ((1 << payload_bits) - 1)
    hit_ok = seed_ok[..., None] & ((e >> payload_bits) == qtag) & (ps != 0)

    if anchors_per_seed and anchors_per_seed < ROW_SLOTS:
        masked = torch.where(hit_ok, e, 0)
        e = torch.sort(masked, dim=-1, descending=True).values[..., :anchors_per_seed]
        ps = e & ((1 << payload_bits) - 1)
        hit_ok = e != 0

    ps = ps.to(torch.int32)
    ref_pos = ps >> 1
    ref_strand = (ps & 1).to(torch.bool)
    rc = q_strand[..., None] ^ ref_strand
    rp = q_pos[..., None]
    diag = torch.where(rc, ref_pos + rp, ref_pos - rp)
    dbin = (diag + bucket_len) >> DIAG_SHIFT
    key = torch.where(hit_ok, (rc.to(torch.int32) << 24) | dbin, INVALID_KEY)

    shape = (*stack, B, S * key.shape[-1])
    return (
        key.reshape(shape),
        diag.reshape(shape),
        rp.expand(rc.shape).reshape(shape),
        ref_pos.reshape(shape),
    )

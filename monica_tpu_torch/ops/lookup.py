"""Seed lookup on torch tensors — counterpart of
``monica_tpu/ops/lookup.py``.

Same direct-addressed bucketed hash table: 2^rbits rows indexed by the
TOP rbits of the minimizer hash, ROW_SLOTS packed entries per row
``(tag << payload_bits) | (pos << 1) | strand`` with the LOW tag_bits
of the hash as the verification tag, 0 = empty slot, filled on the
device by ``fill_hash_rows``.  One row gather per seed.  The table is
stored as the int32 bit pattern of the reference's uint32 entries
(4 B/entry on the device) and widened to int64 u32 values after the
gather.
"""

from __future__ import annotations

import numpy as np
import torch

from monica_tpu_torch._u32 import i32_bits, u32
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


def row_bits_for(n_entries: int) -> int:
    """rows = 2^rbits with load factor n/2^rbits in (1, 2]."""
    return max(int(np.ceil(np.log2(max(n_entries, 2)))) - 1, 1)


def fill_hash_rows(mz_hash: torch.Tensor, mz_pos: torch.Tensor, mz_strand: torch.Tensor,
                   tag_bits: int, rbits: int) -> torch.Tensor:
    """A shard's hash-SORTED parallel arrays (hash as u32 values or
    their int32 bit pattern, pos, strand) -> its (2^rbits, ROW_SLOTS)
    table of int32 entry bit patterns, on the arrays' device.  Each
    entry goes to row = top rbits of its hash at its rank in that row;
    ranks past ROW_SLOTS go to a spare row that is dropped.  The only
    writer of the entry format that ``lookup_anchors`` reads."""
    payload_bits = 32 - tag_bits
    n_rows = 1 << rbits
    dev = mz_hash.device
    table = torch.zeros((n_rows + 1, ROW_SLOTS), dtype=torch.int32, device=dev)
    if mz_hash.shape[0]:
        pos = mz_pos.to(torch.int64)
        if int(pos.max()) >= 1 << (payload_bits - 1):
            raise ValueError("positions overflow payload bits")
        h = u32(mz_hash)
        row = h >> (32 - rbits)
        first = torch.searchsorted(row, torch.arange(n_rows, device=dev))
        rank = torch.arange(row.shape[0], device=dev) - first[row]
        ok = rank < ROW_SLOTS
        entries = (((h & ((1 << tag_bits) - 1)) << payload_bits) | (pos << 1)
                   | mz_strand.to(torch.int64))
        table.index_put_((torch.where(ok, row, n_rows), torch.where(ok, rank, 0)),
                         i32_bits(entries))
    return table[:n_rows]


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

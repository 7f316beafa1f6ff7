"""Carry the reference's state across to the port.

Takes the JAX package's objects duck-typed — every array field is read
through ``np.asarray`` — so this module never imports jax; a caller
holding jax arrays converts them by the same ``np.asarray``.  Used to
classify with both packages against the very same index.
"""

from __future__ import annotations

import numpy as np
import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import BuiltIndex, IndexMeta, IndexShard
from monica_tpu_torch.stats.abundance import AbundanceState

_SHARD_FIELDS = (
    "ref_codes", "seq_starts", "seq_lengths", "seq_accession_id",
    "mz_hash", "mz_pos", "mz_strand", "pos_accession_id",
)
_IMPL = {"pallas": "cuda", "jnp": "torch", "auto": "auto"}


def built_from_reference(ref_built) -> BuiltIndex:
    """A reference ``BuiltIndex`` (host shards) -> the port's."""
    m = ref_built.meta
    meta = IndexMeta(
        tax_units=list(m.tax_units),
        accessions=list(m.accessions),
        genome_lengths=np.asarray(m.genome_lengths),
        k=m.k, w=m.w, frac=m.frac, occ_cap=m.occ_cap,
    )
    shards = [
        IndexShard(**{f: np.asarray(getattr(s, f)) for f in _SHARD_FIELDS})
        for s in ref_built.shards
    ]
    return BuiltIndex(meta=meta, shards=shards)


def device_shard_from_reference(mz_rows, pos_acc, ref_codes, device) -> pl.DeviceIndexShard:
    """The three arrays of a reference ``DeviceIndexShard`` (uint32
    table, uint16 pos_acc, uint8 codes) -> the port's on ``device``."""
    return pl.index_tensors(np.asarray(mz_rows), np.asarray(pos_acc),
                            np.asarray(ref_codes), device)


def groups_from_reference(ref_groups, device) -> tuple[pl.DeviceIndexShard, ...]:
    """The reference's stacked size-class groups (``stack_device_shard_groups``:
    uint32 tables, uint16 pos_acc, uint8 codes, each with a leading shard
    axis) -> the port's stacked groups on ``device``."""
    return tuple(
        pl.DeviceIndexShard(
            mz_rows=torch.from_numpy(np.array(g.mz_rows, dtype=np.uint32).view(np.int32)).to(device),
            pos_acc=torch.from_numpy(np.array(g.pos_acc, dtype=np.int32)).to(device),
            ref_codes=torch.from_numpy(np.array(g.ref_codes, dtype=np.uint8)).to(device),
        )
        for g in ref_groups
    )


def state_from_reference(ref_state) -> AbundanceState:
    """A reference ``AbundanceState`` -> the port's (copies)."""
    return AbundanceState(ref_state.n_accessions,
                          {k: np.array(v, dtype=np.int64) for k, v in ref_state.samples.items()})


def params_from_reference(ref_params) -> pl.ClassifyParams:
    """Reference ``ClassifyParams`` -> the port's; ``extend_impl``
    maps "pallas" -> "cuda" and "jnp" -> "torch"."""
    d = ref_params._asdict()
    d["extend_impl"] = _IMPL[d["extend_impl"]]
    return pl.ClassifyParams(**d)

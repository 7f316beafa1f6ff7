"""Index artifacts and the cache registry — counterpart of
``monica_tpu/index/artifact.py``, in the same on-disk format, so an
index saved by either package loads in the other.

An artifact is a folder: one uncompressed ``.npy`` per shard array,
named by a per-save run id, and a ``manifest.json`` (format
``monica_tpu.index.v2``) that names the run id and carries the metadata.
The manifest is written last and flipped into place atomically, so at
every instant it names a complete set of files: a crash mid-save leaves
the previous index loadable, and the next successful save removes the
orphans.  Loading memory-maps the arrays; a v1 artifact (one ``.npz`` per
shard) and a v2 manifest without a run id (unversioned file names) load
too.  Folders outside the root are registered in ``.outside_indexes``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from monica_tpu_torch.index.build import BuiltIndex, IndexMeta, IndexShard

MANIFEST = "manifest.json"
OUTSIDE_REGISTRY = ".outside_indexes"
FORMAT_V1 = "monica_tpu.index.v1"
FORMAT_V2 = "monica_tpu.index.v2"

_SHARD_FIELDS = (
    "ref_codes",
    "seq_starts",
    "seq_lengths",
    "seq_accession_id",
    "mz_hash",
    "mz_pos",
    "mz_strand",
    "pos_accession_id",
)


def save_index(index: BuiltIndex, folder: str | os.PathLike) -> Path:
    """Write ``index`` to ``folder`` (v2: one .npy per shard array, then
    the manifest flip, then the removal of files the manifest does not
    name)."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    meta = index.meta
    runid = os.urandom(4).hex()
    manifest = {
        "format": FORMAT_V2,
        "runid": runid,
        "k": meta.k,
        "w": meta.w,
        "frac": meta.frac,
        "occ_cap": meta.occ_cap,
        "n_shards": len(index.shards),
        "tax_units": meta.tax_units,
        "accessions": meta.accessions,
        "genome_lengths": [int(x) for x in meta.genome_lengths],
    }
    live: set[str] = set()
    for i, sh in enumerate(index.shards):
        for name in _SHARD_FIELDS:
            fname = f"shard{i}.{name}.{runid}.npy"
            live.add(fname)
            np.save(folder / fname, getattr(sh, name))
    tmp = folder / (MANIFEST + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, folder / MANIFEST)
    for old in folder.glob("shard*"):
        if old.name not in live:
            old.unlink(missing_ok=True)
    return folder


def load_index(folder: str | os.PathLike) -> BuiltIndex:
    """Load a v2 (memory-mapped .npy) or v1 (.npz) artifact."""
    folder = Path(folder)
    with open(folder / MANIFEST) as fh:
        manifest = json.load(fh)
    fmt = manifest.get("format")
    if fmt not in (FORMAT_V1, FORMAT_V2):
        raise ValueError(f"not a monica_tpu index: {folder}")
    meta = IndexMeta(
        tax_units=manifest["tax_units"],
        accessions=manifest["accessions"],
        genome_lengths=np.asarray(manifest["genome_lengths"], dtype=np.int64),
        k=manifest["k"],
        w=manifest["w"],
        frac=manifest.get("frac", 1.0),
        occ_cap=manifest.get("occ_cap", 0),
    )
    runid = manifest.get("runid")
    suffix = f".{runid}.npy" if runid else ".npy"
    shards = []
    for i in range(manifest["n_shards"]):
        if fmt == FORMAT_V2:
            arrays = {name: np.load(folder / f"shard{i}.{name}{suffix}", mmap_mode="r")
                      for name in _SHARD_FIELDS}
        else:
            z = np.load(folder / f"shard{i}.npz")
            arrays = {name: z[name] for name in _SHARD_FIELDS}
        shards.append(IndexShard(**arrays))
    return BuiltIndex(meta=meta, shards=shards)


def is_index_dir(folder: str | os.PathLike) -> bool:
    return (Path(folder) / MANIFEST).exists()


def list_indexes(indexes_path: Path, root: Path) -> list[Path]:
    """Every known index folder: those under the root's ``indexes/``,
    sorted, then those registered in ``.outside_indexes``."""
    out = []
    if indexes_path.exists():
        for child in sorted(indexes_path.iterdir()):
            if child.is_dir() and is_index_dir(child):
                out.append(child)
    reg = root / OUTSIDE_REGISTRY
    if reg.exists():
        for line in reg.read_text().splitlines():
            line = line.strip()
            if line and is_index_dir(line):
                out.append(Path(line))
    return out


def register_outside_index(root: Path, folder: str | os.PathLike) -> None:
    """Record an index folder that lives outside the root."""
    reg = root / OUTSIDE_REGISTRY
    existing = set()
    if reg.exists():
        existing = {l.strip() for l in reg.read_text().splitlines() if l.strip()}
    folder = str(Path(folder).absolute())
    if folder not in existing:
        with open(reg, "a") as fh:
            fh.write(folder + "\n")

"""Self-contained NCBI taxonomy — counterpart of
``monica_tpu/data/taxonomy.py``: name -> taxid, descendants, lineages and
virus detection over the NCBI taxdump ``nodes.dmp``/``names.dmp``
format, cached as a compact npz in the same format as the JAX
package's, with a 14-day refresh from TAXDUMP_URL through an injectable
transport.  :func:`Taxonomy.from_edges` builds small fixture
taxonomies.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

VIRUSES_TAXID = 10239
TAXDUMP_URL = "https://ftp.ncbi.nlm.nih.gov/pub/taxonomy/taxdump.tar.gz"
REFRESH_DAYS = 14  # reference NCBI_TAXA_DAYS_THRESHOLD (fetcher.py:24)
CACHE_FILE = "taxonomy.npz"


@dataclass
class Taxonomy:
    parent: dict[int, int]
    names: dict[int, str]  # taxid -> scientific name
    name_index: dict[str, list[int]] = field(default_factory=dict)
    _children: dict[int, list[int]] | None = None

    def __post_init__(self):
        if not self.name_index:
            idx: dict[str, list[int]] = {}
            for tid, nm in self.names.items():
                idx.setdefault(nm.lower(), []).append(tid)
            self.name_index = idx

    # -- ete3-equivalent queries ------------------------------------------
    def name_to_taxids(self, name: str) -> list[int]:
        """get_name_translator analog (case-insensitive)."""
        return list(self.name_index.get(name.lower(), []))

    def children(self, taxid: int) -> list[int]:
        if self._children is None:
            ch: dict[int, list[int]] = {}
            for t, p in self.parent.items():
                if t != p:
                    ch.setdefault(p, []).append(t)
            self._children = ch
        return self._children.get(taxid, [])

    def descendants(self, taxid: int) -> list[int]:
        """All strict descendant taxids (get_descendant_taxa analog)."""
        out, stack = [], list(self.children(taxid))
        while stack:
            t = stack.pop()
            out.append(t)
            stack.extend(self.children(t))
        return out

    def lineage(self, taxid: int) -> list[int]:
        """Root-to-node taxid path (get_lineage analog)."""
        path = [taxid]
        seen = {taxid}
        while True:
            p = self.parent.get(path[-1])
            if p is None or p in seen:
                break
            path.append(p)
            seen.add(p)
        return path[::-1]

    def is_virus(self, species: str) -> bool:
        """True if any taxid for the name descends from Viruses
        (reference `is_virus`, fetcher.py:321-326)."""
        return any(
            VIRUSES_TAXID in self.lineage(t) for t in self.name_to_taxids(species)
        )

    # -- construction -------------------------------------------------------
    @classmethod
    def from_edges(cls, edges: list[tuple[int, int]], names: dict[int, str]) -> "Taxonomy":
        """Fixture builder: edges are (child, parent)."""
        return cls(parent=dict(edges), names=dict(names))

    @classmethod
    def from_taxdump(cls, nodes_path, names_path) -> "Taxonomy":
        """Parse NCBI taxdump dmp files (pipe-delimited)."""
        parent: dict[int, int] = {}
        with open(nodes_path) as fh:
            for line in fh:
                f = [c.strip() for c in line.split("|")]
                parent[int(f[0])] = int(f[1])
        names: dict[int, str] = {}
        with open(names_path) as fh:
            for line in fh:
                f = [c.strip() for c in line.split("|")]
                if f[3] == "scientific name":
                    names[int(f[0])] = f[1]
        return cls(parent=parent, names=names)

    # -- cache ---------------------------------------------------------------
    def save(self, folder: str | os.PathLike) -> None:
        folder = Path(folder)
        folder.mkdir(parents=True, exist_ok=True)
        tids = np.fromiter(self.parent.keys(), dtype=np.int64)
        pids = np.fromiter((self.parent[t] for t in tids), dtype=np.int64)
        ntids = np.fromiter(self.names.keys(), dtype=np.int64)
        nvals = np.asarray([self.names[int(t)] for t in ntids], dtype=object)
        np.savez_compressed(
            folder / CACHE_FILE, tids=tids, pids=pids, ntids=ntids, nvals=nvals
        )

    @classmethod
    def load(cls, folder: str | os.PathLike) -> "Taxonomy | None":
        path = Path(folder) / CACHE_FILE
        if not path.exists():
            return None
        z = np.load(path, allow_pickle=True)
        parent = dict(zip(z["tids"].tolist(), z["pids"].tolist()))
        names = {int(t): str(n) for t, n in zip(z["ntids"], z["nvals"])}
        return cls(parent=parent, names=names)

    @classmethod
    def cache_fresh(cls, folder: str | os.PathLike, days: float = REFRESH_DAYS) -> bool:
        path = Path(folder) / CACHE_FILE
        return path.exists() and (time.time() - path.stat().st_mtime) < days * 86400

    @classmethod
    def from_tarball(cls, tar_path: str | os.PathLike) -> "Taxonomy":
        """Build from an NCBI ``taxdump.tar.gz`` (contains nodes.dmp +
        names.dmp) — the payload behind TAXDUMP_URL."""
        import tarfile
        import tempfile

        with tarfile.open(tar_path, "r:*") as tar, tempfile.TemporaryDirectory() as td:
            for member in ("nodes.dmp", "names.dmp"):
                tar.extract(member, td, filter="data")
            return cls.from_taxdump(Path(td) / "nodes.dmp", Path(td) / "names.dmp")

    @classmethod
    def ensure(
        cls,
        folder: str | os.PathLike,
        downloader=None,
        refresh_days: float = REFRESH_DAYS,
    ) -> "Taxonomy | None":
        """Fresh cached taxonomy, auto-refreshed from TAXDUMP_URL when
        the cache is older than ``refresh_days`` (the reference's
        14-day ete3 refresh, `fetcher.py:23-24,298-307`).  A failed
        refresh (offline transport, air-gapped host) falls back to the
        stale cache with a warning; returns None only when there is no
        cache at all and no way to fetch one."""
        import tempfile

        if cls.cache_fresh(folder, refresh_days):
            return cls.load(folder)
        if downloader is not None:
            try:
                with tempfile.NamedTemporaryFile(suffix=".tar.gz") as tmp:
                    downloader(TAXDUMP_URL, tmp.name)
                    tax = cls.from_tarball(tmp.name)
                tax.save(folder)
                return tax
            except Exception as e:
                if (Path(folder) / CACHE_FILE).exists():
                    print(f"taxonomy refresh failed ({e}); using stale cache")
        return cls.load(folder)


def descendants_taxid_finder(taxonomy: Taxonomy, species: list[str],
                             focus: bool = False) -> tuple[list[str], str]:
    """Species names -> (their taxids and every descendant taxid, as
    strings, in order; the column they join on: 'taxid', or
    'species_taxid' in focus mode)."""
    out: list[str] = []
    for sp in species:
        for t in taxonomy.name_to_taxids(sp):
            out.append(str(t))
            out.extend(str(d) for d in taxonomy.descendants(t))
    return out, "species_taxid" if focus else "taxid"

"""Genome selection (4 modes) and download with a persistent cache —
counterpart of ``monica_tpu/data/fetcher.py``, without pandas.

* :func:`ftp_selector` joins the species (and all their taxonomic
  descendants) against an NCBI assembly summary and derives
  ``species_name`` per mode: ``overnight`` (RefSeq, the PARENTS kingdoms,
  one assembly per genus), ``all`` (GenBank, every assembly), ``single``
  (RefSeq, one assembly per species, viruses matched on the full name
  and appended after the cellular species) and ``focus`` (GenBank joined
  on ``species_taxid``, strain-level names).  Every mode rewrites
  ``ftp_path`` to the ``*_genomic.fna.gz`` file.
* :func:`fetcher` / :func:`focus_fetcher` download each selected genome
  once into an ``oldies/`` cache, reuse cached and pre-downloaded
  copies, evict superseded assembly versions, and return ``(genomes,
  updated)``, the genomes as ``(path, [species_name, accession])`` in
  selection order.

The selection is a list of row dicts (see :mod:`.tables`) in the order
the JAX package's DataFrame holds its rows, because a genome's position
in it is its accession id in the index: the join keeps the summary's
row order and repeats a row once per matching taxid (an inner
``merge``), and ``drop_duplicates(keep="last")`` keeps the last row of
each name where it stands.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from monica_tpu_torch.data import tables
from monica_tpu_torch.data.taxonomy import Taxonomy, descendants_taxid_finder

PARENTS = [
    "Fungi", "Oomycota", "Bacteria", "Archaea", "Viruses",
    "Nematodes", "Rhizaria", "Alveolata", "Heterokonta",
]


def _join(table: list[dict], found: tuple[list[str], str]) -> list[dict]:
    """Inner join of the summary rows on one column against a taxid
    list: rows in table order, each once per equal taxid in the list;
    each output row is a copy."""
    taxids, column = found
    times: dict[str, int] = {}
    for t in taxids:
        times[t] = times.get(t, 0) + 1
    return [dict(row) for row in table for _ in range(times.get(row[column], 0))]


def _drop_duplicates(rows: list[dict], key: str) -> list[dict]:
    """Keep the last row of each ``key`` value, in row order."""
    last = {row[key]: i for i, row in enumerate(rows)}
    return [row for i, row in enumerate(rows) if last[row[key]] == i]


def _genomic_fna_urls(rows: list[dict]) -> list[dict]:
    for row in rows:
        ftp = "nan" if row["ftp_path"] is None else row["ftp_path"]
        row["ftp_path"] = f"{ftp}/{ftp.rsplit('/', 1)[-1]}_genomic.fna.gz"
    return rows


def _species_name_single(name: str) -> str:
    parts = name.split(" ")
    if len(parts) >= 3 and parts[1] == "sp.":
        return "_".join(parts[0:2]) + parts[2]
    return "_".join(parts[0:2])


def _species_name_focus(name: str, strain) -> str:
    if isinstance(strain, str) and "=" in strain:
        strain_val = strain.split("=", 1)[1]
        if not name.endswith(strain_val):
            name = name.replace(".", "") + " " + strain_val
        else:
            name = name.replace(strain_val, "").replace(".", "") + strain_val
    return name.replace(" ", "_")


def ftp_selector(
    mode: str,
    species: list[str],
    taxonomy: Taxonomy,
    tables_dir: str | os.PathLike,
    downloader: tables.Downloader = tables.urllib_downloader,
) -> list[dict]:
    """Selection rows, each with ``species_name`` and a downloadable
    ``ftp_path``."""
    if mode == "overnight":
        table = tables.importer(tables_dir, "refseq", downloader)
        merged = _join(table, descendants_taxid_finder(taxonomy, PARENTS))
        for row in merged:
            parts = row["organism_name"].split(" ")
            row["genera"] = parts[0]
            row["species_name"] = "_".join(parts[0:2])
        merged = _drop_duplicates(merged, "genera")

    elif not species:
        raise ValueError("no species specified — did you mean overnight mode?")

    elif mode == "all":
        table = tables.importer(tables_dir, "genbank", downloader)
        merged = _join(table, descendants_taxid_finder(taxonomy, species))
        for row in merged:
            row["species_name"] = "_".join(row["organism_name"].split(" "))

    elif mode == "single":
        vir = [s for s in species if taxonomy.is_virus(s)]
        cell = [s for s in species if not taxonomy.is_virus(s)]
        table = tables.importer(tables_dir, "refseq", downloader)
        merged = _join(table, descendants_taxid_finder(taxonomy, cell))
        for row in merged:
            row["species_name"] = _species_name_single(row["organism_name"])
        merged = _drop_duplicates(merged, "species_name")
        if vir:
            vmerged = _join(table, descendants_taxid_finder(taxonomy, vir))
            for row in vmerged:
                row["species_name"] = "_".join(row["organism_name"].split(" "))
            merged += _drop_duplicates(vmerged, "species_name")

    elif mode == "focus":
        table = tables.importer(tables_dir, "genbank", downloader)
        merged = _join(table, descendants_taxid_finder(taxonomy, species, focus=True))
        for row in merged:
            row["species_name"] = _species_name_focus(row["organism_name"],
                                                      row["infraspecific_name"])
        merged = _drop_duplicates(merged, "species_name")

    else:
        raise ValueError(f"unknown selection mode: {mode!r}")

    return _genomic_fna_urls(merged)


# ---------------------------------------------------------------------------
# genome download + cache
# ---------------------------------------------------------------------------

def _accession_suffix(accession: str) -> str:
    """'GCF_000005845.2' -> '000005845.2' (the cache file name scheme)."""
    return accession.split("_", 1)[-1]


def _strip_version(stem: str) -> str:
    """Cache-file stem without the trailing assembly version."""
    return stem.rsplit(".", 1)[0] if "." in stem else stem


def _download_with_retry(downloader, url, out, retries: int, backoff_s: float) -> bool:
    for attempt in range(retries + 1):
        try:
            downloader(url, out)
            return True
        except Exception as e:  # noqa: BLE001 — any transport failure: retry then skip
            if attempt == retries:
                print(f"[monica_tpu_torch] {url} failed download ({e})")
                return False
            time.sleep(backoff_s * (2**attempt))
    return False


def fetcher(
    table: list[dict],
    genomes_dir: str | os.PathLike,
    keep_genomes: bool = True,
    format_genomes: str | os.PathLike | None = None,
    downloader: tables.Downloader = tables.urllib_downloader,
    retries: int = 2,
    backoff_s: float = 1.0,
    species_name_for_file=None,
):
    """Materialize every selected genome locally.

    Returns (genomes, updated): genomes = [(path, [species_name,
    accession_suffix])] in selection order, updated = True iff anything
    new was fetched (an index built from the old set is stale)."""
    genomes_dir = Path(genomes_dir)
    oldies = genomes_dir / "oldies"
    oldies.mkdir(parents=True, exist_ok=True)
    preformatted = {}
    if format_genomes:
        preformatted = {
            p.name: p for p in Path(format_genomes).iterdir() if p.name.endswith("fna.gz")
        }

    old = {p.name for p in oldies.iterdir() if p.name.endswith("fna.gz")}
    genomes, new_stems = [], []
    updated = False

    for row in table:
        url = row["ftp_path"]
        sp_name = row["species_name"]
        sp_name_file = (species_name_for_file(sp_name) if species_name_for_file is not None
                        else sp_name)
        acc = _accession_suffix(row["# assembly_accession"])
        header = [sp_name, acc]
        fname = f"{sp_name_file}_{acc}.fna.gz"

        if fname in old:
            genomes.append((str(oldies / fname), header))
            old.discard(fname)
            continue
        src_name = url.rsplit("/", 1)[-1]
        if src_name in preformatted:
            genomes.append((str(preformatted[src_name]), header))
            continue
        dest = (oldies if keep_genomes else genomes_dir) / fname
        if _download_with_retry(downloader, url, str(dest), retries, backoff_s):
            genomes.append((str(dest), header))
            new_stems.append(_strip_version(fname[: -len(".fna.gz")]))
            updated = True

    oldies_cleaner(new_stems, old, oldies)
    return genomes, updated


def focus_fetcher(
    table: list[dict],
    genomes_dir: str | os.PathLike,
    keep_genomes: bool = True,
    downloader: tables.Downloader = tables.urllib_downloader,
    retries: int = 2,
):
    """Strain-level fetch for the focus second pass: cache files are
    keyed by the species-level name ("Genus_species_<acc>") while the
    headers keep the full strain name."""
    return fetcher(
        table,
        genomes_dir,
        keep_genomes=keep_genomes,
        downloader=downloader,
        retries=retries,
        species_name_for_file=lambda sp: "_".join(sp.split("_")[0:2]),
    )


def oldies_cleaner(new_stems: list[str], leftover_old: set[str], oldies: Path) -> None:
    """Evict cached genomes superseded by a new assembly version."""
    for fname in leftover_old:
        stem = _strip_version(fname[: -len(".fna.gz")])
        if stem in new_stems:
            (oldies / fname).unlink(missing_ok=True)
            print(f"[monica_tpu_torch] removing {fname}, new version found")

"""NCBI assembly-summary tables: fetch, TTL cache, import — counterpart
of ``monica_tpu/data/tables.py``, without pandas.

The RefSeq and GenBank ``assembly_summary`` TSVs come through an
injectable transport (``downloader``) into a cache folder, fresh for
:data:`TTL_DAYS` by file mtime.  :func:`importer` reads the seven
columns the selection uses into a list of row dicts, in file order,
each value a ``str`` or ``None`` where the cell is missing.  Missing is
what pandas' ``read_csv(dtype="str")`` makes missing, which the JAX
package's reader is: an empty cell, one of pandas' default NA strings
(``NA``, ``N/A``, ``nan``, ``null``, ``None``, ...), or a cell past the
end of a short row.  The fixture value ``na`` is a string.
"""

from __future__ import annotations

import csv
import os
import shutil
import time
import urllib.request
from pathlib import Path
from typing import Callable

REFSEQ_SUMMARY_URL = (
    "https://ftp.ncbi.nlm.nih.gov/genomes/refseq/assembly_summary_refseq.txt"
)
GENBANK_SUMMARY_URL = (
    "https://ftp.ncbi.nlm.nih.gov/genomes/genbank/assembly_summary_genbank.txt"
)
URLS = {"refseq": REFSEQ_SUMMARY_URL, "genbank": GENBANK_SUMMARY_URL}

# columns [0,5,6,7,8,9,19] of the NCBI summary schema
USE_COLS = [0, 5, 6, 7, 8, 9, 19]
COLUMNS = [
    "# assembly_accession",
    "taxid",
    "species_taxid",
    "organism_name",
    "infraspecific_name",
    "isolate",
    "ftp_path",
]
HEADER_LINE = 1  # summaries carry a '##' comment line before the header
TTL_DAYS = 2.0
# the strings pandas' read_csv reads as missing by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})

Downloader = Callable[[str, str], None]
Row = dict  # column name -> str, or None where the cell is missing


def urllib_downloader(url: str, out: str) -> None:
    """Default transport."""
    urllib.request.urlretrieve(url, out)


def table_path(tables_dir: str | os.PathLike, which: str) -> Path:
    return Path(tables_dir) / URLS[which].rsplit("/", 1)[-1]


def is_fresh(path: Path, ttl_days: float = TTL_DAYS) -> bool:
    return path.exists() and (time.time() - path.stat().st_mtime) < ttl_days * 86400


def fetch(
    tables_dir: str | os.PathLike,
    which: str,
    downloader: Downloader = urllib_downloader,
    ttl_days: float = TTL_DAYS,
) -> Path:
    """Ensure the summary TSV is present and fresh; return its path."""
    tables_dir = Path(tables_dir)
    tables_dir.mkdir(parents=True, exist_ok=True)
    path = table_path(tables_dir, which)
    if not is_fresh(path, ttl_days):
        tmp = path.with_suffix(".part")
        downloader(URLS[which], str(tmp))
        os.replace(tmp, path)
    return path


def read_summary(path: str | os.PathLike) -> list[Row]:
    """The seven used columns of a summary TSV as row dicts, in file
    order.  Blank lines are skipped; the header is the second non-blank
    line; a row with more cells than the header is an error, as it is to
    pandas."""
    with open(path, newline="") as fh:
        lines = [r for r in csv.reader(fh, delimiter="\t") if r]
    if len(lines) <= HEADER_LINE:
        raise ValueError(f"{path}: no header line")
    n_cols = len(lines[HEADER_LINE])
    if n_cols <= max(USE_COLS):
        raise ValueError(f"{path}: {n_cols} columns, the summary schema has at least 20")
    rows = []
    for i, cells in enumerate(lines[HEADER_LINE + 1:], HEADER_LINE + 2):
        if len(cells) > n_cols:
            raise ValueError(f"{path}: expected {n_cols} fields in line {i}, saw {len(cells)}")
        rows.append({
            name: cells[c] if c < len(cells) and cells[c] not in NA_STRINGS else None
            for c, name in zip(USE_COLS, COLUMNS)
        })
    return rows


def importer(
    tables_dir: str | os.PathLike,
    which: str,
    downloader: Downloader = urllib_downloader,
    ttl_days: float = TTL_DAYS,
) -> list[Row]:
    """Fetch (or reuse) one summary and read its seven used columns."""
    return read_summary(fetch(tables_dir, which, downloader, ttl_days))


def write_fixture_summary(path: str | os.PathLike, rows: list[dict]) -> None:
    """Write a syntactically faithful mini assembly-summary TSV (22
    columns, '##' preamble) for offline tests and deployments."""
    n_cols = 22
    names = [f"col{i}" for i in range(n_cols)]
    for i, c in zip(USE_COLS, COLUMNS):
        names[i] = c
    with open(path, "w") as fh:
        fh.write("## auto-generated fixture assembly summary\n")
        fh.write("\t".join(names) + "\n")
        for row in rows:
            cells = ["na"] * n_cols
            for i, c in zip(USE_COLS, COLUMNS):
                cells[i] = str(row.get(c, "na"))
            fh.write("\t".join(cells) + "\n")


def fixture_downloader(mapping: dict[str, str]) -> Downloader:
    """Downloader serving local files keyed by URL (offline mode)."""

    def dl(url: str, out: str) -> None:
        if url not in mapping:
            raise FileNotFoundError(url)
        shutil.copyfile(mapping[url], out)

    return dl

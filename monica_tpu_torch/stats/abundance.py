"""Abundance accumulation, normalization and table export (host side,
numpy) — counterpart of ``monica_tpu/stats/abundance.py``.

* :class:`AbundanceState`: the per-sample per-accession int64 count
  accumulator, persisted as ``alignment.npz`` in the same format as the
  JAX package's, so either package reads the other's file;
* :func:`normalize`: BPB = count / genome_length, BPM = BPB / sample
  total;
* :func:`export_tables`: ``monica.dataframe`` (normalized) and
  ``raw_monica.dataframe`` (raw counts), rows (tax_unit, accession) by
  sample columns, zero cells as NaN.

The port does not depend on pandas: the CSVs are written with ``csv``
byte for byte as pandas' ``to_csv`` writes the JAX package's frames (a
``tax_unit,accession,<samples>`` header, float64 cells printed as numpy
prints them, NaN as an empty field, minimal quoting).  Reading a table
back (the JAX package's ``read_dataframe``) is not ported yet.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from monica_tpu_torch.index.build import IndexMeta

DATAFRAME_FILENAME = "monica.dataframe"
RAW_DATAFRAME_FILENAME = "raw_monica.dataframe"
STATE_FILENAME = "alignment.npz"
INDEX_NAMES = ("tax_unit", "accession")


@dataclass
class AbundanceState:
    """Per-sample per-accession count accumulator (int64 on the host),
    monotone across batches, so re-invoking a pass over new samples only
    adds."""

    n_accessions: int
    samples: dict[str, np.ndarray] = field(default_factory=dict)

    def update(self, sample: str, batch_counts: np.ndarray) -> None:
        if sample not in self.samples:
            self.samples[sample] = np.zeros(self.n_accessions, dtype=np.int64)
        self.samples[sample] += batch_counts.astype(np.int64)

    def save(self, folder: str | os.PathLike) -> None:
        names = sorted(self.samples)
        np.savez_compressed(
            Path(folder) / STATE_FILENAME,
            names=np.asarray(names, dtype=object),
            counts=np.stack([self.samples[n] for n in names])
            if names
            else np.zeros((0, self.n_accessions), np.int64),
            n_accessions=np.int64(self.n_accessions),
        )

    @classmethod
    def load(cls, folder: str | os.PathLike, n_accessions: int) -> "AbundanceState":
        """The saved state, or an empty one when there is none or it was
        saved for another accession count."""
        path = Path(folder) / STATE_FILENAME
        state = cls(n_accessions)
        if path.exists():
            # the names are an object array: this file format is the one
            # this module (or the JAX package) writes
            z = np.load(path, allow_pickle=True)
            if int(z["n_accessions"]) == n_accessions:
                for name, row in zip(z["names"], z["counts"]):
                    state.samples[str(name)] = row.astype(np.int64)
        return state

    @staticmethod
    def clear(folder: str | os.PathLike) -> None:
        (Path(folder) / STATE_FILENAME).unlink(missing_ok=True)


def normalize(state: AbundanceState, genome_lengths: np.ndarray) -> dict[str, np.ndarray]:
    """BPB/BPM two-pass normalization: per-sample float64 vectors, 0 for
    absent accessions."""
    out = {}
    gl = np.maximum(genome_lengths.astype(np.float64), 1.0)
    for sample, counts in state.samples.items():
        bpb = counts.astype(np.float64) / gl
        total = bpb.sum()
        out[sample] = bpb / total if total > 0 else bpb
    return out


@dataclass
class Table:
    """An exported table: ``index`` (tax_unit, accession) per row,
    ``samples`` as columns, ``values`` (rows, samples) float64 with NaN
    where the count is zero."""

    index: list[tuple[str, str]]
    samples: list[str]
    values: np.ndarray

    def to_csv(self, path: str | os.PathLike) -> None:
        cells = self.values.astype(str).astype(object)  # numpy's float repr
        cells[np.isnan(self.values)] = ""
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow([*INDEX_NAMES, *self.samples])
            for (tax, acc), row in zip(self.index, cells):
                w.writerow([tax, acc, *row])


def to_table(per_sample: dict[str, np.ndarray], meta: IndexMeta, overnight: bool = False) -> Table:
    """Rows: the accessions with a nonzero value in any sample, in
    accession order; columns: the samples, sorted.  ``overnight``
    collapses each tax unit to its genus (the first ``_`` token);
    accessions stay distinct rows."""
    samples = sorted(per_sample)
    rows_mask = np.zeros(meta.n_accessions, dtype=bool)
    for s in samples:
        rows_mask |= per_sample[s] != 0
    idx = np.nonzero(rows_mask)[0]

    def tax(i: int) -> str:
        t = meta.tax_units[i]
        return t.split("_")[0] if overnight else t

    values = np.empty((len(idx), len(samples)), np.float64)
    for j, s in enumerate(samples):
        col = per_sample[s][idx].astype(np.float64)
        values[:, j] = np.where(col != 0, col, np.nan)
    return Table([(tax(int(i)), meta.accessions[int(i)]) for i in idx], samples, values)


def export_tables(state: AbundanceState, meta: IndexMeta, output_folder: str | os.PathLike,
                  overnight: bool = False) -> tuple[Table, Table]:
    """Write ``monica.dataframe`` (normalized) and ``raw_monica.dataframe``
    (raw counts); returns (normalized, raw)."""
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    raw = to_table({s: c.astype(np.float64) for s, c in state.samples.items()}, meta,
                   overnight=overnight)
    norm = to_table(normalize(state, meta.genome_lengths), meta, overnight=overnight)
    norm.to_csv(output_folder / DATAFRAME_FILENAME)
    raw.to_csv(output_folder / RAW_DATAFRAME_FILENAME)
    return norm, raw

"""FASTA/FASTQ reading and writing (host side) — counterpart of
``monica_tpu/io/seq.py``.  Gzip is handled by extension.  The native
FASTQ parser in :mod:`monica_tpu_torch.io.native` is the fast path of
the streaming runtime; :func:`read_fastq` is the fallback for a machine
with no C++ compiler.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator


@dataclass
class SeqRecord:
    id: str
    seq: str
    qual: str | None = None  # None for FASTA
    desc: str = ""  # remainder of the header line


def _open_text(path: str | os.PathLike):
    path = str(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii", errors="replace")
    return open(path, "r", encoding="ascii", errors="replace")


def read_fasta(path: str | os.PathLike) -> Iterator[SeqRecord]:
    """Stream records from a (possibly gzipped) FASTA file."""
    name, desc, chunks = None, "", []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield SeqRecord(name, "".join(chunks), None, desc)
                header = line[1:].split(None, 1)
                name = header[0] if header else ""
                desc = header[1] if len(header) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield SeqRecord(name, "".join(chunks), None, desc)


def read_fastq(path: str | os.PathLike) -> Iterator[SeqRecord]:
    """Stream records from a (possibly gzipped) 4-line FASTQ file."""
    with _open_text(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"malformed FASTQ header: {header[:80]!r}")
            seq = fh.readline().rstrip("\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                raise ValueError("malformed FASTQ record: missing '+' line")
            qual = fh.readline().rstrip("\n")
            parts = header[1:].split(None, 1)
            rid = parts[0] if parts else ""
            desc = parts[1] if len(parts) > 1 else ""
            yield SeqRecord(rid, seq, qual, desc)


def write_fastq_record(fh, rec: SeqRecord, new_id: str | None = None) -> None:
    """Append one record.  ``new_id`` (the assigned tax unit on the
    mapped route) is prepended to the header, which keeps the original
    id as its next token: ``@<new_id> <id> <desc>``."""
    qual = rec.qual if rec.qual is not None else "I" * len(rec.seq)
    desc = f" {rec.desc}" if rec.desc else ""
    if new_id is None:
        fh.write(f"@{rec.id}{desc}\n{rec.seq}\n+\n{qual}\n")
    else:
        fh.write(f"@{new_id} {rec.id}{desc}\n{rec.seq}\n+\n{qual}\n")


def write_fasta_record(fh, rec: SeqRecord, new_id: str | None = None, width: int = 80) -> None:
    rid = new_id if new_id is not None else rec.id
    desc = f" {rec.desc}" if rec.desc else ""
    fh.write(f">{rid}{desc}\n")
    for i in range(0, len(rec.seq), width):
        fh.write(rec.seq[i : i + width] + "\n")


def list_sample_files(folder: str | os.PathLike, suffix: str = "fastq") -> list[Path]:
    """Non-empty ``*.fastq`` sample files in a folder, sorted."""
    folder = Path(folder)
    out = []
    for p in sorted(folder.iterdir()):
        if p.is_file() and p.name.endswith(suffix) and p.stat().st_size:
            out.append(p)
    return out


def sample_name(path: str | os.PathLike) -> str:
    """Sample name = file name up to the first dot."""
    return Path(path).name.split(".")[0]

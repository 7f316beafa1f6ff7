"""FASTA reading (host side) — counterpart of ``read_fasta`` in
``monica_tpu/io/seq.py``.  Gzip is handled by extension."""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    id: str
    seq: str
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
                    yield SeqRecord(name, "".join(chunks), desc)
                header = line[1:].split(None, 1)
                name = header[0] if header else ""
                desc = header[1] if len(header) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield SeqRecord(name, "".join(chunks), desc)

"""The native FASTQ parser (host side) — counterpart of
``monica_tpu/io/native``: ``fastq.cpp`` indexes a raw FASTQ buffer into
record, id and sequence spans, encodes selected reads straight into
padded code matrices, and concatenates selected raw records for the
routed outputs.  It also packs padded code matrices into the 2-bit wire
(:func:`pack_2bit`, behind ``io.encode.pack_codes_2bit``).

At first use ``fastq.cpp`` is compiled with ``g++`` into a shared
library named by a hash of the source and flags, in the port's build
directory (``$MONICA_TORCH_BUILD_DIR``, else ``build/monica_tpu_torch/``
of a source checkout, else the user's cache; see
:func:`monica_tpu_torch.ops._native.build_dir`), never next to the
source, and loaded with ``ctypes``.  This is a host library, not a
device kernel: where no compiler is found, :func:`load` returns None and
the runtime parses with :func:`monica_tpu_torch.io.seq.read_fastq`.

:data:`PARSED` counts the views parsed here, so a run can show that the
native parser is the one that read its samples; :data:`PACKED` counts
the batches ``pack_codes_2bit`` packed by each route.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from monica_tpu_torch.ops._native import build_dir

SRC = Path(__file__).resolve().parent / "fastq.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# FastqViews parsed since the last reset_counts()
PARSED = {"views": 0}
# batches packed to the 2-bit wire by each route since the last reset_counts()
PACKED = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"libmonica_io_{h.hexdigest()[:16]}.so"


def _build(dest: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, dest)  # atomic: a concurrent build never sees half a file
    return True


def load():
    """The loaded library, built at first use; None when it cannot be
    built here."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        dest = library_path()
        if not dest.exists() and not _build(dest):
            return None
        lib = ctypes.CDLL(str(dest))
        i64, i32, buf = ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p
        lib.fastq_count.argtypes = [buf, i64]
        lib.fastq_count.restype = i64
        lib.fastq_index.argtypes = [buf, i64, i64, _I64P, _I64P, _I64P, _I32P, _I64P, _I32P]
        lib.fastq_index.restype = i64
        lib.encode_rows.argtypes = [buf, _I64P, _I32P, _I64P, i64,
                                    ctypes.POINTER(ctypes.c_uint8), i64, i32]
        lib.encode_rows.restype = None
        lib.concat_records.argtypes = [buf, _I64P, _I64P, _I64P, i64, ctypes.c_char_p]
        lib.concat_records.restype = None
        lib.concat_records_with_id.argtypes = [buf, _I64P, _I64P, _I64P, _I32P, _I64P, i64,
                                               ctypes.c_char_p, i32, ctypes.c_char_p]
        lib.concat_records_with_id.restype = None
        lib.pack_2bit.argtypes = [_U8P, i64, i64, _U8P]
        lib.pack_2bit.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def reset_counts() -> None:
    PARSED["views"] = 0
    PACKED["native"] = PACKED["numpy"] = 0


def count_pack(route: str) -> None:
    """One batch packed by ``route`` ("native" or "numpy")."""
    with _lock:
        PACKED[route] += 1


def pack_2bit(codes: np.ndarray, out: np.ndarray) -> None:
    """Pack C-contiguous (B, L) uint8 codes into C-contiguous
    (B, ceil(L/4)) uint8 ``out`` (``io.encode.pack_codes_2bit``'s
    layout) in one pass; the library must be loaded."""
    B, L = codes.shape
    if not (codes.dtype == out.dtype == np.uint8 and codes.flags.c_contiguous
            and out.flags.c_contiguous and out.shape == (B, -(-L // 4))):
        raise ValueError("pack_2bit needs C-contiguous uint8 (B, L) codes and (B, ceil(L/4)) out")
    load().pack_2bit(_p(codes, _U8P), B, L, _p(out, _U8P))


def _p(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


def _out(arr: np.ndarray):
    return ctypes.cast(arr.ctypes.data, ctypes.c_char_p)


class FastqView:
    """Zero-copy view over one parsed FASTQ buffer: the raw bytes plus
    per-record spans.  Routing writes raw record slices back out without
    re-serialization; encoding fills padded code matrices in C."""

    def __init__(self, buf: bytes, rec_off, rec_len, id_off, id_len, seq_off, seq_len):
        self.buf = buf
        self.rec_off = rec_off
        self.rec_len = rec_len
        self.id_off = id_off
        self.id_len = id_len
        self.seq_off = seq_off
        self.seq_len = seq_len
        self._zero_id_len = None

    def __len__(self):
        return len(self.rec_off)

    @property
    def lengths(self) -> np.ndarray:
        return self.seq_len

    def record_bytes(self, i: int) -> bytes:
        o = self.rec_off[i]
        return self.buf[o : o + self.rec_len[i]]

    def read_id(self, i: int) -> bytes:
        o = self.id_off[i]
        return self.buf[o : o + self.id_len[i]]

    def concat_records(self, indices: np.ndarray) -> np.ndarray:
        """Raw bytes of the selected records, concatenated in C (one
        buffer the caller writes with a single fh.write)."""
        sel = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty(int(self.rec_len[sel].sum()), dtype=np.uint8)
        if len(sel):
            load().concat_records(self.buf, _p(self.rec_off, _I64P), _p(self.rec_len, _I64P),
                                  _p(sel, _I64P), len(sel), _out(out))
        return out

    def concat_records_with_id(self, indices: np.ndarray, new_id: bytes) -> np.ndarray:
        """The selected records with ``new_id + b' '`` inserted before
        each read id (header ``@<new_id> <id> ...``), concatenated in C:
        the C id splice run with a zero-length id span."""
        sel = np.ascontiguousarray(indices, dtype=np.int64)
        ins = new_id + b" "
        out = np.empty(int(self.rec_len[sel].sum() + len(ins) * len(sel)), dtype=np.uint8)
        if len(sel):
            if self._zero_id_len is None:  # the mapped route calls this once per accession
                self._zero_id_len = np.zeros_like(self.id_len)
            load().concat_records_with_id(
                self.buf, _p(self.rec_off, _I64P), _p(self.rec_len, _I64P),
                _p(self.id_off, _I64P), _p(self._zero_id_len, _I32P), _p(sel, _I64P),
                len(sel), ins, len(ins), _out(out))
        return out

    def encode_rows(self, indices: np.ndarray, out: np.ndarray,
                    offsets: np.ndarray | None = None,
                    window_lens: np.ndarray | None = None) -> None:
        """Fill out[k, :] from read indices[k].  ``out`` is uint8,
        C-contiguous and pre-filled with PAD; ``offsets`` and
        ``window_lens`` select a window within each read."""
        if out.dtype != np.uint8 or not out.flags.c_contiguous or out.shape[0] < len(indices):
            raise ValueError("encode_rows needs a C-contiguous uint8 (n, L) output")
        n = len(indices)
        if n == 0:
            return
        sel = np.ascontiguousarray(indices, dtype=np.int64)
        so = np.ascontiguousarray(self.seq_off[sel])
        sl = np.ascontiguousarray(self.seq_len[sel])
        if offsets is not None:
            off = np.asarray(offsets, dtype=np.int64)
            so = np.ascontiguousarray(so + off)
            sl = np.ascontiguousarray(
                np.minimum(np.asarray(window_lens, dtype=np.int64), sl - off).astype(np.int32))
        rows = np.arange(n, dtype=np.int64)
        load().encode_rows(self.buf, _p(so, _I64P), _p(sl, _I32P), _p(rows, _I64P), n,
                           _p(out, ctypes.POINTER(ctypes.c_uint8)), out.strides[0],
                           out.shape[1])


def _index(buf: bytes, count: int) -> FastqView:
    """Spans of the first ``count`` records of ``buf``."""
    arrs = [np.empty(count, dt) for dt in (np.int64, np.int64, np.int64, np.int32,
                                           np.int64, np.int32)]
    rec_off, rec_len, id_off, id_len, seq_off, seq_len = arrs
    got = load().fastq_index(buf, len(buf), count, _p(rec_off, _I64P), _p(rec_len, _I64P),
                             _p(id_off, _I64P), _p(id_len, _I32P), _p(seq_off, _I64P),
                             _p(seq_len, _I32P))
    if got < 0:
        raise ValueError(f"malformed FASTQ at byte {-(got + 1)}")
    with _lock:  # parse workers run concurrently
        PARSED["views"] += 1
    return FastqView(buf, *arrs)


def parse_fastq_bytes(buf: bytes) -> FastqView | None:
    """Index a FASTQ buffer natively; None if the library is missing."""
    lib = load()
    if lib is None:
        return None
    count = lib.fastq_count(buf, len(buf))
    if count < 0:
        raise ValueError(f"malformed FASTQ at byte {-(count + 1)}")
    return _index(buf, int(count))


def parse_fastq_file(path) -> FastqView | None:
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        buf = fh.read()
    return parse_fastq_bytes(buf)


def _parse_all_but_last(buf: bytes):
    """Index every complete record of ``buf`` except the last one, which
    the chunk boundary may have cut and which is carried over.
    ``fastq_count`` validates record starts only, so a tail cut
    mid-record never raises.  Returns (view or None, carry bytes)."""
    count = load().fastq_count(buf, len(buf))
    if count < 0:
        # a record start that is not '@' cannot come from truncation
        raise ValueError(f"malformed FASTQ at byte {-(count + 1)}")
    head = int(count) - 1
    if head <= 0:
        return None, buf
    view = _index(buf, head)
    cut = int(view.rec_off[head - 1] + view.rec_len[head - 1])
    return view, buf[cut:]


def iter_fastq_file_views(path, chunk_bytes: int = 64 << 20):
    """Stream a (possibly gzipped) FASTQ file as independent FastqViews
    of ~``chunk_bytes`` each.  Records never split across views, so the
    record set over all views equals the whole-file parse; memory stays
    below ~2x chunk_bytes plus the caller's batches.  A record larger
    than 4x chunk_bytes, or a record start that is not '@', raises
    ValueError."""
    if load() is None:
        raise RuntimeError("native FASTQ library unavailable")
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        carry = b""
        while True:
            data = fh.read(chunk_bytes)
            buf = carry + data
            carry = b""
            if not buf:
                return
            if not data:  # end of file: the carried tail is whole
                view = parse_fastq_bytes(buf)
                if view is not None and len(view):
                    yield view
                return
            view, carry = _parse_all_but_last(buf)
            if view is not None:
                yield view
            if len(carry) > 4 * chunk_bytes:
                raise ValueError(
                    f"FASTQ record exceeds 4x chunk_bytes ({4 * chunk_bytes} B): "
                    "corrupt file, or raise chunk_bytes")

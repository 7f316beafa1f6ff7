"""Peak memory of FASTQ ingest — the port's counterpart of
``scripts/ingest_rss.py``: the measured bound that ``run_once``'s
oversized-sample split (``runtime.MAX_RESIDENT_BYTES``, streamed in
``CHUNK_BYTES`` views) relies on, taken on the port's own parser.

It writes a synthetic FASTQ of ``--mb`` MiB (1 kb records, seed 5), then
parses it in fresh subprocesses and records each one's peak RSS
(``VmHWM`` of ``/proc/self/status``; where the kernel keeps none, as
gVisor does, the largest ``VmRSS`` sampled every millisecond): the
interpreter with ``io.native`` loaded (baseline), the whole-file parse
(``io.native.parse_fastq_file``, RSS ~ the file) and the chunked one
(``io.native.iter_fastq_file_views``, RSS ~ a few chunks).  The JAX
script reads ``resource.ru_maxrss`` instead, which Linux carries over
from the parent process across ``fork`` and ``exec``: from a parent
larger than the parse it reads the parent's peak three times.
Both of the port's readings belong to the worker's own address space.
Host only: no
device is involved.  Exits 1 when the two parses count other records
than were written.

    python -m monica_tpu_torch.ingest_rss [--mb 256] [--chunk_mb 32] [--out F]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from monica_tpu_torch.io import native

# the folder that holds the package, so the worker imports this copy
PACKAGE_PARENT = Path(__file__).resolve().parents[1]
RECORD_LEN = 1000

WORKER = r"""
import sys, threading
sys.path.insert(0, {parent!r})


def status_kb(key):
    with open("/proc/self/status") as fh:
        return next((int(x.split()[1]) for x in fh if x.startswith(key + ":")), None)


# where the kernel keeps no high-water mark (VmHWM), the peak is the
# largest VmRSS a thread samples every millisecond
peak, done = [status_kb("VmRSS")], threading.Event()


def sample():
    while not done.wait(0.001):
        peak[0] = max(peak[0], status_kb("VmRSS"))


sampler = threading.Thread(target=sample)
sampler.start()
from monica_tpu_torch.io import native
mode, path, chunk = sys.argv[1], sys.argv[2], int(sys.argv[3])
n = 0
if mode == "baseline":
    native.available()  # import and load cost only
elif mode == "whole":
    n = len(native.parse_fastq_file(path))
else:
    for v in native.iter_fastq_file_views(path, chunk_bytes=chunk):
        n += len(v)
done.set()
sampler.join()
hwm = status_kb("VmHWM")
print(n, hwm if hwm is not None else max(peak[0], status_kb("VmRSS")))
"""


def write_fastq(path, mb: int) -> int:
    """A FASTQ of about ``mb`` MiB of random 1 kb records; returns the
    record count."""
    rng = np.random.default_rng(5)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_recs = mb * (1 << 20) // (2 * RECORD_LEN + 40)
    q = b"I" * RECORD_LEN
    with open(path, "wb") as fh:
        for i in range(n_recs):
            s = lut[rng.integers(0, 4, RECORD_LEN)].tobytes()
            fh.write(b"@read%d rss\n%s\n+\n%s\n" % (i, s, q))
    return n_recs


def run_worker(mode: str, path, chunk_bytes: int) -> tuple[int, int]:
    """(records parsed, peak RSS bytes) of one fresh worker process
    (``mode``: baseline, whole or chunked)."""
    proc = subprocess.run(
        [sys.executable, "-c", WORKER.format(parent=str(PACKAGE_PARENT)), mode, str(path),
         str(chunk_bytes)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"ingest_rss worker ({mode}) exited {proc.returncode}: {proc.stderr}")
    out = proc.stdout.split()
    return int(out[0]), int(out[1]) * 1024  # /proc reports KiB


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.ingest_rss",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--chunk_mb", type=int, default=32)
    ap.add_argument("--out", default="INGEST_RSS_torch.json")
    args = ap.parse_args(argv)
    if not native.available():
        raise SystemExit("ingest_rss: the native FASTQ parser did not build (no g++?)")
    chunk = args.chunk_mb << 20

    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "big.fastq"
        n_recs = write_fastq(path, args.mb)
        fsize = path.stat().st_size
        _, rss_base = run_worker("baseline", path, chunk)
        n_whole, rss_whole = run_worker("whole", path, chunk)
        n_chunk, rss_chunk = run_worker("chunked", path, chunk)
    if not n_whole == n_chunk == n_recs:
        raise SystemExit(f"ingest_rss: {n_recs} records written, {n_whole} parsed whole, "
                         f"{n_chunk} chunked")

    payload = dict(
        file_mb=round(fsize / 1e6, 1),
        records=n_recs,
        chunk_mb=args.chunk_mb,
        interpreter_baseline_rss_mb=round(rss_base / 1e6, 1),
        whole_file_peak_rss_mb=round(rss_whole / 1e6, 1),
        chunked_peak_rss_mb=round(rss_chunk / 1e6, 1),
        whole_delta_mb=round((rss_whole - rss_base) / 1e6, 1),
        chunked_delta_mb=round((rss_chunk - rss_base) / 1e6, 1),
        chunked_delta_over_chunk=round((rss_chunk - rss_base) / chunk, 2),
        bound=("ingest cost above the interpreter baseline: whole-file tracks the file size; "
               "chunked stays within a few chunk sizes regardless of file size"),
    )
    print(json.dumps(payload))
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

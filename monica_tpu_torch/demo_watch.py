"""The real-time loop demo — the port's counterpart of
``scripts/demo_watch.py`` (BASELINE config 4): a feeder thread drops
flowcell FASTQ batches into the query folder while ``watch`` classifies
them as they land, and ``on_batch`` reads the refreshed accumulator after
every pass.

The workload and seeds are the JAX script's: the Zymo community
(``zymo_community``, seed 13) in one shard built on ``--device``, a
``query_length`` Classifier, a warm sample of 4,096 reads through
``run_once``, then 4 batches of 8,192 reads of 1,000 bp at 5%
substitutions (``evaluation.bench_reads``), each written to a hidden
``.tmp`` file and renamed into place, 2 s apart, under
``watch(poll_s=0.5, max_idle_polls=8)``.  Each ``batch_log`` entry also
holds ``latency_s``: the seconds from the rename of the newest file of
that pass to the end of ``on_batch``, the wait from a read batch to its
updated table.

Gate (the JAX script's): every fed read processed, more than 95% mapped,
and the accumulator's total growing strictly from pass to pass.
``--quick`` is a CPU-sized run (a 2% community, 3 batches of 256 reads,
tighter polling).

    python -m monica_tpu_torch.demo_watch [--device cuda] [--quick] [--workdir D] [--out F]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.stats.abundance import AbundanceState

READ_LEN = 1000
# (community scale, batches, reads a batch, warm reads, seconds between
# batches, poll seconds, idle polls before the loop ends)
FULL = dict(scale=1.0, n_batches=4, reads=8192, warm_reads=4096, gap_s=2.0, poll_s=0.5,
            max_idle_polls=8)
QUICK = dict(scale=0.02, n_batches=3, reads=256, warm_reads=128, gap_s=0.1, poll_s=0.05,
             max_idle_polls=40)


def device_name(device) -> str:
    d = torch.device(device)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else d.type


def run(device, workdir, *, scale: float, n_batches: int, reads: int, warm_reads: int,
        gap_s: float, poll_s: float, max_idle_polls: int) -> tuple[dict, list]:
    """The demo in ``workdir`` (its ``query/`` and ``out/`` folders):
    (the JSON payload, every SampleReport of the watch loop)."""
    rng = np.random.default_rng(13)
    t0 = time.time()
    seqs = ev.zymo_community(rng, scale)
    built = build_index_from_arrays(seqs, n_shards=1, device=device)
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="query_length", device=device)
    build_s = time.time() - t0

    qdir, out = Path(workdir) / "query", Path(workdir) / "out"
    for d in (qdir, out):
        d.mkdir(parents=True, exist_ok=True)
    for f in [*qdir.glob("*.fastq"), *(p for p in out.glob("*") if p.is_file())]:
        f.unlink()

    # a warm pass first, so the loop's passes find the allocator and the
    # kernels ready
    ev.write_fastq_sample(qdir / "warm.fastq", ev.bench_reads(seqs, rng, warm_reads, READ_LEN)[0])
    rt.run_once(clf, qdir, out)

    renamed: dict[str, float] = {}  # sample -> perf_counter at its rename
    feed_error: list[Exception] = []

    def feeder():
        try:
            for i in range(n_batches):
                tmp = qdir / f".flowcell{i}.tmp"
                ev.write_fastq_sample(tmp, ev.bench_reads(seqs, rng, reads, READ_LEN)[0])
                renamed[f"flowcell{i}"] = time.perf_counter()
                tmp.rename(qdir / f"flowcell{i}.fastq")  # appears whole
                time.sleep(gap_s)
        except Exception as e:  # re-raised on the caller's thread after the loop
            feed_error.append(e)

    batch_log = []
    t_start = time.time()

    def on_batch(reports):
        state = AbundanceState.load(out, built.meta.n_accessions)
        entry = {
            "t": round(time.time() - t_start, 2),
            "samples": [r.sample for r in reports],
            "reads": sum(r.n_reads for r in reports),
            "mapped": sum(r.n_mapped for r in reports),
            "seconds": round(sum(r.seconds for r in reports), 3),
            "accumulated_count_total": int(sum(v.sum() for v in state.samples.values())),
        }
        entry["latency_s"] = time.perf_counter() - max(renamed[r.sample] for r in reports)
        batch_log.append(entry)

    th = threading.Thread(target=feeder)
    th.start()
    reports = rt.watch(clf, qdir, out, poll_s=poll_s, max_idle_polls=max_idle_polls,
                       on_batch=on_batch)
    th.join()
    if feed_error:
        raise feed_error[0]

    n_reads = sum(r.n_reads for r in reports)
    n_mapped = sum(r.n_mapped for r in reports)
    growth = [b["accumulated_count_total"] for b in batch_log]
    monotone = all(a < b for a, b in zip(growth, growth[1:]))
    payload = {
        "metric": "watch_mode_rolling_batches",
        "device": device_name(device),
        "batches_fed": n_batches,
        "reads_per_batch": reads,
        "reads_processed": n_reads,
        "mapped": n_mapped,
        "index_build_s": round(build_s, 1),
        "batch_log": batch_log,
        "monotone_growth": monotone,
        "verdict": "PASS" if (n_reads == n_batches * reads and n_mapped > 0.95 * n_reads
                              and len(growth) >= 2 and monotone) else "FAIL",
    }
    return payload, reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.demo_watch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU-friendly)")
    ap.add_argument("--workdir", help="folder for query/ and out/ (default: a temporary one)")
    ap.add_argument("--out", help="write the JSON payload here")
    args = ap.parse_args(argv)
    sizes = QUICK if args.quick else FULL
    with tempfile.TemporaryDirectory(prefix="demo_watch_") as td:
        payload, _ = run(args.device, args.workdir or td, **sizes)
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0 if payload["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())

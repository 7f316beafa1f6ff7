"""End-to-end streaming benchmark on the product path — the port's
counterpart of ``scripts/bench_stream.py``.

``bench.py`` times the device pipeline alone; this times what a user
gets: ``process_sample`` and ``run_once`` over FASTQ files (native C
parse, length bucketing and 2-bit encode, dispatch, one fetch of a
sample's packed results, window merge, counts, routed FASTQ writes)
against the 64 Mbase Zymo index (seed 7, one shard, built on
``--device``) in ``query_length`` mode.

As the JAX script: ``--reads`` reads of ``--read_len`` bp
(``bench.make_reads``'s draws) in ``flowcell0.fastq``; a warm sample of
the same shape through ``process_sample``, then 3 timed
``process_sample`` reps of ``flowcell0.fastq`` (kept), whose median is
the value; the last rep's ``Metrics`` give ``stage_reads_per_s``.  Then
``--samples`` files of ``max(reads // samples, 4096)`` reads: a serial
``process_sample`` loop over them against 3 pipelined ``run_once`` reps
(files written anew before each), and ``overlap_speedup``.

The JAX script writes fixed ``/tmp/bench_stream_*`` folders; here they
are the same sub-folders of ``--work`` (default a fresh temporary
directory, removed at the end).  Prints the card's name and power limit,
then ONE JSON line with the JAX script's payload keys (``device``, the
card's name; ``--out`` writes it too).  ``--quick`` (CPU tests): the
community at 1/100 of its length, 512 reads of 1,000 bp, 2 samples of
at least 128 reads.

    python -m monica_tpu_torch.bench_stream [--reads N] [--read_len L] [--samples S]
        [--work DIR] [--out FILE] [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from monica_tpu_torch import bench
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.demo_watch import device_name
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.stats.abundance import AbundanceState
from monica_tpu_torch.utils.metrics import Metrics

FULL = dict(scale=1.0, reads=100_000, samples=8, min_per_sample=4096)
QUICK = dict(scale=0.01, reads=512, samples=2, min_per_sample=128)


def run(device, work: Path, *, reads: int, read_len: int, samples: int, scale: float,
        min_per_sample: int) -> dict:
    """The benchmark in the folder ``work``: the JSON payload."""
    rng = np.random.default_rng(7)
    t0 = time.time()
    seqs = ev.zymo_community(rng, scale)
    built = build_index_from_arrays(seqs, n_shards=1, device=device)
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="query_length", device=device)
    build_s = time.time() - t0

    qdir = work / "bench_stream_query"
    for sub in ("", "mapped", "unmapped", "ambiguous"):
        (qdir / sub).mkdir(parents=True, exist_ok=True)
    for f in qdir.glob("*.fastq"):
        f.unlink()
    codes = bench.make_reads(seqs, rng, reads, read_len)
    ev.write_fastq_sample(qdir / "flowcell0.fastq", codes)
    (work / "bench_stream_out").mkdir(exist_ok=True)

    # a warm sample of the same shape first, so the timed reps find the
    # allocator and the kernels ready (the watcher's steady state)
    warm = qdir / "warm.fastq"
    ev.write_fastq_sample(warm, codes)
    folders = rt.RouteFolders.create(qdir, with_focus=False)
    state = AbundanceState(built.meta.n_accessions)
    rt.process_sample(clf, warm, folders, state, delete=True)

    single_reps = []
    rep = metrics = None
    for _ in range(3):
        m = Metrics(verbose=False)
        t0 = time.time()
        rep = rt.process_sample(clf, qdir / "flowcell0.fastq", folders, state, delete=False,
                                metrics=m)
        single_reps.append(rep.n_reads / (time.time() - t0))
        metrics = m
    reads_per_s = float(np.median(single_reps))
    stages = {k: round(v.items / v.seconds) for k, v in metrics.stages.items()
              if v.items and v.seconds > 0}

    # run_once pipelines parse(i+1) / dispatch(i) / route(i-1) across
    # samples on worker threads; against a serial process_sample loop
    per_sample = max(reads // samples, min_per_sample)
    sample_codes = [bench.make_reads(seqs, rng, per_sample, read_len) for _ in range(samples)]

    def write_all(folder: Path):
        for sub in ("", "mapped", "unmapped", "ambiguous"):
            (folder / sub).mkdir(parents=True, exist_ok=True)
        for f in folder.glob("*.fastq"):
            f.unlink()
        for i, c in enumerate(sample_codes):
            ev.write_fastq_sample(folder / f"fc{i}.fastq", c)

    total = per_sample * samples
    qs = work / "bench_stream_serial"
    write_all(qs)
    sfolders = rt.RouteFolders.create(qs, with_focus=False)
    t0 = time.time()
    for i in range(samples):
        rt.process_sample(clf, qs / f"fc{i}.fastq", sfolders, state, delete=True)
    serial_s = time.time() - t0

    pipe_reps = []
    for _ in range(3):
        qp = work / "bench_stream_pipe"
        write_all(qp)
        op = work / "bench_stream_pipe_out"
        op.mkdir(exist_ok=True)
        t0 = time.time()
        reports = rt.run_once(clf, qp, op)
        pipe_s = time.time() - t0
        if sum(r.n_reads for r in reports) != total:
            raise RuntimeError(f"run_once took {sum(r.n_reads for r in reports)} of {total} reads")
        pipe_reps.append(total / pipe_s)
    overlap = {
        "samples": samples,
        "reads_per_sample": per_sample,
        "serial_reads_per_s": round(total / serial_s, 1),
        "pipelined_reads_per_s": round(float(np.median(pipe_reps)), 1),
        "pipelined_reps": [round(r, 1) for r in pipe_reps],
        "pipelined_best": round(max(pipe_reps), 1),
        "overlap_speedup": round(float(np.median(pipe_reps)) * serial_s / total, 3),
    }
    return {
        "metric": "end_to_end_stream_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "workload": f"{reads} x {read_len} bp reads, "
                    f"{sum(len(s) for s in seqs) / 1e6:.0f} Mbase index, "
                    "run through process_sample (parse/encode/classify/route/count)",
        "device": device_name(device),
        "stat": "median_of_3",
        "single_sample_reps": [round(r, 1) for r in single_reps],
        "single_sample_best": round(max(single_reps), 1),
        "n_mapped": rep.n_mapped,
        "n_unmapped": rep.n_unmapped,
        "n_ambiguous": rep.n_ambiguous,
        "index_build_s": round(build_s, 1),
        "stage_reads_per_s": stages,
        "cross_sample_overlap": overlap,
        "note": "the caller thread dispatches every batch eagerly and each sample ends with "
                "one device->host fetch; the device pipeline's own rate is "
                "python -m monica_tpu_torch.bench's",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.bench_stream",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int)
    ap.add_argument("--read_len", type=int, default=1000)
    ap.add_argument("--samples", type=int,
                    help="flowcell files for the run_once overlap measurement")
    ap.add_argument("--work", help="folder for the FASTQ folders (default: a temporary one)")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    sizes = dict(QUICK if args.quick else FULL)
    sizes.update({k: getattr(args, k) for k in ("reads", "samples") if getattr(args, k)})
    with tempfile.TemporaryDirectory(prefix="bench_stream_") as td:
        work = Path(args.work or td)
        work.mkdir(parents=True, exist_ok=True)
        payload = run(dev, work, read_len=args.read_len, **sizes)
    print(bench.card(dev), flush=True)
    print(json.dumps(payload), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

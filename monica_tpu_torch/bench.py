"""Headline benchmark of the classify step on one card — the port's
counterpart of the JAX repo's ``bench.py``: classification reads/s of
the device pipeline alone, at a realistic index size.

Workload, seeds and sizes are ``bench.py``'s: seed 3; the Zymo community
(``evaluation.zymo_community``: 8 × 5 Mb + 2 × 12 Mb = 64 Mbase) in one
shard; ``--small`` 5 × 1 Mb in one shard; ``--gut`` 200 × 1.5 Mb =
300 Mbase in 5 shards; every index stacked by size class and classified
by ``classify_batch_grouped``.  Reads: 16 batches of 2048 × 1,024 bp at 5%
substitutions (``evaluation.bench_reads``, ``bench.make_reads``'s
draws).  ``--no-extend`` runs the vote-only pipeline, ``--anchors N``
overrides ``anchors_per_seed``.  The index is built on ``--device``
(default ``cuda``; a CUDA device without a card raises, nothing falls
back to the CPU).

The window.  ``bench.py`` times one ``lax.scan`` dispatch over 16
device-resident batches that ends with one host fetch.  Here the 16
batches of raw codes (32 MiB) and their lengths are uploaded once,
before the window; inside it a Python loop calls
``classify_batch_grouped`` in ``query_length`` mode with
``params_for_bucket``'s params on each resident batch, sums the counts on
the device and keeps every batch's full ``ReadResult`` referenced; the
window ends with ``torch.cuda.synchronize()`` and one fetch of every
status.  The host 2-bit pack and the upload of ``Classifier.classify``
are outside it (``chip_smoke.py``'s ``[bench]`` line times them: a
different number).  The loop is not one dispatch: each batch is
hundreds of eager launches and the rescue tier's host sync
(``align/pipeline.py``, ``int(cand.sum())``), which fires once a batch
and size-class group even when no read is a candidate; the stderr line
counts the syncs.  1 warm-up, then 5 timed reps; the value is their median.

Prints the card's name and power limit (``nvidia-smi``), then ONE JSON
line with ``bench.py``'s keys; a stderr line carries ``bench.py``'s
fields plus the host syncs a batch and the peak device MiB.
``--quick`` (CPU tests): genomes at 1/100 of their length, 2 batches of
64 reads, 2 timed reps.

    python -m monica_tpu_torch.bench [--small | --gut] [--no-extend] [--anchors N]
        [--device cuda] [--quick]

:func:`resident_runner` is the timed loop over resident batches that
``profile_stages`` and ``exp_knobs`` share (through :func:`time_scalar`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import build_index_from_arrays

# ASSUMED baseline, bench.py's: mappy/minimap2 map-ont, 3 threads (BASELINE.md)
BASELINE_READS_PER_S = 2000.0
SEED = 3
READ_LEN = 1024
SUB_RATE = 0.05
FULL = dict(scale=1.0, batch=2048, n_batches=16, reps=5)
QUICK = dict(scale=0.01, batch=64, n_batches=2, reps=2)


# ---------------------------------------------------------------------------
# shared by the measurement modules
# ---------------------------------------------------------------------------

def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch.cuda.is_available() is false "
                           "(nothing falls back to the CPU)")
    return dev


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (its line for a
    card of this name, else its first), or ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(dev)
    return next((ln for ln in lines if ln.split(",")[0].strip() == name), lines[0])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def scan(body, carry, codes: torch.Tensor, lengths: torch.Tensor):
    """``lax.scan``'s counterpart over the leading axis of resident
    batches: ``carry, y = body(carry, codes[r], lengths[r])`` for each r;
    returns (carry, [y for each batch])."""
    ys = []
    for c, l in zip(codes, lengths):
        carry, y = body(carry, c, l)
        ys.append(y)
    return carry, ys


def resident_runner(body, init, codes: torch.Tensor, lengths: torch.Tensor, fetch,
                    reps: int, warmup: int = 1):
    """Time :func:`scan` of ``body`` over resident (R, B, L) ``codes`` and
    (R, B) ``lengths`` from ``init()``; each rep's window starts after a
    device sync and ends with one sync and ``fetch(carry, ys)`` (the
    host copy).  Returns (seconds of each timed rep, (carry, ys,
    fetched) of the last rep)."""
    dev = codes.device

    def once():
        carry, ys = scan(body, init(), codes, lengths)
        sync(dev)
        return carry, ys, fetch(carry, ys)

    for _ in range(warmup):
        out = once()
    dts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = once()
        dts.append(time.perf_counter() - t0)
    return dts, out


def time_scalar(step, codes: torch.Tensor, lengths: torch.Tensor, reps: int):
    """:func:`resident_runner` of a step that returns a float32 scalar
    tensor a batch, summed on the device and fetched once: (seconds a
    rep, the last rep's sum)."""
    dts, (_total, _ys, value) = resident_runner(
        lambda carry, c, l: (carry + step(c, l), None),
        lambda: torch.zeros((), dtype=torch.float32, device=codes.device), codes, lengths,
        lambda total, _ys: float(total.cpu()), reps)
    return dts, value


def call_seconds(fn, reps: int, device) -> list[float]:
    """Seconds of each of ``reps`` calls of ``fn()`` after one warm-up:
    CUDA events around each call on the card, the host clock on the CPU
    (where ``fn`` is synchronous)."""
    fn()
    out = []
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize(device)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return out


def host_syncs(fn, device) -> list[str] | None:
    """Where ``fn()`` syncs the card with the host, as torch's sync debug
    mode reports it: one "file:line" a sync; None off a CUDA device."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    del out
    return [f"{Path(w.filename).name}:{w.lineno}" for w in seen
            if "synchronizing" in str(w.message)]


def resident(codes: np.ndarray, lengths: np.ndarray, device):
    """Host batches -> device tensors, uploaded once (outside any window)."""
    cd = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    ld = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(device)
    sync(device)
    return cd, ld


def make_reads(seqs, rng: np.random.Generator, n_reads: int, read_len: int = READ_LEN):
    """``bench.make_reads``: position-uniform reads at 5% substitutions."""
    return ev.bench_reads(seqs, rng, n_reads, read_len, SUB_RATE)[0]


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------

def genomes(mode: str, rng: np.random.Generator, scale: float = 1.0):
    """``bench.py``'s reference set for ``mode`` ("zymo", "small", "gut")
    at ``scale`` of each genome's length: (sequences, shards)."""
    if mode == "small":
        return [rng.integers(0, 4, int(1_000_000 * scale)).astype(np.uint8)
                for _ in range(5)], 1
    if mode == "gut":
        return [rng.integers(0, 4, int(1_500_000 * scale)).astype(np.uint8)
                for _ in range(200)], 5
    return ev.zymo_community(rng, scale), 1


def prepare(built, device, extend: bool = True, anchors: int | None = None,
            read_len: int = READ_LEN):
    """The index stacked by size class (one shard is one group of one)
    and ``bench.py``'s params.  Returns (index, params, n_accessions)."""
    index, steps = pl.stack_device_shard_groups(built.shards, device)
    params = pl.params_for_bucket(pl.ClassifyParams(tag_bits=steps, extend=extend), read_len)
    if anchors is not None:
        params = params._replace(anchors_per_seed=anchors)
    return index, params, built.meta.n_accessions


def run_all(index, params, n_acc, codes: torch.Tensor, lengths: torch.Tensor,
            reps: int, warmup: int = 1):
    """The timed loop of ``bench.py``: (seconds a rep, summed counts, the
    last rep's ReadResults, their statuses fetched as one (R, B) array),
    each batch through ``classify_batch_grouped``."""
    dev = codes.device

    def body(total, c, l):  # run_all's scan body: counts summed, the full ReadResult kept
        res, counts = pl.classify_batch_grouped(index, c, l, params, n_acc,
                                                pl.MODE_QUERY_LENGTH)
        return total + counts, res

    dts, (total, results, statuses) = resident_runner(
        body, lambda: torch.zeros(n_acc, dtype=torch.int32, device=dev), codes, lengths,
        lambda _total, ys: torch.stack([r.status for r in ys]).cpu().numpy(), reps, warmup)
    return dts, total, results, statuses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="config-1 workload (5 x 1 Mb, 1 shard)")
    ap.add_argument("--gut", action="store_true",
                    help="config-3 workload: 200 x 1.5 Mb genomes = 300 Mbase in 5 shards "
                         "(grouped multi-shard path; --small wins over it, as in bench.py)")
    ap.add_argument("--no-extend", dest="extend", action="store_false",
                    help="A/B: vote-only pipeline (attributes the extension stage cost)")
    ap.add_argument("--anchors", type=int, default=None,
                    help="A/B: anchors_per_seed override (default: ClassifyParams)")
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    sizes = QUICK if args.quick else FULL
    batch, n_batches = sizes["batch"], sizes["n_batches"]

    rng = np.random.default_rng(SEED)
    t0 = time.time()
    seqs, n_shards = genomes("small" if args.small else "gut" if args.gut else "zymo", rng,
                             sizes["scale"])
    built = build_index_from_arrays(seqs, n_shards=n_shards, device=dev)
    index, params, n_acc = prepare(built, dev, args.extend, args.anchors)
    sync(dev)
    build_s = time.time() - t0

    n = batch * n_batches
    codes = make_reads(seqs, rng, n).reshape(n_batches, batch, READ_LEN)
    cd, ld = resident(codes, np.full((n_batches, batch), READ_LEN, np.int32), dev)
    syncs = host_syncs(lambda: pl.classify_batch_grouped(index, cd[0], ld[0], params, n_acc,
                                                         pl.MODE_QUERY_LENGTH), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dts, _total, _results, statuses = run_all(index, params, n_acc, cd, ld, sizes["reps"])
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f}" if dev.type == "cuda"
            else "not measured")

    reads_per_s = n / float(np.median(dts))
    mapped = float((statuses == pl.MAPPED).mean())
    ref_mb = sum(len(s) for s in seqs) / 1e6
    gpu = card(dev)
    sys.stderr.write(
        f"[bench] index={ref_mb:.0f}Mbase/{n_shards}shard build={build_s:.1f}s "
        f"classify_median={np.median(dts):.3f}s reps={[round(d, 3) for d in dts]} "
        f"mapped_frac={mapped:.3f} device={gpu} "
        f"host_syncs_per_batch={'not measured' if syncs is None else len(syncs)} "
        f"sync_sites={syncs} peak_mib={peak} "
        f"window={n_batches}x{batch} resident batches, each dispatched eagerly "
        f"(not one scan); upload and 2-bit pack outside\n")
    print(gpu, flush=True)
    print(json.dumps({
        "metric": "classification_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 2),
        "stat": f"median_of_{sizes['reps']}",
        "quiet_best": round(n / min(dts), 1),
        "loaded_floor": round(n / max(dts), 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

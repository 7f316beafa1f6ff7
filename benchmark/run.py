#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, in this process.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``benchmark/configs/<config>.json``: the
genomes and the index) and a traffic mix (``benchmark/traffic/<mix>.json``:
the reads and the count mode); both are found by name.  A run makes the
genomes and the reads from the seed, builds the index on ``cuda:0``,
warms up every batch shape of the mix, then drives a closed loop for
``--seconds``: one batch in flight through the library call that
``process_sample``, ``run_once`` and the CLI use,
``Classifier.classify`` then ``Classifier.fetch``, over a pool of host
batches that set-up made.  After the window it frees the program, checks
the window's answers against the plain reference (``benchmark/reference``)
and prints one JSON line.  With ``--trace 1`` it also profiles one pass
over the pool and counts its host syncs, and reports the per-layer
metrics (``benchmark/metrics/<metric>.py``) in place of the end-to-end ones.
The process runs torch with one intra-op thread.

It needs a CUDA card: without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "monica_tpu")


def process_start() -> float:
    """This process's start on the wall clock: its age, from its start
    time in ``/proc/self/stat`` (clock ticks since boot) against the
    boot clock now, taken from the wall clock now.  Else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


T_START = process_start()
# wall times of the start's steps before run_cell, for the log
MARKS: dict[str, float] = {}


def load_spec(bench_dir: Path = BENCH) -> dict:
    return json.loads((bench_dir.parent / "BENCHMARK.json").read_text())


def load_part(bench_dir: Path, kind: str, name: str) -> dict:
    """A configuration or a traffic mix, by name."""
    return json.loads((bench_dir / kind / f"{name}.json").read_text())


def metric_reader(bench_dir: Path, name: str):
    """The reader of one metric: ``metrics/<name>.py``'s ``read(record)``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  bench_dir / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    a trace the per-layer ones, each where its ``workloads`` allow."""
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info(device) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    name = torch.cuda.get_device_name(dev)
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=30).stdout.strip().splitlines()
        power = next((ln.split(",")[1].strip() for ln in lines
                      if ln.split(",")[0].strip() == name), lines[0].split(",")[1].strip())
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "not read"
    return {"platform": "gpu", "kind": name, "count": 1, "power_limit": power}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench_dir: Path = BENCH, log=sys.stderr) -> dict:
    """One run of one cell on ``device``; returns the result line's dict.
    The program is imported here, after the caller has checked the card."""
    t_enter = time.time()
    import numpy as np
    import torch

    from benchmark import judge, roofline, tracing, world
    from benchmark.reference import classify as rcls
    from benchmark.reference import index as ridx
    from monica_tpu_torch.align import pipeline as pl
    from monica_tpu_torch.align.runtime import Classifier
    from monica_tpu_torch.index.build import build_index_from_arrays

    t_imported = time.time()
    cell = next(c for c in spec["workloads"] if c["name"] == cell_name)
    config = load_part(bench_dir, "configs", cell["config"])
    traffic = load_part(bench_dir, "traffic", cell["traffic"])
    dev = torch.device(device)
    ix, mode = config["index"], traffic["count_mode"]
    torch.empty(1, device=dev)  # the card's context
    _sync(torch, dev)
    t_context = time.time()
    start = {"to_main_s": MARKS.get("main", t_enter) - t_start,
             "import_torch_s": MARKS.get("torch", t_enter) - MARKS.get("main", t_enter),
             "card_check_s": t_enter - MARKS.get("torch", t_enter),
             "import_program_s": t_imported - t_enter, "context_s": t_context - t_imported}

    # set-up: inputs, index, Classifier, one pass over the pool
    t = time.perf_counter()
    genomes = world.draw_genomes(config, seed, dev)
    pool = world.make_pool(genomes, world.genome_weights(config), traffic, seed)
    _sync(torch, dev)
    inputs_s = time.perf_counter() - t
    t = time.perf_counter()
    built = build_index_from_arrays(genomes, n_shards=config["n_shards"], k=ix["k"], w=ix["w"],
                                    frac=ix["frac"], device=dev)
    _sync(torch, dev)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    clf = Classifier(built, pl.ClassifyParams(**config["classify"]), mode, device=dev)
    _sync(torch, dev)
    upload_s = time.perf_counter() - t
    t = time.perf_counter()
    for b in pool:
        clf.fetch(*clf.classify(b.codes, b.lengths))
    _sync(torch, dev)
    warm_s = time.perf_counter() - t
    # set-up's objects stay out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start

    # the window: a closed loop, one batch in flight
    fetches, lat, front, fetch_s = [], [], [], []
    n_reads = i = 0
    t0 = time.perf_counter()
    while True:
        j = i % len(pool)
        b = pool[j]
        a = time.perf_counter()
        res, counts = clf.classify(b.codes, b.lengths)
        m = time.perf_counter()
        out = clf.fetch(res, counts)
        e = time.perf_counter()
        fetches.append((j, out))
        lat.append(e - a)
        front.append(m - a)
        fetch_s.append(e - m)
        n_reads += b.rows
        i += 1
        if e - t0 >= seconds:
            break
    window_s = e - t0
    del res, counts
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    record = {"setup_s": setup_s, "build_s": build_s, "upload_s": upload_s,
              "window": {"seconds": window_s, "reads": n_reads, "batches": len(lat),
                         "latency_s": lat, "front_s": front, "fetch_s": fetch_s},
              "trace": None, "syncs": None, "sw": None}
    if trace:
        from torch.profiler import record_function

        def run_batch(b):
            with record_function("classify"):
                r = clf.classify(b.codes, b.lengths)
            with record_function("fetch"):
                clf.fetch(*r)

        record["trace"] = tracing.profile_pass(run_batch, pool, dev)
        sites = tracing.sync_sites(lambda: [run_batch(b) for b in pool], dev)
        record["syncs"] = {"batches": len(pool), "sites": sites}
    n_acc = built.meta.n_accessions
    del clf, built
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the plain reference, rebuilt from the same genomes
    t = time.perf_counter()
    rp = rcls.Params(k=ix["k"], w=ix["w"], frac=ix["frac"], **config["classify"])
    rindex = ridx.build(genomes, config["n_shards"], ix["k"], ix["w"], ix["frac"], dev)
    rows = world.check_rows(pool, traffic, seed)
    matching = mode == "matching"
    expected = rcls.classify(rindex, [(b.codes[r], b.lengths[r]) for b, r in zip(pool, rows)],
                             rp, matching, dev)
    numbers, malformed = judge.compare(fetches, pool, rows, expected, n_acc, mode)
    if trace and any("banded_sw" in d[0] for d in record["trace"]["device"]):
        lens = []
        for b in pool:
            for ext in rcls.candidates(rindex, b.codes, b.lengths, rp, matching, dev):
                lens.extend(b.lengths[ext].tolist())
        cells, nbytes = roofline.sw_work(lens, rp.band)
        record["sw"] = {"cells": cells, "bytes": nbytes}
    check_s = time.perf_counter() - t
    correct, check = judge.verdict(numbers, judge.limits(bench_dir, cell_name))
    n_cmp = sum(len(r) for r in rows)
    truth = np.concatenate([b.source[r] for b, r in zip(pool, rows)])
    got = np.concatenate([e[1] for e in expected])
    log.write(f"[{cell_name}] seed={seed} setup_s={setup_s:.3f} "
              + "".join(f"{k}={v:.3f} " for k, v in start.items())
              + f"inputs_s={inputs_s:.3f} "
              f"build_s={build_s:.3f} upload_s={upload_s:.3f} warm_s={warm_s:.3f} "
              f"window_s={window_s:.3f} batches={len(lat)} "
              f"reads={n_reads} pool={len(pool)} batches, {sum(b.rows for b in pool)} reads "
              f"check_s={check_s:.3f} checked_rows={n_cmp} a pass latency_ms p50/p95/p99/max="
              f"{'/'.join(f'{x * 1e3:.2f}' for x in np.percentile(lat, [50, 95, 99, 100]))} "
              f"reference_accuracy={float((got == truth).mean()):.5f}\n")

    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        v = metric_reader(bench_dir, m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct and not malformed), "attempted": len(lat),
              "failed": malformed, "metrics": metrics,
              "device": {**card_info(dev), "memory_peak_bytes": peak}}
    if trace:
        tr = record["trace"]
        result["device"]["busy_s"] = tracing.busy_ns(tr) / 1e9
        result["device"]["window_s"] = tr["window_ns"] / 1e9
        result["breakdown"] = tracing.breakdown(tr)
    result["check"] = check
    for k, v in check.items():
        log.write(f"check {k}={v['value']!r} limit={v['limit']!r}\n")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    MARKS["main"] = time.time()
    spec = load_spec()
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        sys.stderr.write(f"no cell named {args.workload!r} in BENCHMARK.json\n")
        return 2
    import torch

    # one intra-op thread: the host work is numpy and one thread's eager
    # dispatch, and an idle pool of torch's threads spinning beside it
    # took CPU from that thread and widened the spread of the runs' rates
    torch.set_num_threads(1)
    MARKS["torch"] = time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                         f"torch sees {torch.cuda.device_count()}\n")
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"the run loaded {bad}: nothing of JAX or the JAX package may load\n")
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

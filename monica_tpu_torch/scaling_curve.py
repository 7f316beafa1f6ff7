"""Overhead shape of the mesh step on one card — the port's counterpart of
``scripts/scaling_curve.py``.

The JAX script measures how the sharded program's dispatch grows on an
8-device virtual CPU mesh.  Here every mesh is a grid of repeats of the
one ``--device`` (``make_mesh(..., devices=[dev] * n)``): the cells
time-slice one card, so what is measured is the port's mesh dispatch —
the per-cell classify, the hit concatenation and the merge — beside the
same work without a mesh, not a speed-up from more silicon.

As the JAX script: seed 9, 4 random genomes of ``--glen`` (120,000) bp;
reads of 600 bp copied from random genomes at random starts;
``ClassifyParams(n_slots=64)``, count mode ``basic``.

* ``median_dispatch_seconds``: one ``Classifier.classify`` plus the full
  ``fetch`` (which syncs), 1 warm call, then the median of 7.
* Data axis (1, 2, 4, 8) × index 1 over the 1-shard index, each at
  ``--rows_per_device`` rows a cell, beside the same global batch on the
  meshless Classifier (``sharding_overhead``) and the (1, 1) row
  (``weak_scaling_eff``).
* Index axis (1, 1|2|4) over the 4-shard index at one cell's rows.
* ``_sync_batch_schedule`` a sample: in one process the all-gather is
  the identity, so this is the host's plan, pad and schedule merge
  without any collective.

Prints a JSON line a mesh row, the card's name and power limit, then the
``derived`` block as ONE JSON line; writes the JAX script's payload keys
to ``--out``.  ``--quick`` (CPU tests): 20 kb genomes, 8 rows a cell,
2 reps.

    python -m monica_tpu_torch.scaling_curve [--out SCALING_torch.json]
        [--rows_per_device 64] [--glen 120000] [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from monica_tpu_torch import bench
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.parallel import mesh as pm

SEED = 9
READ_LEN = 600
DATA_AXES = (1, 2, 4, 8)
INDEX_AXES = (1, 2, 4)
REPS = 7
QUICK = dict(glen=20_000, rows_per_device=8, reps=2)


def median_dispatch_seconds(clf, codes, lens, reps=REPS):
    """Steady-state per-dispatch wall: dispatch + full result fetch."""
    clf.fetch(*clf.classify(codes, lens))  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        clf.fetch(*clf.classify(codes, lens))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def world(glen: int, seed: int = SEED):
    """The JAX script's genomes and its read draw: (seqs, reads(n))."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, glen).astype(np.uint8) for _ in range(4)]

    def reads(n, L=READ_LEN):
        out = np.zeros((n, L), np.uint8)
        lens = np.full(n, L, np.int32)
        for i in range(n):
            g = seqs[int(rng.integers(0, len(seqs)))]
            s = int(rng.integers(0, len(g) - L))
            out[i] = g[s : s + L]
        return out, lens

    return seqs, reads


def derived(t_single: float, data_rows: list[dict], index_rows: list[dict]) -> dict:
    """The payload's ``derived`` block, the JAX script's formulas."""
    d8 = data_rows[-1]
    return {
        "mesh_entry_overhead": round(data_rows[0]["dispatch_s"] / t_single, 3),
        "sharding_overhead_8x": d8["sharding_overhead"],
        "weak_scaling_eff_8x_cpu_core_bound": d8["weak_scaling_eff"],
        "index4_vs_index1": round(index_rows[-1]["dispatch_s"] / index_rows[0]["dispatch_s"], 3),
    }


def data_row(n_data: int, global_rows: int, t: float, tc: float, data_rows: list[dict]) -> dict:
    return dict(
        n_data=n_data,
        global_rows=global_rows,
        dispatch_s=round(t, 4),
        same_work_meshless_s=round(tc, 4),
        sharding_overhead=round(t / tc, 3),
        weak_scaling_eff=round(data_rows[0]["dispatch_s"] / t, 3) if data_rows else 1.0,
    )


def lockstep_seconds(rows: int, reps: int = 9) -> float:
    """Median seconds of ``_sync_batch_schedule`` over a 6-batch sample."""
    batches = [enc.ReadBatch(np.zeros((rows, 512), np.uint8), np.zeros(rows, np.int32),
                             np.arange(rows, dtype=np.int32)) for _ in range(6)]
    rt._sync_batch_schedule(batches)  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rt._sync_batch_schedule(batches)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.scaling_curve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="SCALING_torch.json")
    ap.add_argument("--rows_per_device", type=int, default=64)
    ap.add_argument("--glen", type=int, default=120_000)
    ap.add_argument("--device", default="cuda", help="torch device of every mesh cell")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    glen, rows, reps = ((QUICK["glen"], QUICK["rows_per_device"], QUICK["reps"]) if args.quick
                        else (args.glen, args.rows_per_device, REPS))

    seqs, reads = world(glen)
    params = pl.ClassifyParams(n_slots=64)

    def classifier(built, mesh=None):
        if mesh is None:
            return rt.Classifier(built, params, count_mode="basic", device=dev)
        return rt.Classifier(built, params, count_mode="basic", mesh=mesh)

    # --- weak scaling over the data axis (index=1, 1 shard) ----------
    built1 = build_index_from_arrays(seqs, n_shards=1, device=dev)
    single = classifier(built1)
    codes1, lens1 = reads(rows)
    t_single = median_dispatch_seconds(single, codes1, lens1, reps)

    data_rows = []
    for n_data in DATA_AXES:
        clf = classifier(built1, pm.make_mesh(n_data, 1, devices=[dev] * n_data))
        codes, lens = reads(rows * n_data)
        t = median_dispatch_seconds(clf, codes, lens, reps)
        # the same global batch on the meshless Classifier: the mesh's
        # overhead is the ratio to this same-work control
        tc = median_dispatch_seconds(single, codes, lens, reps)
        data_rows.append(data_row(n_data, rows * n_data, t, tc, data_rows))
        print(json.dumps(data_rows[-1]), flush=True)

    # --- index-axis overhead (fixed 4 shards, data=1) ----------------
    built4 = build_index_from_arrays(seqs, n_shards=4, device=dev)
    index_rows = []
    for n_index in INDEX_AXES:
        clf = classifier(built4, pm.make_mesh(1, n_index, devices=[dev] * n_index))
        codes, lens = reads(rows)
        t = median_dispatch_seconds(clf, codes, lens, reps)
        index_rows.append(dict(n_index=n_index, shards_per_rank=len(built4.shards) // n_index,
                               dispatch_s=round(t, 4)))
        print(json.dumps(index_rows[-1]), flush=True)

    payload = {
        "what": (
            "Measured mesh-step overhead shape on meshes of repeats of one device "
            f"({dev}): the cells time-slice it, so the overhead is the port's mesh "
            "dispatch (per-cell classify, hit concatenation, merge), not a multi-card "
            "rate; the overhead FRACTIONS feed the PODSCALE model.  The lockstep "
            "cost is one process's: its all-gather is the identity, so it times the "
            "host's plan, pad and schedule merge."
        ),
        "rows_per_device": rows,
        "meshless_single_dispatch_s": round(t_single, 4),
        "data_axis_weak_scaling": data_rows,
        "index_axis": index_rows,
        "lockstep_schedule_s_per_sample": round(lockstep_seconds(rows), 5),
        "derived": derived(t_single, data_rows, index_rows),
        "reading_guide": (
            "sharding_overhead (mesh dispatch vs the SAME global batch meshless) is what "
            "the mesh adds to the same work: each cell classifies its rows alone, so a "
            "data axis of n cells makes n times the launches of one batch.  On one card "
            "the cells share its silicon, so weak_scaling_eff falls as 1/n for work the "
            "card cannot overlap; distinct cards would each take their own rows."
        ),
    }
    print(bench.card(dev), flush=True)
    print(json.dumps(payload["derived"]), flush=True)
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

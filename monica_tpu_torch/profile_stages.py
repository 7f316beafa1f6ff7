"""Per-stage timing of the classify pipeline on one card — the port's
counterpart of ``scripts/profile_stages.py``.

The workload is ``bench.py``'s (seed 3, the 64 Mbase Zymo community in
one shard built on ``--device``, ``--small``: 5 × 1 Mb), with 8 resident
batches of 2048 × 1 kb reads and ``params_for_bucket``'s params
(``n_slots`` 64 at 1 kb, rescue-mode extension).  The pipeline is timed
by enabling its stages one after another, each variant through
``bench.time_scalar`` (uploaded once, 1 warm-up, 5 timed reps):

    sketch        sketch_batch
    +lookup       + lookup_anchors
    +chain        + chain_votes
    full(noext)   classify_batch_grouped without extension
    full(rescue)  classify_batch_grouped

Every output of every variant is summed into one live float32 scalar
(:func:`live`), as the JAX script's ``live()`` keeps every stage output
out of XLA's dead-code pruning; the numbers stay comparable with its.

Prints a line per variant (the median ms a batch, reads/s and the reps),
then a line per variant with its launches over one batch on the card:
CUDA kernels, copies and memsets from ``torch.profiler``'s device
events, and the SW kernels from ``_native.LAUNCHES``; then the card's
name and power limit and ONE JSON line, ``{"ms_per_batch_2048": {...}}``
with the JAX script's keys (the median of the 5 reps where the JAX
script timed one).  ``--quick`` (CPU tests): genomes at 1/100 of their
length, 2 batches of 64 reads, 2 reps; launches are not measured off the
card.

    python -m monica_tpu_torch.profile_stages [--small] [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from monica_tpu_torch import bench
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.ops import _native
from monica_tpu_torch.ops import chain as ch
from monica_tpu_torch.ops import lookup as lk
from monica_tpu_torch.utils.metrics import is_span

READ_LEN = 1024
FULL = dict(scale=1.0, batch=2048, n_batches=8, reps=5)
QUICK = dict(scale=0.01, batch=64, n_batches=2, reps=2)
VARIANTS = ("sketch", "+lookup", "+chain", "full(noext)", "full(rescue)")


def leaves(out) -> list[torch.Tensor]:
    """Every tensor of a (nested) tuple output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in leaves(o)]


def live(out) -> torch.Tensor:
    """Sum every leaf as float32, so no stage output is dead."""
    return sum(x.to(torch.float32).sum() for x in leaves(out))


def stages(index, params, n_acc) -> dict:
    """The five cumulative variants over a one-shard index (one group of
    one): name -> f(codes, lengths)."""
    noext = params._replace(extend=False)

    def lookup(c, l):
        return lk.lookup_anchors(index[0].mz_rows[0], *pl.sketch_batch(c, l, params),
                                 tag_bits=params.tag_bits, bucket_len=c.shape[1],
                                 anchors_per_seed=params.anchors_per_seed)

    return {
        "sketch": lambda c, l: pl.sketch_batch(c, l, params),
        "+lookup": lookup,
        "+chain": lambda c, l: ch.chain_votes(*lookup(c, l)),
        "full(noext)": lambda c, l: pl.classify_batch_grouped(index, c, l, noext, n_acc),
        "full(rescue)": lambda c, l: pl.classify_batch_grouped(index, c, l, params, n_acc),
    }


def launches(stage, codes: torch.Tensor, lengths: torch.Tensor) -> dict | None:
    """Launches of one call of ``stage`` on one batch (:func:`count_launches`)."""
    return count_launches(lambda: stage(codes, lengths), codes.device)


def count_launches(fn, device) -> dict | None:
    """Launches of one call of ``fn()``: CUDA kernels, copies and memsets
    (``torch.profiler`` device events) and the SW kernels
    (``_native.LAUNCHES``); None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    before = sum(_native.LAUNCHES.values())
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not is_span(e.name)]
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return {"kernels": len(names) - copies, "copies": copies,
            "sw": sum(_native.LAUNCHES.values()) - before}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.profile_stages",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="5 x 1 Mb genomes in place of Zymo")
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    sizes = QUICK if args.quick else FULL
    batch, n_batches = sizes["batch"], sizes["n_batches"]

    rng = np.random.default_rng(bench.SEED)
    t0 = time.time()
    seqs, _ = bench.genomes("small" if args.small else "zymo", rng, sizes["scale"])
    built = build_index_from_arrays(seqs, n_shards=1, device=dev)
    index, params, n_acc = bench.prepare(built, dev)
    print(f"build {time.time() - t0:.1f}s rows={tuple(index[0].mz_rows.shape[1:])}", flush=True)

    codes = bench.make_reads(seqs, rng, batch * n_batches).reshape(n_batches, batch, READ_LEN)
    cd, ld = bench.resident(codes, np.full((n_batches, batch), READ_LEN, np.int32), dev)
    gpu = bench.card(dev)
    print(f"device={gpu} index={sum(len(s) for s in seqs) / 1e6:.0f}Mbase "
          f"B={batch}x{n_batches} L={READ_LEN} n_slots={params.n_slots} "
          f"a={params.anchors_per_seed} extend_mode={params.extend_mode}", flush=True)

    results, counted = {}, {}
    for name, stage in stages(index, params, n_acc).items():
        dts, _ = bench.time_scalar(lambda c, l, stage=stage: live(stage(c, l)), cd, ld,
                                   sizes["reps"])
        ms = float(np.median(dts)) / n_batches * 1e3
        results[name] = round(ms, 2)
        print(f"{name:22s} {ms:8.2f} ms/batch  {batch * n_batches / np.median(dts):10.0f} reads/s"
              f"  reps_ms_per_batch={[round(d / n_batches * 1e3, 3) for d in dts]}", flush=True)
        counted[name] = launches(stage, cd[0], ld[0])
    for name, n in counted.items():
        print(f"launches {name:22s} " + ("not measured (no card)" if n is None else
                                         " ".join(f"{k}={v}" for k, v in n.items())), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ms_per_batch_2048": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

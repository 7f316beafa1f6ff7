"""(n_slots, frac, extend) grid timing of the classify step on one card —
the port's counterpart of ``scripts/exp_knobs.py``.

As the JAX script: 5 × 1 Mb random genomes (seed 0), 8 distinct resident
batches of 2048 × 1,024 bp reads drawn from them (seed 3, 5%
substitutions); the index built on ``--device`` at ``frac`` 1.0 and
0.5, and for each, ``n_slots`` S in (128, 96, 64) × ``extend`` in
(False, True) through ``classify_group`` on the one-shard group.  Each
grid point runs through ``bench.time_scalar`` (uploaded once, 1 warm-up, then the median of
5 reps where the JAX script timed one), its first output (``acc_id``)
summed into a live scalar as the JAX script sums it.  Accuracy of a
candidate default is ``concordance``'s to judge, not this grid's.

Prints the JAX script's lines: a ``--- frac=...`` line for each index
and one line a grid point (ms a batch and reads/s), then the card's name
and power limit.  ``--quick`` (CPU tests): 5 × 20 kb genomes, 2 batches
of 64 reads, 2 reps.

    python -m monica_tpu_torch.exp_knobs [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from monica_tpu_torch import bench
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import build_index_from_arrays

READ_LEN = 1024
N_GENOMES = 5
FULL = dict(genome_len=1_000_000, batch=2048, n_batches=8, reps=5)
QUICK = dict(genome_len=20_000, batch=64, n_batches=2, reps=2)
GRID = [(S, ext) for S in (128, 96, 64) for ext in (False, True)]


def workload(genome_len: int, batch: int, n_batches: int):
    """The JAX script's draws: (genomes, (R, B, L) read codes)."""
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 4, size=genome_len).astype(np.uint8) for _ in range(N_GENOMES)]
    r2 = np.random.default_rng(3)
    codes = np.stack([seqs[r2.integers(0, N_GENOMES)][s : s + READ_LEN]
                      for s in r2.integers(0, genome_len - READ_LEN, batch * n_batches)])
    m = r2.random(codes.shape) < 0.05
    codes[m] = r2.integers(0, 4, int(m.sum()))
    return seqs, codes.reshape(n_batches, batch, READ_LEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.exp_knobs",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    sizes = QUICK if args.quick else FULL
    batch, n_batches = sizes["batch"], sizes["n_batches"]
    seqs, codes = workload(sizes["genome_len"], batch, n_batches)
    cd, ld = bench.resident(codes, np.full((n_batches, batch), READ_LEN, np.int32), dev)

    for frac in (1.0, 0.5):
        built = build_index_from_arrays(seqs, frac=frac, device=dev)
        index, base, _ = bench.prepare(built, dev)
        print(f"--- frac={frac} rows={index[0].mz_rows.shape[1]:,}x{index[0].mz_rows.shape[2]}",
              flush=True)
        for S, ext in GRID:
            p = pl.ClassifyParams(n_slots=S, tag_bits=base.tag_bits, frac=frac, extend=ext)
            dts, _ = bench.time_scalar(  # the first output (acc_id) kept live, as the JAX script
                lambda c, l, p=p: pl.classify_group(index[0], c, l, p).acc_id.float().sum(),
                cd, ld, sizes["reps"])
            ms = float(np.median(dts)) / n_batches * 1000.0
            print(f"{f'S={S} frac={frac} ext={int(ext)}':34s}: {ms:7.2f} ms/batch  "
                  f"({batch / ms * 1000:,.0f} reads/s)", flush=True)
    print(bench.card(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

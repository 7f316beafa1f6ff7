"""High-error (R9-era) sensitivity and rescue-tier demand — the port's
counterpart of ``scripts/sensitivity_r9.py``.

Per error profile and read length it measures:

* the rescue-slot demand: how many reads of each batch are rescue
  candidates, how many of them the static B/8 budget would leave out,
  and which adaptive tier (skip, B/8, B/2, B) each batch takes
  (``measure_saturation``, the host mirror of the candidacy in
  ``pipeline.classify_group``);
* accuracy and precision through ``evaluation.evaluate`` for the default
  settings and two ablations: ``rescue_min_votes=2`` (no single-anchor
  rescue) and ``rescue_min_cov=0`` (no coverage floor).

Gate (the JAX script's): r9_old (8/5/5%) at read lengths >= 1 kb,
accuracy >= 0.85 and precision >= 0.995.

    python -m monica_tpu_torch.sensitivity_r9 [--device cuda] [--quick] [--out F]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.ops import chain as ch
from monica_tpu_torch.ops import lookup as lk

PROFILES = [
    ("r10_sup", (0.01, 0.005, 0.005)),
    ("r10_fast", (0.03, 0.02, 0.02)),
    ("r9_hac", (0.05, 0.03, 0.03)),
    ("r9_old", (0.08, 0.05, 0.05)),
]
SETTINGS = [
    ("default", pl.ClassifyParams()),
    ("no_single_anchor(mv2)", pl.ClassifyParams(rescue_min_votes=2)),
    ("no_coverage_floor", pl.ClassifyParams(rescue_min_cov=0.0)),
]


def measure_saturation(built, seqs, params, error, read_len: int, n_reads: int, batch: int, *,
                       device) -> dict:
    """Rescue-slot demand per batch of simulated reads (seed 5): the
    sketch, seed lookup, chain votes and mapq on ``device``, then the
    candidacy and the tier pick of ``pipeline.classify_group`` counted on
    the host."""
    if len(built.shards) != 1:
        raise ValueError("measure_saturation takes a one-shard index")
    rng = np.random.default_rng(5)
    sub, ins, dele = error
    labels = rng.integers(0, len(seqs), n_reads)
    rcs = rng.random(n_reads) < 0.5
    codes = np.full((n_reads, read_len), 4, np.uint8)
    lens = np.zeros(n_reads, np.int32)
    for i in range(n_reads):
        r = ev.simulate_read_codes(rng, seqs[labels[i]], read_len, sub, ins, dele, rcs[i])
        codes[i, : len(r)] = r
        lens[i] = len(r)

    clf = rt.Classifier(built, params, device=device)
    p = pl.params_for_bucket(clf.params, read_len)
    tiers = {"skip": 0, "b8": 0, "b2": 0, "full": 0}
    n_cand_total = 0
    sat_static = 0  # candidates beyond the static B/8 budget
    for s0 in range(0, n_reads, batch):
        sl = slice(s0, min(s0 + batch, n_reads))
        cj = torch.from_numpy(codes[sl]).to(device)
        lj = torch.from_numpy(lens[sl]).to(device)
        qh, qp, qs, qv = pl.sketch_batch(cj, lj, p)
        key, diag, rpos, fpos = lk.lookup_anchors(
            clf.index[0].mz_rows[0], qh, qp, qs, qv, tag_bits=p.tag_bits, bucket_len=read_len,
            anchors_per_seed=p.anchors_per_seed)
        res = ch.chain_votes(key, diag, rpos, fpos, max_run=min(128, p.n_slots))
        mapq = ch.mapq_from_votes(res.f1, res.f2)
        passed = ((mapq >= p.mapping_quality) & (res.f1 >= p.min_votes) & (lj > 0)).cpu().numpy()
        f1, f2 = res.f1.cpu().numpy(), res.f2.cpu().numpy()
        cand = ~passed & (f1 >= p.rescue_min_votes) & (f2 * 2 <= f1) & (lens[sl] > 0)
        n_cand = int(cand.sum())
        B = cj.shape[0]
        n8 = max(int(B * p.rescue_frac), 1)
        n_cand_total += n_cand
        sat_static += max(n_cand - n8, 0)
        if n_cand == 0:
            tiers["skip"] += 1
        elif n_cand <= n8:
            tiers["b8"] += 1
        elif n_cand <= B // 2:
            tiers["b2"] += 1
        else:
            tiers["full"] += 1
    return dict(candidates=n_cand_total, static_budget_overflow=sat_static, tier_usage=tiers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.sensitivity_r9",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true",
                    help="4 genomes of 120 kb, 512 reads, 300 and 1,000 bp")
    ap.add_argument("--out", default="SENSITIVITY_torch.json")
    ap.add_argument("--n_genomes", type=int, default=8)
    ap.add_argument("--glen", type=int, default=500_000)
    ap.add_argument("--n_reads", type=int, default=1024)
    args = ap.parse_args(argv)
    if args.quick:
        args.n_genomes, args.glen, args.n_reads = 4, 120_000, 512

    seqs = ev.mock_community(np.random.default_rng(11), args.n_genomes, args.glen)
    built = build_index_from_arrays(seqs, device=args.device)
    read_lens = [300, 1000] if args.quick else [300, 1000, 5000]

    rows, sat_rows = [], []
    for pname, error in PROFILES:
        for L in read_lens:
            sat = measure_saturation(built, seqs, pl.ClassifyParams(), error, L, args.n_reads,
                                     512, device=args.device)
            sat["profile"], sat["read_len"] = pname, L
            sat_rows.append(sat)
            print(json.dumps(sat), flush=True)
            for sname, params in SETTINGS:
                t0 = time.time()
                r = ev.evaluate(built, seqs, params, np.random.default_rng(5),
                                n_reads=args.n_reads, read_len=L, error=error,
                                device=args.device)
                r.settings = dict(setting=sname, profile=pname, read_len=L)
                row = r.row()
                row["seconds"] = round(time.time() - t0, 1)
                rows.append(row)
                print(json.dumps(row), flush=True)

    gate = all(r["accuracy"] >= 0.85 and (r["precision"] is None or r["precision"] >= 0.995)
               for r in rows
               if r["setting"] == "default" and r["profile"] == "r9_old" and r["read_len"] >= 1000)
    artifact = dict(
        round=5,
        what=("R9-era sensitivity closure: adaptive rescue tiers (B/8 -> B/2 -> B by candidate "
              "count), single-anchor candidacy (rescue_min_votes=1), and a local-alignment "
              "coverage floor (rescue_min_cov=0.5).  r4 baseline (static B/8 budget, mv=2): "
              "r9_old accuracy 0.32/0.49/0.53 at 300/1000/5000 bp (CONCORDANCE_r04.json)."),
        gate=dict(profile="r9_old", read_len=">=1000", acc=0.85, precision=0.995, passed=gate),
        config=dict(n_genomes=args.n_genomes, glen=args.glen, n_reads=args.n_reads,
                    quick=args.quick),
        saturation=sat_rows,
        rows=rows,
    )
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(json.dumps(dict(gate_pass=gate, out=args.out)))
    return 0 if gate else 1


if __name__ == "__main__":
    sys.exit(main())

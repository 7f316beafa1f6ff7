"""Quantification accuracy — the port's counterpart of
``scripts/abundance_accuracy.py``: the estimated relative abundances
against the true composition of a simulated flowcell.

Route accuracy per read (``concordance``, ``parity``) measures the
classification; the product is the abundance table.  A skewed mixture
of 6 genomes of staggered lengths (400, 400, 200, 200, 100 and 100 kb,
a 2 kb block shared by the first two) is sampled at known proportions
with nanopore error profiles into one FASTQ sample, which goes through
the product path (``Classifier`` in ``query_length`` mode ->
``run_once`` -> ``AbundanceState`` -> ``normalize``) on ``--device``.
The BPM vector is compared with the truth taken from the bases the
flowcell really holds per genome.

Metrics per profile: the L1 composition error, the largest relative
error over the taxa with a true share of at least 1%, and the
unassigned share (unmapped and ambiguous reads).  Gate (the JAX
script's): L1 <= 0.05 and relative error <= 10% on r10_sup, r10_fast
and r9_hac; r9_old is reported, not gated.

    python -m monica_tpu_torch.abundance_accuracy [--device cuda] [--quick] [--n_reads N] [--out F]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.stats.abundance import AbundanceState, normalize

PROFILES = [
    ("r10_sup", (0.01, 0.005, 0.005)),
    ("r10_fast", (0.03, 0.02, 0.02)),
    ("r9_hac", (0.05, 0.03, 0.03)),
    ("r9_old", (0.08, 0.05, 0.05)),
]
GATED = ("r10_sup", "r10_fast", "r9_hac")
L1_TARGET = 0.05
REL_TARGET = 0.10
GENOME_LENGTHS = [400_000, 400_000, 200_000, 200_000, 100_000, 100_000]
MIXTURE = np.array([0.4, 0.25, 0.15, 0.1, 0.07, 0.03])
_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def community(genome_lengths) -> list[np.ndarray]:
    """The genomes (seed 11), with the 2 kb block shared by the first
    two: genuinely ambiguous mass, as in the concordance community."""
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, g).astype(np.uint8) for g in genome_lengths]
    block = rng.integers(0, 4, 2000).astype(np.uint8)
    seqs[0][10_000:12_000] = block
    seqs[1][50_000:52_000] = block
    return seqs


def run_profile(built, seqs, mixture, error, n_reads: int, read_len: int, workdir, *,
                device) -> dict:
    """One profile: simulate ``mix.fastq`` (seed 13) under ``workdir``,
    classify it on ``device`` and score the normalized table."""
    rng = np.random.default_rng(13)
    sub, ins, dele = error
    glens = np.array([len(s) for s in seqs], dtype=np.float64)
    labels = rng.choice(len(seqs), size=n_reads, p=np.asarray(mixture))
    q = Path(workdir) / "q"
    q.mkdir(parents=True, exist_ok=True)
    emitted = np.zeros(len(seqs), dtype=np.float64)  # bases per genome
    with open(q / "mix.fastq", "wb") as fh:
        for i in range(n_reads):
            r = ev.simulate_read_codes(rng, seqs[labels[i]], read_len, sub, ins, dele,
                                       bool(rng.random() < 0.5))
            emitted[labels[i]] += len(r)
            fh.write(b"@read%d mix\n%s\n+\n%s\n" % (i, _LUT[r].tobytes(), b"I" * len(r)))
    # the truth is the realized flowcell's, not the sampling distribution
    # (the multinomial draw carries a few percent of per-taxon noise at
    # these depths): query_length counts are the bases per genome, BPB
    # divides by the genome length, BPM renormalizes
    truth = emitted / glens
    truth = truth / truth.sum()
    out = Path(workdir) / "o"
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="query_length", device=device)
    rep = rt.run_once(clf, q, out)[0]
    state = AbundanceState.load(out, built.meta.n_accessions)
    est = normalize(state, built.meta.genome_lengths)["mix"]
    major = truth >= 0.01
    return dict(
        n_reads=n_reads,
        l1_error=round(float(np.abs(est - truth).sum()), 4),
        max_rel_error_major_taxa=round(
            float(np.max(np.abs(est[major] - truth[major]) / truth[major])), 4),
        unassigned_frac=round((rep.n_unmapped + rep.n_ambiguous) / max(rep.n_reads, 1), 4),
        est=[round(float(x), 4) for x in est],
        truth=[round(float(x), 4) for x in truth],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.abundance_accuracy",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device of the build and classify")
    ap.add_argument("--quick", action="store_true", help="half-size genomes, 2,048 reads")
    ap.add_argument("--out", default="ABUNDANCE_torch.json")
    ap.add_argument("--n_reads", type=int, default=8192)
    ap.add_argument("--read_len", type=int, default=1000)
    args = ap.parse_args(argv)
    if args.quick and args.n_reads == ap.get_default("n_reads"):
        args.n_reads = 2048

    glens = [g // 2 for g in GENOME_LENGTHS] if args.quick else GENOME_LENGTHS
    seqs = community(glens)
    built = build_index_from_arrays(seqs, device=args.device)

    rows = []
    for pname, error in PROFILES:
        with tempfile.TemporaryDirectory() as td:
            t0 = time.time()
            r = run_profile(built, seqs, MIXTURE, error, args.n_reads, args.read_len, td,
                            device=args.device)
            r["profile"] = pname
            r["seconds"] = round(time.time() - t0, 1)
            rows.append(r)
            print(json.dumps(r), flush=True)

    ok = all(r["l1_error"] <= L1_TARGET and r["max_rel_error_major_taxa"] <= REL_TARGET
             for r in rows if r["profile"] in GATED)
    payload = dict(
        what=("End-to-end QUANTIFICATION accuracy: BPM composition estimates (product path, "
              "query_length mode) vs known mixture truth on a skewed 6-genome community with "
              "length-staggered genomes and conserved blocks."),
        gate=dict(profiles=list(GATED), l1=L1_TARGET, max_rel_major=REL_TARGET, passed=ok),
        mixture=[float(x) for x in MIXTURE],
        genome_lengths=glens,
        rows=rows,
    )
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps(dict(gate_pass=ok, out=args.out)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

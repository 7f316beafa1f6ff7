"""Accuracy harness entry point — the port's counterpart of
``scripts/concordance.py``: classification accuracy against the truth
over nanopore error profiles, read lengths and pipeline settings, plus
strain pairs over an ANI sweep and a repeat-rich, homopolymer-biased
community, all through the port's ``Classifier`` on ``--device``.

Gating (the same as the JAX package's): exit 1 when the worst accuracy of
the DEFAULT settings over the supported profiles (<= r9_hac) is below
0.95, when r9_old (8/5/5% legacy chemistry) is below 0.85 accuracy or
0.995 precision at read lengths >= 1 kb, or when the strain and
hard-community precision gate fails.  Sweep rows (degraded knobs) are
reported but never gate; ``--quick`` sizes are a CPU convenience whose
accuracy is capped by the shared blocks, so they are not gated.

    python -m monica_tpu_torch.concordance --device cuda [--quick] [--sweep] [--out F]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import build_index_from_arrays

TARGET = 0.95
GATED_PROFILES = ("r10_sup", "r10_fast", "r9_hac")
R9_OLD_ACC_TARGET = 0.85  # at read_len >= 1000
R9_OLD_PREC_TARGET = 0.995
PRECISION_TARGET = 0.995
# nanopore-like error profiles, (sub, ins, del), roughly R9 -> R10.4
PROFILES = [
    ("r10_sup", (0.01, 0.005, 0.005)),
    ("r10_fast", (0.03, 0.02, 0.02)),
    ("r9_hac", (0.05, 0.03, 0.03)),
    ("r9_old", (0.08, 0.05, 0.05)),
]


def sweep_settings() -> list:
    """(name, params, frac) of the sweep rows."""
    P = pl.ClassifyParams
    return [
        ("slots64", P(n_slots=64), 1.0),
        ("slots96", P(n_slots=96), 1.0),
        ("slots64_a2", P(n_slots=64, anchors_per_seed=2), 1.0),
        ("slots96_a2", P(n_slots=96, anchors_per_seed=2), 1.0),
        ("a1", P(anchors_per_seed=1), 1.0),  # throughput knob; watch precision
        ("slots64_a1", P(n_slots=64, anchors_per_seed=1), 1.0),
        ("frac0.5", P(), 0.5),
        ("frac0.5_slots64", P(n_slots=64), 0.5),
        ("frac0.25", P(), 0.25),
        ("frac0.25_slots64", P(n_slots=64), 0.25),
    ]


def strain_gate(strain_rows: list, quick: bool) -> bool:
    """Precision >= PRECISION_TARGET on every strain row at ANI <= 99%
    (and at least a quarter of the reads mapped at ANI <= 97%, so the gate
    cannot pass because everything went ambiguous); wrong calls <= 1% of
    the reads at ANI > 99.5%; the hard community's precision (not gated
    at --quick sizes, where shared blocks are ~20% of the bases)."""
    ok = True
    for r in strain_rows:
        ani = r.get("ani")
        if ani is not None and ani <= 0.97:
            ok &= r["mapped"] >= r["reads"] * 0.25
            ok &= r["precision"] is not None and r["precision"] >= PRECISION_TARGET
        elif ani is not None and ani <= 0.99 and r["precision"] is not None:
            ok &= r["precision"] >= PRECISION_TARGET
        if ani is not None and ani > 0.995:
            ok &= r["wrong"] <= max(r["reads"] * 0.01, 1)
        if r.get("kind") == "hard_community" and r["precision"] is not None and not quick:
            ok &= r["precision"] >= PRECISION_TARGET
    return bool(ok)


def run(device, quick: bool = False, sweep: bool = False, n_genomes: int = 8,
        glen: int = 500_000, n_reads: int = 1024, echo=print) -> dict:
    """Every row and the verdict, as the JSON artifact holds them."""
    if quick:
        n_genomes, glen, n_reads = 4, 60_000, 192
    seqs = ev.mock_community(np.random.default_rng(11), n_genomes, glen)
    indexes: dict[float, object] = {}  # one index per frac (an index-side property)

    def index_for(frac: float):
        if frac not in indexes:
            indexes[frac] = build_index_from_arrays(seqs, frac=frac, device=device)
        return indexes[frac]

    read_lens = [300, 1000] if quick else [300, 1000, 5000]
    settings = [("default", pl.ClassifyParams(), 1.0)] + (sweep_settings() if sweep else [])
    rows = []
    for sname, params, frac in settings:
        built = index_for(frac)
        for pname, error in PROFILES:
            for L in read_lens:
                r = ev.evaluate(built, seqs, params, np.random.default_rng(5), n_reads=n_reads,
                                read_len=L, error=error, device=device)
                r.settings = dict(setting=sname, profile=pname, read_len=L)
                rows.append(r.row())
                echo(json.dumps(rows[-1]))

    strain_rows = []
    sg, sr = (120_000, 128) if quick else (1_000_000, 512)
    for div in (0.05, 0.03, 0.01, 0.005, 0.002):
        r = ev.strain_pair_eval(np.random.default_rng(17), pl.ClassifyParams(), genome_len=sg,
                                divergence=div, n_reads=sr, error=(0.05, 0.03, 0.03),
                                device=device)
        strain_rows.append(r.row())
        echo(json.dumps(strain_rows[-1]))
    hard_seqs = ev.mock_community(np.random.default_rng(19), n_genomes, glen,
                                  tandem_repeats=2, dispersed_repeats=2)
    hard_built = build_index_from_arrays(hard_seqs, device=device)
    for pname, error in [("r10_fast", (0.03, 0.02, 0.02)), ("r9_hac", (0.05, 0.03, 0.03))]:
        r = ev.evaluate(hard_built, hard_seqs, pl.ClassifyParams(), np.random.default_rng(5),
                        n_reads=n_reads, read_len=1000, error=error, hp_bias=4.0, device=device)
        r.settings = dict(setting="default", kind="hard_community", profile=pname,
                          read_len=1000, hp_bias=4.0, repeats=True)
        strain_rows.append(r.row())
        echo(json.dumps(strain_rows[-1]))

    strain_ok = strain_gate(strain_rows, quick)
    worst = min(r["accuracy"] for r in rows
                if r["setting"] == "default" and r["profile"] in GATED_PROFILES)
    r9_ok = all(r["accuracy"] >= R9_OLD_ACC_TARGET
                and (r["precision"] is None or r["precision"] >= R9_OLD_PREC_TARGET)
                for r in rows
                if r["setting"] == "default" and r["profile"] == "r9_old"
                and r["read_len"] >= 1000)
    ok = worst >= TARGET and strain_ok and r9_ok
    verdict = ("CEILING-LIMITED (quick mode: shared-block ceiling ~0.93, not gated)" if quick
               else "PASS" if ok else "FAIL")
    echo(f"\nworst-case DEFAULT accuracy (profiles <= r9_hac): {worst:.4f} (target >= {TARGET}); "
         f"r9_old gate (acc >= {R9_OLD_ACC_TARGET}, prec >= {R9_OLD_PREC_TARGET} at >= 1 kb): "
         f"{'PASS' if r9_ok else 'FAIL'}; strain/hard-instance precision gate "
         f"(>= {PRECISION_TARGET} at ANI <= 99%, no guessing above): "
         f"{'PASS' if strain_ok else 'FAIL'} -> {verdict}")
    return {
        "target": TARGET,
        "gated_profiles": list(GATED_PROFILES),
        "worst_gated_accuracy": worst,
        "r9_old_gate": {"acc_target": R9_OLD_ACC_TARGET, "prec_target": R9_OLD_PREC_TARGET,
                        "pass": r9_ok},
        "precision_target": PRECISION_TARGET,
        "strain_gate": "PASS" if strain_ok else "FAIL",
        "verdict": verdict,
        "config": {"n_genomes": n_genomes, "glen": glen, "n_reads": n_reads, "quick": quick,
                   "device": str(device)},
        "rows": rows,
        "strain_rows": strain_rows,
        "passed": bool((ok or quick) and strain_ok and (r9_ok or quick)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.concordance",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", required=True, help="torch device of every build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU-friendly)")
    ap.add_argument("--sweep", action="store_true", help="sweep pipeline knobs")
    ap.add_argument("--n_genomes", type=int, default=8)
    ap.add_argument("--glen", type=int, default=500_000)
    ap.add_argument("--n_reads", type=int, default=1024)
    ap.add_argument("--out", help="write the JSON artifact (rows + verdict) here")
    args = ap.parse_args(argv)
    out = run(args.device, quick=args.quick, sweep=args.sweep, n_genomes=args.n_genomes,
              glen=args.glen, n_reads=args.n_reads)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"artifact written to {args.out}")
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())

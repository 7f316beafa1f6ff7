#!/usr/bin/env python3
"""The control of the correctness check: the plain reference put in the
program's place, one precision lower than the configuration states (the
vote statistics in bfloat16 for float32, the banded SW in int16 for
int32), on a cell's own inputs and sampled rows, judged by the check a
run makes (``judge``).  It has to come out not correct, or the check
could not tell such a program from a sound one.  The benchmark's runs
never run it.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed.  It needs a CUDA card, as the cell does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402


def control_reading(spec: dict, cell_name: str, seed: int, device,
                    bench_dir: Path = run.BENCH) -> dict:
    """The check's verdict on the control: the low-precision answers at
    the cell's sampled rows, handed to ``judge`` as the fetches of one
    pass over the pool (each batch's other rows unmapped, its counts
    those of its own answers), against the exact reference."""
    import numpy as np
    import torch

    from benchmark import judge, world
    from benchmark.reference import classify as rcls
    from benchmark.reference import index as ridx

    cell = next(c for c in spec["workloads"] if c["name"] == cell_name)
    config = run.load_part(bench_dir, "configs", cell["config"])
    traffic = run.load_part(bench_dir, "traffic", cell["traffic"])
    ix, mode = config["index"], traffic["count_mode"]
    genomes = world.draw_genomes(config, seed, device)
    pool = world.make_pool(genomes, world.genome_weights(config), traffic, seed)
    rows = world.check_rows(pool, traffic, seed)
    p = rcls.Params(k=ix["k"], w=ix["w"], frac=ix["frac"], **config["classify"])
    rindex = ridx.build(genomes, config["n_shards"], ix["k"], ix["w"], ix["frac"], device)
    sample = [(b.codes[r], b.lengths[r]) for b, r in zip(pool, rows)]
    matching = mode == "matching"
    exact = rcls.classify(rindex, sample, p, matching, device)
    low = rcls.classify(rindex, sample, p, matching, device, fdt=torch.bfloat16, sw_int16=True)
    fetches = []
    for j, (b, r, ans) in enumerate(zip(pool, rows, low)):
        st = np.full(b.rows, rcls.UNMAPPED, np.int32)
        ac = np.full(b.rows, -1, np.int32)
        ml = np.zeros(b.rows, np.int32)
        st[r], ac[r], ml[r] = ans
        cnt = rcls.count_reads(st, ac, ml, b.lengths, rindex.n_accessions, mode)
        fetches.append((j, (st, ac, ml, cnt)))
    numbers, malformed = judge.compare(fetches, pool, rows, exact, rindex.n_accessions, mode)
    correct, check = judge.verdict(numbers, judge.limits(bench_dir, cell_name))
    return {"cell": cell_name, "seed": seed, "rows": sum(len(r) for r in rows),
            "correct": bool(correct and not malformed), "check": check}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("the control runs on a CUDA card\n")
        return 2
    spec = run.load_spec()
    for seed in args.seeds:
        print(json.dumps(control_reading(spec, args.workload, seed, "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How ``correct`` is decided: the program's answers from the measured
window against the plain reference's.

* ``read_mismatch``: the share of compared answers (a fetched batch's
  sampled rows, every fetch of the window) whose status, accession id
  or matched length differs from the reference's answer for that read;
  a fetch of the wrong shape counts every sampled row as different.
* ``count_mismatch``: the share of the window's fetches whose
  per-accession counts differ from the counts of their own per-read
  answers (the count layer, which the sampled rows alone cannot see).

The limits come from ``limits/<cell>.json``, else ``limits/default.json``,
set from the readings that ``PERF.md`` gives.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from benchmark.reference.classify import count_reads

NUMBERS = ("read_mismatch", "count_mismatch")


def limits(bench_dir: Path, cell: str) -> dict:
    f = bench_dir / "limits" / f"{cell}.json"
    return json.loads((f if f.is_file() else bench_dir / "limits" / "default.json").read_text())


def compare(fetches, pool, rows, expected, n_accessions: int, mode: str) -> tuple[dict, int]:
    """``fetches``: (pool index, (status, acc_id, mlen, counts)) of each
    batch of the window; ``rows``/``expected``: the sampled rows of each
    pool batch and the reference's (status, acc_id, mlen) on them.
    Returns the numbers and the count of malformed fetches."""
    n_cmp = n_bad = n_count_bad = malformed = 0
    for j, (st, ac, ml, cnt) in fetches:
        r = rows[j]
        n_cmp += len(r)
        if st.shape != pool[j].lengths.shape or cnt.shape != (n_accessions,):
            malformed += 1
            n_bad += len(r)
            n_count_bad += 1
            continue
        es, ea, em = expected[j]
        n_bad += int(((st[r] != es) | (ac[r] != ea) | (ml[r] != em)).sum())
        own = count_reads(st, ac, ml, pool[j].lengths, n_accessions, mode)
        n_count_bad += int(not np.array_equal(cnt.astype(np.int64), own))
    return ({"read_mismatch": n_bad / max(n_cmp, 1),
             "count_mismatch": n_count_bad / max(len(fetches), 1)}, malformed)


def verdict(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """correct when every number is at or under its limit; the check's
    record, each number beside its limit."""
    check = {k: {"value": numbers[k], "limit": lim[k]} for k in NUMBERS}
    return all(numbers[k] <= lim[k] for k in NUMBERS), check

"""The ``share56`` cell at CPU size: a tiny copy of its deployment run
end to end through ``run_cell``, and the shard loop's readers
(``shard_ms``, ``shard_wait_ms``, ``shard_rescue_share``) on a synthetic
traced record of a stacked index."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import run
from benchmark.tests.test_bench_harness import SEED
from benchmark.tests.test_bench_spans import MS, _read, _record


def test_a_tiny_share_runs_the_shard_loop(tiny_bench):
    """The share56 cell on a tiny copy of its deployment: 12 genomes by
    count in 6 equal shards, stacked and merged, checked against the
    reference; the CPU's traced run has no device trace, so the shard
    loop's readers report nothing."""
    f = tiny_bench / "configs" / "share56.json"
    c = json.loads(f.read_text())
    c.update(n_shards=6, genomes=[dict(g, count=12) for g in c["genomes"]])
    f.write_text(json.dumps(c))
    spec = json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())
    for trace in (False, True):
        out = run.run_cell(spec, "share56.r9_query", SEED, 0.3, trace, "cpu", time.time(),
                           bench_dir=tiny_bench)
        assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
        assert set(out["metrics"]) == ({"front_ms", "fetch_wait_ms", "index_build_s",
                                        "index_upload_s"} if trace else
                                       {"reads_per_s", "batch_p95_ms", "setup_s"})


def _share_record():
    """Two batches over three shards each (0-30, 30-60, 60-90 ms and again
    from 100 ms), as the shard loop of a stacked index opens them.  In
    batch 1 shards 0 and 2 run the rescue tier and wait on their tier
    picks (2 and 3 ms); in batch 2 only shard 1 does (4 ms).  A rescue
    and a sync outside every shard span (the one-shard path's) count
    for neither."""
    host = [("monica.rescue cand=1 slots=8", 95 * MS, MS),
            ("cudaStreamSynchronize", 96 * MS, 9 * MS)]
    for o, rescued in ((0, {0: 2, 2: 3}), (100, {1: 4})):
        host.append(("monica.pipeline", o * MS, 95 * MS))
        for s in range(3):
            t = (o + 30 * s) * MS
            host.append((f"monica.shard group=0 shard={s}", t, (20 + s) * MS))
            host.append(("monica.lookup", t + MS, MS))
            if s in rescued:
                host += [("monica.rescue_pick", t + 5 * MS, 5 * MS),
                         ("cudaStreamSynchronize", t + 5 * MS, rescued[s] * MS),
                         ("monica.rescue cand=3 slots=8", t + 11 * MS, 2 * MS)]
    trace = {"window_ns": 200 * MS, "start_ns": 0, "batches": 2,
             "device": [("kernel", "kernel", 30 * MS, 5 * MS)], "host": host}
    return {"trace": trace}


def test_shard_loop_readers():
    rec = _share_record()
    # six shard spans of 20, 21 and 22 ms
    assert _read("shard_ms", rec) == pytest.approx(21.0)
    # the tier picks' waits inside shards, 2 + 3 + 4 ms over 2 batches
    assert _read("shard_wait_ms", rec) == pytest.approx(4.5)
    # 3 of the 6 shards ran the rescue tier
    assert _read("shard_rescue_share", rec) == pytest.approx(50.0)
    # no shard span (the parent's one-shard cells, a CPU run, no trace)
    one_shard = {"trace": dict(rec["trace"], host=[h for h in rec["trace"]["host"]
                                                   if not h[0].startswith("monica.shard ")])}
    cpu = {"trace": dict(rec["trace"], device=[])}
    for name in ("shard_ms", "shard_wait_ms", "shard_rescue_share"):
        assert _read(name, {"trace": None}) is None
        assert _read(name, one_shard) is None
        assert _read(name, cpu) is None
        assert _read(name, _record()) is None  # spans, but no shard loop

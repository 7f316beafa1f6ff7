"""The harness at CPU size: BENCHMARK.json against the contract, the
traffic generator against the port's generators and batching rule, the
metric readers on a synthetic record, a mix added as a data file alone,
and what a run may import."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import roofline, run, tracing, world
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.io import encode as enc

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2**31 + 77


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    cells = {c["name"] for c in SPEC["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_window_plan_is_the_runtimes():
    rng = np.random.default_rng(1)
    lengths = np.concatenate([rng.integers(1, 40_000, 500), [32768, 32769, 65536 + 100]])
    for mb in (None, 7, 4096):
        assert world.window_plan(lengths, world.DEFAULT_BUCKETS, mb) == enc.window_plan(
            lengths, enc.DEFAULT_BUCKETS, mb)


def test_simulator_is_the_ports():
    g = np.random.default_rng(2).integers(0, 4, 50_000).astype(np.uint8)
    for rc in (False, True):
        a = world.simulate_read_codes(np.random.default_rng(5), g, 3000, .05, .03, .03, rc)
        b = ev.simulate_read_codes(np.random.default_rng(5), g, 3000, .05, .03, .03, rc)
        np.testing.assert_array_equal(a, b)


def _mix(name, **kw):
    t = json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())
    t.update(kw)
    return t


@pytest.mark.parametrize("name", ["r9_query", "r9_matching"])
def test_mixes_give_their_lengths(name):
    t = _mix(name)
    la = world.file_lengths(t)
    assert len(la) == t["file_reads"] == 4000 and la.min() >= t["lengths"]["lo"] == 200
    assert abs(la.mean() / t["lengths"]["mean"] - 1) < 0.05
    assert abs(la.std() / t["lengths"]["sd"] - 1) < 0.1
    assert np.array_equal(la, world.file_lengths(t))  # the same set for every seed
    assert 0.05 < np.mean(la > 32768) < 0.12  # these become windows


def test_mixes_give_their_batches_abundances_and_errors():
    config = json.loads((ROOT / "benchmark/configs/zymo.json").read_text())
    config["genomes"] = [dict(g, length=400_000) for g in config["genomes"]]
    genomes = world.draw_genomes(config, SEED, "cpu")
    weights = world.genome_weights(config)
    assert np.allclose(weights, [0.12] * 8 + [0.02] * 2)
    t = _mix("r9_query", file_reads=400, pool_files=2)
    pool = world.make_pool(genomes, weights, t, SEED)
    again = world.make_pool(genomes, weights, t, SEED)
    other = world.make_pool(genomes, weights, t, SEED + 1)
    assert all(np.array_equal(a.codes, b.codes) for a, b in zip(pool, again))
    assert [b.codes.shape for b in pool] == [b.codes.shape for b in other]
    # each file batched by the runtime's rule, long reads as windows
    reads, _ = world._file_reads(genomes, weights, t, world.rng_for(SEED, world._READS))
    plan = enc.window_plan([len(r) for r in reads], enc.DEFAULT_BUCKETS, t["max_batch"])
    assert [b.codes.shape for b in pool[:len(plan)]] == [(len(r), bl) for bl, r in plan]
    assert max(b.codes.shape[1] for b in pool) == 32768
    # the genomes picked by their shares of the DNA
    short = _mix("r9_query", file_reads=20_000)
    short["lengths"].update(mean=300, sd=100)
    _, src = world._file_reads(genomes, weights, short, world.rng_for(SEED, world._READS))
    assert np.allclose(np.bincount(src, minlength=10) / len(src), weights, atol=0.01)
    # error rates, read off reads drawn from an all-A genome: r9 changes
    # 5% of the bases and, on the reverse strand, complements every base
    flat = [np.zeros(400_000, np.uint8)]
    reads = [x.codes[i, :x.lengths[i]]
             for x in world.make_pool(flat, np.ones(1), _mix("r9_query", file_reads=200), SEED)
             for i in range(x.rows)]
    fwd = [r for r in reads if (r == 0).mean() > 0.5]
    assert 0.4 < len(fwd) / len(reads) < 0.6
    assert abs(np.mean(np.concatenate(fwd) != 0) - 0.05) < 0.005


def test_check_rows_hold_the_longest():
    pool = [world.Batch(np.zeros((50, 512), np.uint8), np.arange(50, dtype=np.int32),
                        np.zeros(50, np.int32))]
    rows = world.check_rows(pool, {"check_rows_per_batch": 5}, SEED)
    assert 49 in rows[0] and 5 <= len(rows[0]) <= 6


def _synthetic_record():
    ms = 1_000_000
    trace = {"start_ns": 0, "window_ns": 100 * ms, "batches": 4,
             "device": [("banded_sw_packed_kernel<64, 4>", "kernel", 10 * ms, 10 * ms),
                        ("elementwise", "kernel", 15 * ms, 10 * ms),
                        ("Memcpy DtoH", "memcpy", 50 * ms, 5 * ms),
                        ("Memset", "memset", 90 * ms, 5 * ms)],
             "host": [("classify", 0, 40 * ms), ("aten::nonzero", 30 * ms, 10 * ms),
                      ("fetch", 40 * ms, 60 * ms)]}
    return {"setup_s": 12.5, "build_s": 0.75, "upload_s": 0.25,
            "window": {"seconds": 10.0, "reads": 200_000, "batches": 100,
                       "latency_s": [0.01] * 95 + [0.02] * 5,
                       "front_s": [0.004] * 100, "fetch_s": [0.006] * 100},
            "trace": trace, "syncs": {"batches": 4, "sites": ["pipeline.py:294"] * 10},
            "sw": {"cells": 10**9, "bytes": 10**6}}


def test_metric_readers_read_a_synthetic_record():
    rec = _synthetic_record()
    got = {m["name"]: run.metric_reader(ROOT / "benchmark", m["name"])(rec)
           for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert got["reads_per_s"] == 20_000
    assert got["batch_p95_ms"] == pytest.approx(10.5)
    assert got["setup_s"] == 12.5
    assert got["front_ms"] == pytest.approx(4.0) and got["fetch_wait_ms"] == pytest.approx(6.0)
    assert got["launches_per_batch"] == 1.0
    assert got["host_syncs_per_batch"] == 2.5
    assert got["device_idle_share"] == pytest.approx(75.0)  # busy 10-25, 50-55, 90-95 ms
    assert got["banded_sw_roofline"] == pytest.approx(
        100 * max(10**6 / 3.35e12, 4e9 / 16.7e12) / 0.010)
    assert got["index_build_s"] == 0.75 and got["index_upload_s"] == 0.25
    # nothing to read: no value, never a 0
    empty = dict(rec, trace=None, syncs=None, sw=None)
    for name in ("launches_per_batch", "host_syncs_per_batch", "device_idle_share",
                 "banded_sw_roofline"):
        assert run.metric_reader(ROOT / "benchmark", name)(empty) is None


def test_breakdown_names_the_gaps_by_the_host():
    bd = tracing.breakdown(_synthetic_record()["trace"])
    assert bd["device_ops"][0] == ["banded_sw_packed_kernel<64, 4>", 0.01]
    assert bd["idle_gaps"][0] == ["fetch", 0.035]  # 55-90 ms
    assert ["classify: aten::nonzero", 0.025] in bd["idle_gaps"]  # 25-50 ms, halfway 37.5
    assert len(bd["idle_gaps"]) == 4 and sum(g[1] for g in bd["idle_gaps"]) == pytest.approx(0.075)


def test_sw_work_counts_cells_and_bytes():
    assert roofline.sw_work([100, 50], 64) == (150 * 64, 2 * 150 + 2 * (64 + 8))


def test_a_mix_added_as_a_file_runs_without_an_edit(tiny_bench):
    spec_path = tiny_bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    (tiny_bench / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "lengths": {"dist": "gamma", "mean": 700, "sd": 200, "lo": 400, "draw_seed": 1},
        "errors": {"sub": 0.02, "ins": 0.01, "del": 0.01},
        "file_reads": 30, "max_batch": 16, "pool_files": 1, "count_mode": "basic",
        "check_rows_per_batch": 4}))
    spec["workloads"].append({"name": "zymo.dummy_mix", "config": "zymo",
                              "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    spec_path.write_text(json.dumps(spec))
    out = run.run_cell(spec, "zymo.dummy_mix", SEED, 0.3, False, "cpu", time.time(),
                       bench_dir=tiny_bench)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"reads_per_s", "batch_p95_ms", "setup_s"}
    assert list(out)[-1] == "check"


def test_a_traced_run_reports_its_layers(tiny_bench):
    spec = json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())
    out = run.run_cell(spec, "zymo_sharded.r9_matching", SEED, 0.3, True, "cpu", time.time(),
                       bench_dir=tiny_bench)
    assert out["correct"]
    # the CPU has no device trace: only the host clocks' metrics
    assert set(out["metrics"]) == {"front_ms", "fetch_wait_ms", "index_build_s",
                                   "index_upload_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in set({blocked!r}):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
{body}
bad = {{m.split(".")[0] for m in sys.modules}} & set({blocked!r})
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("blocked,body", [
    ({"jax", "jaxlib", "flax", "monica_tpu"},
     "import benchmark.run, benchmark.control, benchmark.judge, benchmark.world\n"
     "import benchmark.tracing, benchmark.roofline\n"
     "from benchmark import run\n"
     "import monica_tpu_torch.align.runtime, monica_tpu_torch.index.build\n"
     "for m in run.load_spec()['end_to_end'] + run.load_spec()['per_layer']:\n"
     "    run.metric_reader(run.BENCH, m['name'])\n"),
    ({"jax", "jaxlib", "flax", "monica_tpu", "monica_tpu_torch"},
     "import benchmark.reference.index, benchmark.reference.classify, "
     "benchmark.reference.sw\nimport benchmark.judge\n"),
])
def test_nothing_of_jax_loads(blocked, body):
    code = BLOCKER.format(blocked=sorted(blocked), root=str(ROOT), body=body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "zymo.r9_query",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(ROOT)})
    assert r.returncode != 0 and r.stdout == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "zymo.r9_query",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""

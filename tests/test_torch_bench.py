"""The port's benchmark modules against the JAX repo's programs (CPU).

* ``monica_tpu_torch.bench``: its reads equal ``bench.make_reads``'s bit
  for bit from the same seed, and its resident-batch runner over 2
  batches of 64 × 1,024 bp reads on a 5 × 100 kb index equals a jitted
  ``lax.scan`` of the JAX ``classify_batch`` (or ``_grouped``) over the
  same codes, as ``bench.py``'s ``run_all`` runs it: on one shard, on 3
  shards in size-class groups, without extension and at
  ``anchors_per_seed=1``.  Summed counts, status, acc_id and mlen
  bit-equal; mapq and inv_identity within rtol 1e-5, atol 1e-6 (XLA's
  and torch's CPU log/exp differ by ulps).
* Each module's ``--device cpu --quick`` run prints the card line
  (``cpu``) and the JAX program's JSON keys; ``bench_stream``'s payload
  holds its reads; ``exp_knobs`` draws ``scripts/exp_knobs.py``'s reads
  and prints its 12 grid lines.
* ``--device cuda`` raises here, in every one of the six modules (the
  test decides there is no card when it runs, not at import).

``bench.py`` is loaded by path: it imports numpy alone at import time.
"""

import importlib
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ref_ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu_torch import bench, bench_stream, exp_knobs
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.index.build import build_index_from_arrays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# bench.py:185-196
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "stat", "quiet_best", "loaded_floor"]
# scripts/bench_stream.py:166-184
STREAM_KEYS = ["metric", "value", "unit", "workload", "device", "stat", "single_sample_reps",
               "single_sample_best", "n_mapped", "n_unmapped", "n_ambiguous", "index_build_s",
               "stage_reads_per_s", "cross_sample_overlap", "note"]
OVERLAP_KEYS = ["samples", "reads_per_sample", "serial_reads_per_s", "pipelined_reads_per_s",
                "pipelined_reps", "pipelined_best", "overlap_speedup"]
MODULES = ("bench", "profile_stages", "bench_stream", "bench_sw", "roofline_sw", "exp_knobs")
R, B, L = 2, 64, 1024


def _jax_bench():
    spec = importlib.util.spec_from_file_location("bench_for_torch_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def world():
    """5 × 100 kb genomes and 2 batches of 64 bench reads from seed 3."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, 100_000).astype(np.uint8) for _ in range(5)]
    codes = bench.make_reads(seqs, rng, R * B).reshape(R, B, L)
    return seqs, codes, np.full((R, B), L, np.int32)


def test_reads_equal_bench_make_reads():
    jb = _jax_bench()
    for seed, n in ((3, 300), (7, 64)):
        seqs = ref_ev.zymo_community(np.random.default_rng(seed), 0.01)
        mine = ev.zymo_community(np.random.default_rng(seed), 0.01)
        assert all(np.array_equal(a, b) for a, b in zip(seqs, mine))
        want = jb.make_reads(seqs, np.random.default_rng(seed + 1), n)
        got = bench.make_reads(mine, np.random.default_rng(seed + 1), n)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # the gut and small reference sets draw as bench.py's do
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    gut, shards = bench.genomes("gut", rng_a, 0.001)
    want = [rng_b.integers(0, 4, 1500).astype(np.uint8) for _ in range(200)]
    assert shards == 5 and all(np.array_equal(a, b) for a, b in zip(gut, want))


CASES = {  # name: (shards, extend, anchors_per_seed)
    "one_shard": (1, True, None),
    "grouped_3_shards": (3, True, None),
    "no_extend": (1, False, None),
    "anchors_1": (1, True, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runner_equals_jax_scan(world, case):
    n_shards, extend, anchors = CASES[case]
    seqs, codes, lengths = world

    ref = ref_build(seqs, n_shards=n_shards)
    if n_shards == 1:
        index, steps = ref_pl.device_shard(ref.shards[0])
        step_fn = ref_pl.classify_batch
    else:
        index, steps = ref_pl.stack_device_shard_groups(ref.shards)
        step_fn = ref_pl.classify_batch_grouped
    params = ref_pl.params_for_bucket(ref_pl.ClassifyParams(tag_bits=steps, extend=extend), L)
    if anchors is not None:
        params = params._replace(anchors_per_seed=anchors)
    n_acc = ref.meta.n_accessions

    @jax.jit
    def run_all(index, codes, lengths):  # bench.py:135-150
        def body(carry, batch):
            res, counts = step_fn(index, batch[0], batch[1], params, n_acc,
                                  ref_pl.MODE_QUERY_LENGTH)
            return carry + counts, res

        return jax.lax.scan(body, jnp.zeros(n_acc, jnp.int32), (codes, lengths))

    want_total, want = run_all(index, jnp.asarray(codes), jnp.asarray(lengths))

    built = build_index_from_arrays(seqs, n_shards=n_shards, device="cpu")
    idx, p, n = bench.prepare(built, "cpu", extend, anchors)
    assert n == n_acc and p.n_slots == params.n_slots and p.tag_bits == params.tag_bits
    cd, ld = bench.resident(codes, lengths, "cpu")
    dts, total, results, statuses = bench.run_all(idx, p, n, cd, ld, reps=1)
    assert len(dts) == 1 and len(results) == R
    np.testing.assert_array_equal(total.numpy(), np.asarray(want_total))
    np.testing.assert_array_equal(statuses, np.asarray(want.status))
    for f in ("status", "acc_id", "mlen", "rc"):
        got = np.stack([getattr(r, f).numpy() for r in results])
        np.testing.assert_array_equal(got, np.asarray(getattr(want, f)), err_msg=f)
    for f in ("mapq", "inv_identity"):
        got = np.stack([getattr(r, f).numpy() for r in results])
        np.testing.assert_allclose(got, np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    assert (statuses == ref_pl.MAPPED).mean() > 0.95


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("flags", [[], ["--no-extend"], ["--anchors", "1"], ["--small"]])
def test_bench_cpu_run_prints_bench_py_keys(flags, capsys):
    assert bench.main([*flags, "--device", "cpu", "--quick"]) == 0
    lines = _lines(capsys)
    out = json.loads(lines[-1])
    assert lines[-2] == "cpu" and list(out) == BENCH_KEYS
    assert out["metric"] == "classification_reads_per_s_per_chip" and out["unit"] == "reads/s"
    assert out["loaded_floor"] <= out["value"] <= out["quiet_best"]
    assert out["vs_baseline"] == round(out["value"] / 2000.0, 2)
    src = (ROOT / "bench.py").read_text()
    assert all(f'"{k}":' in src for k in BENCH_KEYS)


def test_bench_stream_payload(tmp_path, capsys):
    work = tmp_path / "work"
    assert bench_stream.main(["--device", "cpu", "--quick", "--work", str(work),
                              "--out", str(tmp_path / "s.json")]) == 0
    lines = _lines(capsys)
    out = json.loads(lines[-1])
    assert lines[-2] == "cpu" and list(out) == STREAM_KEYS
    assert json.loads((tmp_path / "s.json").read_text()) == out
    assert list(out["cross_sample_overlap"]) == OVERLAP_KEYS
    q = bench_stream.QUICK
    assert out["n_mapped"] + out["n_unmapped"] + out["n_ambiguous"] == q["reads"]
    assert out["n_mapped"] >= 0.95 * q["reads"] and out["device"] == "cpu"
    assert out["cross_sample_overlap"]["reads_per_sample"] == max(
        q["reads"] // q["samples"], q["min_per_sample"])
    # the JAX script's folder names, under --work
    assert {p.name for p in work.iterdir()} == {
        "bench_stream_query", "bench_stream_out", "bench_stream_serial", "bench_stream_pipe",
        "bench_stream_pipe_out"}
    assert sorted(p.name for p in (work / "bench_stream_query").glob("*.fastq")) == [
        "flowcell0.fastq"]


def test_exp_knobs_draws_and_lines(capsys):
    """``scripts/exp_knobs.py``'s draws, written out as in its main()."""
    G, Bq, Rq = 30_000, 16, 2
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 4, size=G).astype(np.uint8) for _ in range(5)]
    r2 = np.random.default_rng(3)
    codes = np.stack([seqs[r2.integers(0, 5)][s : s + L]
                      for s in r2.integers(0, G - L, Bq * Rq)]).astype(np.uint8)
    m = r2.random(codes.shape) < 0.05
    codes[m] = r2.integers(0, 4, int(m.sum()))
    got_seqs, got = exp_knobs.workload(G, Bq, Rq)
    assert all(np.array_equal(a, b) for a, b in zip(got_seqs, seqs))
    np.testing.assert_array_equal(got, codes.reshape(Rq, Bq, L))

    assert exp_knobs.main(["--device", "cpu", "--quick"]) == 0
    lines = _lines(capsys)
    assert lines[-1] == "cpu"
    assert [ln.split(" rows=")[0] for ln in lines if ln.startswith("---")] == [
        "--- frac=1.0", "--- frac=0.5"]
    grid = [ln for ln in lines if ln.startswith("S=")]
    assert [ln.split(":")[0].split() for ln in grid] == [
        [f"S={S}", f"frac={f}", f"ext={e}"] for f in (1.0, 0.5) for S in (128, 96, 64)
        for e in (0, 1)]
    assert all(re.search(r": +\d+\.\d\d ms/batch  \([\d,]+ reads/s\)$", ln) for ln in grid)


@pytest.mark.parametrize("name", MODULES)
def test_device_cuda_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(f"monica_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--device", "cuda", "--quick"])

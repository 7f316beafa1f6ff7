"""The real-time loop against the JAX package's (CPU).

* ``monica_tpu_torch.demo_watch`` at its ``--quick`` sizes and the same
  demo run through the JAX package's ``watch`` (the JAX index, reads from
  ``bench.make_reads`` at ``READ_LEN = 1000``, a feeder thread renaming
  batches into place): equal final accumulators, equal (sample, reads,
  mapped) reports, strictly growing totals pass by pass, the JAX demo's
  payload keys plus each pass's ``latency_s``.
* The port's ``watch`` on the JAX index carried across
  (``convert.built_from_reference``) against the same JAX run.
* The port's CLI with ``--watch``, its samples fed one at a time, writes
  what the JAX CLI writes without ``--watch`` on ``tests/test_cli.py``'s
  offline world, byte for byte.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from monica_tpu import cli as ref_cli
from monica_tpu import evaluation as ref_ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.align import runtime as ref_rt
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu.stats.abundance import AbundanceState as RefState
from monica_tpu_torch import cli, convert, demo_watch
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.stats.abundance import AbundanceState
from tests.test_cli import world  # noqa: F401  (the JAX CLI test's offline world)
from tests.test_torch_cli import SPECIES, _files, _query, _transport

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
QUICK = demo_watch.QUICK


def _bench_module():
    """``bench.py`` loaded by path as its own copy, its reads 1 kb long,
    as ``scripts/demo_watch.py`` sets them."""
    spec = importlib.util.spec_from_file_location("bench_for_watch", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.READ_LEN = demo_watch.READ_LEN
    return mod


def _write(path: Path, codes: np.ndarray) -> None:
    """A FASTQ as ``scripts/bench_stream.write_fastq`` writes it."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * codes.shape[1]
    with open(path, "w") as fh:
        for i, row in enumerate(codes):
            fh.write(f"@read{i}\n{lut[row].tobytes().decode()}\n+\n{qual}\n")


def _demo_loop(rt_mod, state_cls, clf, n_acc, seqs, rng, workdir: Path):
    """The demo's warm pass, feeder and watch loop with ``rt_mod``'s
    runtime: (reports, accumulator total after each pass, final state)."""
    make_reads = _bench_module().make_reads
    q, out = workdir / "query", workdir / "out"
    q.mkdir(parents=True)
    out.mkdir()
    _write(q / "warm.fastq", make_reads(seqs, rng, QUICK["warm_reads"]))
    rt_mod.run_once(clf, q, out)

    def feeder():
        for i in range(QUICK["n_batches"]):
            tmp = q / f".flowcell{i}.tmp"
            _write(tmp, make_reads(seqs, rng, QUICK["reads"]))
            tmp.rename(q / f"flowcell{i}.fastq")
            time.sleep(QUICK["gap_s"])

    growth = []

    def on_batch(_reports):
        state = state_cls.load(out, n_acc)
        growth.append(int(sum(v.sum() for v in state.samples.values())))

    th = threading.Thread(target=feeder)
    th.start()
    reports = rt_mod.watch(clf, q, out, poll_s=QUICK["poll_s"],
                           max_idle_polls=QUICK["max_idle_polls"], on_batch=on_batch)
    th.join(timeout=60)
    assert not th.is_alive()
    return reports, growth, state_cls.load(out, n_acc)


def _rows(reports):
    return sorted((r.sample, r.n_reads, r.n_mapped) for r in reports)


def _assert_same_state(got, want):
    assert got.samples.keys() == want.samples.keys()
    for k in want.samples:
        np.testing.assert_array_equal(got.samples[k], np.asarray(want.samples[k]), err_msg=k)


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory):
    """The quick demo through the JAX package: its index, its reports,
    totals and final accumulator."""
    rng = np.random.default_rng(13)
    seqs = ref_ev.zymo_community(rng, QUICK["scale"])
    built = ref_build(seqs, n_shards=1)
    clf = ref_rt.Classifier(built, ref_pl.ClassifyParams(), count_mode="query_length")
    reports, growth, state = _demo_loop(ref_rt, RefState, clf, built.meta.n_accessions, seqs,
                                        rng, tmp_path_factory.mktemp("jax_demo"))
    assert sum(r.n_reads for r in reports) == QUICK["n_batches"] * QUICK["reads"]
    return dict(seqs=seqs, built=built, reports=reports, growth=growth, state=state)


def test_demo_watch_equals_jax(jax_demo, tmp_path):
    payload, reports = demo_watch.run("cpu", tmp_path, **QUICK)
    assert payload["verdict"] == "PASS" and payload["device"] == "cpu"
    assert _rows(reports) == _rows(jax_demo["reports"])
    state = AbundanceState.load(tmp_path / "out", jax_demo["built"].meta.n_accessions)
    _assert_same_state(state, jax_demo["state"])
    growth = [b["accumulated_count_total"] for b in payload["batch_log"]]
    assert growth[-1] == jax_demo["growth"][-1]
    assert all(a < b for a, b in zip(growth, growth[1:]))
    # the JAX demo's artifact keys, and each pass's wait from its newest file
    want = json.loads((ROOT / "WATCH_r04.json").read_text())
    assert payload.keys() == want.keys()
    for entry in payload["batch_log"]:
        assert entry.keys() == want["batch_log"][0].keys() | {"latency_s"}
        assert 0 < entry["latency_s"] < 60
    assert sum(len(b["samples"]) for b in payload["batch_log"]) == QUICK["n_batches"]


def test_watch_on_carried_index_equals_jax(jax_demo, tmp_path):
    """The port's watch over the JAX index carried across: the same
    reports and accumulator as the JAX package's watch, growing strictly."""
    built = convert.built_from_reference(jax_demo["built"])
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="query_length", device="cpu")
    rng = np.random.default_rng(13)
    seqs = ref_ev.zymo_community(rng, QUICK["scale"])  # the same draws advance the rng
    reports, growth, state = _demo_loop(rt, AbundanceState, clf, built.meta.n_accessions, seqs,
                                        rng, tmp_path)
    assert _rows(reports) == _rows(jax_demo["reports"])
    _assert_same_state(state, jax_demo["state"])
    assert len(growth) >= 2 and all(a < b for a, b in zip(growth, growth[1:]))
    assert growth[-1] == jax_demo["growth"][-1]


def test_cli_watch_byte_equal_to_reference(world, tmp_path):
    """The port's CLI polls with --watch while its samples land one at a
    time (each renamed into place once the previous one is being routed);
    the JAX CLI finds them all at once.  Every output file is the same."""
    src = _query(world, tmp_path / "src")
    names = sorted(p.name for p in src.glob("*.fastq"))
    q = tmp_path / "q"
    q.mkdir()
    (q / names[0]).write_bytes((src / names[0]).read_bytes())

    def feeder():
        for prev, name in zip(names, names[1:]):
            deadline = time.monotonic() + 120
            while not (q / "unmapped" / prev).exists() and time.monotonic() < deadline:
                time.sleep(0.005)
            tmp = q / f".{name}.tmp"
            tmp.write_bytes((src / name).read_bytes())
            tmp.rename(q / name)

    th = threading.Thread(target=feeder)
    th.start()
    try:
        rc = cli.main(["--root", str(tmp_path / "root"), *_transport(world), "-q", str(q),
                       *SPECIES, "--device", "cpu", "--watch", "--poll", "0.05",
                       "--max_idle_polls", "2"])
    finally:
        th.join(timeout=150)
    assert not th.is_alive() and rc == 0
    assert not list(q.glob("*.fastq")) and not list(q.glob(".*"))

    ref_q = _query(world, tmp_path / "ref_q")
    assert ref_cli.main(["--root", str(tmp_path / "ref_root"), *_transport(world), "-q",
                         str(ref_q), *SPECIES]) == 0
    got, want = _files(q), _files(ref_q)
    assert got.keys() == want.keys()
    for f in ("monica_output/monica.dataframe", "monica_output/raw_monica.dataframe",
              *(f"{d}/{n}" for d in ("mapped", "unmapped", "ambiguous") for n in names)):
        assert f in got, f
    for f in got:
        assert got[f] == want[f], f

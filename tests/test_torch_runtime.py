"""The port's streaming runtime against the JAX package's on the same
FASTQ folders and the same multi-shard index (CPU): byte-equal routed
``mapped/``, ``unmapped/``, ``ambiguous/`` and ``focus/`` files, equal
SampleReports (all but the seconds) and equal accumulators, for the
pipelined and the serial run_once, the window merge of long reads in all
three count modes, the chunked path, the quarantine and watch.

Exact equality is not luck: every read of every fixture is held clear
of the mapq gate and of both cross-shard tie bands, by margins computed
from the JAX package's own per-shard hits (``_assert_clear_margins``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.align import pipeline as ref_pl
from monica_tpu.align import runtime as ref_rt
from monica_tpu.index.build import build_index
from monica_tpu.io import encode as ref_enc
from monica_tpu.ops import chain as ref_ch
from monica_tpu.ops import lookup as ref_lk
from monica_tpu.stats.abundance import AbundanceState as RefState
from monica_tpu_torch import convert
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.io import native
from monica_tpu_torch.stats.abundance import AbundanceState
from tests.fixtures import make_fasta_gz, make_fastq, random_genome, revcomp, sample_reads

torch.set_num_threads(1)

ROUTES = ("mapped", "unmapped", "ambiguous", "focus")
GATE_MARGIN = 1e-3  # |unclipped mapq - 60|
BAND_MARGIN = 1e-4  # relative distance of a cost from the band edge and from the best


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """Three genomes in two shards of two size classes (30 kb + 60 kb)."""
    rng = np.random.default_rng(51)
    tmp = tmp_path_factory.mktemp("genomes")
    genomes, seqs = [], []
    for i in range(3):
        g = random_genome(rng, 30_000)
        seqs.append(g)
        p = tmp / f"g{i}.fna.gz"
        make_fasta_gz(p, [(f"c{i}", g)])
        genomes.append((str(p), [f"Species_{i}", f"ACC{i:03d}.1"]))
    built = build_index(genomes, n_shards=2)
    assert len(built.shards) == 2
    return dict(seqs=seqs, built=built, port_built=convert.built_from_reference(built))


def _classifiers(index, count_mode="basic", n_slots=64):
    ref_params = ref_pl.ClassifyParams(n_slots=n_slots, extend_impl="jnp")
    ref = ref_rt.Classifier(index["built"], ref_params, count_mode=count_mode)
    port = rt.Classifier(index["port_built"], convert.params_from_reference(ref_params),
                         count_mode, device="cpu")
    assert port.params == convert.params_from_reference(ref.params)
    assert isinstance(port.index, tuple) and len(port.index) == 2
    return ref, port


@functools.partial(jax.jit, static_argnames=("L", "params"))
def _ref_shard_stats(groups, packed, lengths, L, params):
    """The JAX package's per-shard hits of one batch, as its grouped step
    computes them from the 2-bit wire format, with the chain's f1 and
    f2: each field stacked (S, B)."""
    c = ref_pl.unpack_codes(packed, L)
    sk = ref_pl.sketch_batch(c, lengths, params)
    out = []
    for g in groups:
        for s in range(g.mz_rows.shape[0]):
            ix = ref_pl.DeviceIndexShard(g.mz_rows[s], g.pos_acc[s], g.ref_codes[s])
            hit = ref_pl.classify_shard(ix, c, lengths, params, sketch=sk)
            anchors = ref_lk.lookup_anchors(ix.mz_rows, *sk, tag_bits=params.tag_bits,
                                            bucket_len=L, anchors_per_seed=params.anchors_per_seed)
            res = ref_ch.chain_votes(*anchors, max_run=min(128, params.n_slots))
            out.append((hit.passed, hit.merge_cost, hit.votes, hit.acc_id, res.f1, res.f2))
    return tuple(jnp.stack(f) for f in zip(*out))


def _assert_clear_margins(ref_clf, reads, buckets=ref_enc.DEFAULT_BUCKETS):
    """Every read (every window row) lies clear of the mapq gate in every
    shard, and clear of both cross-shard tie bands."""
    p = ref_clf.params
    for b in ref_enc.bucketize_reads(reads, buckets, 4096):
        L = b.bucket_len
        stats = _ref_shard_stats(ref_clf.index, jnp.asarray(ref_enc.pack_codes_2bit(b.codes)),
                                 jnp.asarray(b.lengths), L, ref_pl.params_for_bucket(p, L))
        passed, cost, votes, acc, f1, f2 = (np.asarray(x) for x in stats)
        f1f, f2f = f1.astype(np.float64), f2.astype(np.float64)
        safe = np.maximum(f1f, 1.0)
        q = 40.0 * (1 - f2f / safe) * np.minimum(f1f / 10, 1.0) * np.log(15.0 * safe)
        gated = f1 >= p.min_votes
        assert (np.abs(q[gated] - 60.0) > GATE_MARGIN).all(), "a read sits on the mapq gate"
        cost = np.where(passed, cost, 1e9)
        votes = votes.astype(np.float64)
        best = np.argmin(cost, axis=0)
        cols = np.arange(cost.shape[1])
        best_cost = cost[best, cols]
        band = best_cost * (1 + p.tie_rel_tol) + 1e-6
        vband = p.vote_tie_sd * np.sqrt(np.maximum(votes[best, cols], 1.0))
        scale = np.maximum(np.abs(band), 1e-6)
        for s in range(cost.shape[0]):
            rival = passed[s] & (s != best)
            other = rival & (acc[s] != acc[best, cols])
            assert (np.abs(cost[s] - band)[other] > BAND_MARGIN * scale[other]).all()
            assert (np.abs(cost[s] - best_cost)[rival] > BAND_MARGIN * scale[rival]).all()
            assert (np.abs(np.abs(votes[s] - votes[best, cols]) - vband)[other] > 1e-3).all()


def _write_samples(q, samples: dict):
    q.mkdir(parents=True, exist_ok=True)
    for name, (reads, ids) in samples.items():
        make_fastq(q / f"{name}.fastq", reads, ids)


def _snapshot(q, out, n_acc):
    routed = {p.relative_to(q).as_posix(): p.read_bytes()
              for sub in ROUTES for p in sorted((q / sub).glob("*.fastq"))}
    state = AbundanceState.load(out, n_acc)
    return routed, {k: v.copy() for k, v in state.samples.items()}


def _records(data: bytes) -> list:
    """The 4-line FASTQ records of a routed file, sorted."""
    lines = data.split(b"\n")
    return sorted(b"\n".join(lines[i : i + 4]) for i in range(0, len(lines) - 1, 4))


def _reports(reports):
    return sorted((r.sample, r.n_reads, r.n_mapped, r.n_unmapped, r.n_ambiguous, r.n_focus)
                  for r in reports)


def _samples(seqs, seed, n_samples, n=16):
    """Per sample: n reads from the genomes (both strands) plus 3 random
    junk reads, all 513-1024 bp, so every sample is one batch of one
    shape (the JAX package compiles its step once per shape); ids carry
    a description."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(n_samples):
        reads, _ = sample_reads(rng, seqs, n, read_len=700, error=(0.03, 0.01, 0.01))
        reads += [random_genome(rng, int(rng.integers(600, 900))) for _ in range(3)]
        out[f"fc{k}"] = (reads, [f"fc{k}_r{i} ch=1 desc" for i in range(len(reads))])
    return out


def test_run_once_pipelined_and_serial_match_reference(index, tmp_path):
    ref, port = _classifiers(index)
    samples = _samples(index["seqs"], 52, 4)
    _assert_clear_margins(ref, [r for reads, _ in samples.values() for r in reads])
    focus = frozenset({"Species_0"})
    runs = {}
    for name, clf, pkg in (("ref", ref, ref_rt), ("port", port, rt)):
        q, out = tmp_path / f"q_{name}", tmp_path / f"o_{name}"
        _write_samples(q, samples)
        reports = pkg.run_once(clf, q, out, focus_taxa=focus)  # >1 sample: pipelined
        assert not list(q.glob("*.fastq"))  # consumed and deleted
        assert (q / rt.S_GOING_TO_ALIGN).exists()
        runs[name] = (_reports(reports), *_snapshot(q, out, 3))
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][1] == runs["ref"][1]
    assert runs["port"][2].keys() == runs["ref"][2].keys()
    for k in runs["ref"][2]:
        np.testing.assert_array_equal(runs["port"][2][k], runs["ref"][2][k])
    routed = runs["port"][1]
    assert set(routed) == {f"{r}/fc{k}.fastq" for r in ROUTES for k in range(4)}
    assert b"@Species_0 fc0_r" in routed["mapped/fc0.fastq"]  # id rewritten, old id kept
    assert sum(r[2] for r in runs["port"][0]) > 50 and sum(r[3] for r in runs["port"][0]) >= 8

    # serial process_sample calls give the same routed bytes and state
    q, out = tmp_path / "q_serial", tmp_path / "o_serial"
    _write_samples(q, samples)
    folders = rt.RouteFolders.create(q, with_focus=True)
    state = AbundanceState.load(out, 3)
    out.mkdir()
    serial = [rt.process_sample(port, p, folders, state, focus_taxa=focus)
              for p in sorted(q.glob("*.fastq"))]
    state.save(out)
    assert _reports(serial) == runs["ref"][0]
    s_routed, s_state = _snapshot(q, out, 3)
    assert s_routed == runs["ref"][1]
    for k in s_state:
        np.testing.assert_array_equal(s_state[k], runs["ref"][2][k])


@pytest.mark.parametrize("overnight", [False, True])
def test_run_once_one_sample_matches_reference(index, tmp_path, overnight):
    """One sample takes the serial path; a second pass accumulates."""
    ref, port = _classifiers(index, count_mode="query_length")
    first = _samples(index["seqs"], 53, 1)
    again = _samples(index["seqs"], 54, 1)
    _assert_clear_margins(ref, first["fc0"][0] + again["fc0"][0])
    runs = {}
    for name, clf, pkg in (("ref", ref, ref_rt), ("port", port, rt)):
        q, out = tmp_path / f"q_{name}", tmp_path / f"o_{name}"
        _write_samples(q, first)
        reps = pkg.run_once(clf, q, out, overnight=overnight)
        _write_samples(q, again)
        reps += pkg.run_once(clf, q, out, overnight=overnight)
        runs[name] = (_reports(reps), *_snapshot(q, out, 3))
    assert runs["port"][:2] == runs["ref"][:2]
    np.testing.assert_array_equal(runs["port"][2]["fc0"], runs["ref"][2]["fc0"])
    mapped = runs["port"][1]["mapped/fc0.fastq"]
    if overnight:  # the genus collapse of the tax unit in the rewritten id
        assert b"@Species fc0_r" in mapped and b"@Species_" not in mapped
    else:
        assert b"@Species_" in mapped


@pytest.mark.parametrize("count_mode", ["basic", "query_length", "matching"])
def test_window_merge_matches_reference(index, tmp_path, count_mode):
    """Reads longer than the largest bucket split into windows that share
    one read index; the merge gives one whole-read verdict and count.
    One small bucket (1024) keeps the windows cheap on the CPU."""
    seqs = index["seqs"]
    buckets = (1024,)
    rng = np.random.default_rng(55)
    long_fwd = seqs[0][2_000:6_500]  # 4.5 kb: 4 windows + a 400 bp tail
    long_rc = revcomp(seqs[1][10_000:13_100])  # 3.1 kb, reverse strand
    chimera = seqs[1][:2_048] + seqs[2][:2_048]  # windows on two genomes
    dropped_tail = seqs[2][5_000:6_100]  # 1024 + a 76 bp tail under MIN_TAIL
    short = seqs[2][20_000:20_700]
    junk = random_genome(rng, 2_500)
    reads = [long_fwd, long_rc, chimera, dropped_tail, short, junk]
    ids = [f"w{i}" for i in range(len(reads))]
    ref, port = _classifiers(index, count_mode=count_mode)
    _assert_clear_margins(ref, reads, buckets)
    runs = {}
    for name, clf, pkg, state in (("ref", ref, ref_rt, RefState(3)),
                                  ("port", port, rt, AbundanceState(3))):
        q = tmp_path / name
        _write_samples(q, {"s": (reads, ids)})
        folders = pkg.RouteFolders.create(q, with_focus=False)
        rep = pkg.process_sample(clf, q / "s.fastq", folders, state, buckets=buckets)
        runs[name] = (_reports([rep]), {p: (q / p).read_bytes() for p in
                                        ("mapped/s.fastq", "unmapped/s.fastq", "ambiguous/s.fastq")},
                      state.samples["s"])
    assert runs["port"][:2] == runs["ref"][:2]
    np.testing.assert_array_equal(runs["port"][2], runs["ref"][2])
    _, n, n_map, n_unm, n_amb, _ = runs["port"][0][0]
    assert (n, n_map, n_unm, n_amb) == (6, 4, 1, 1)
    counts = runs["port"][2]
    if count_mode == "basic":
        assert counts.tolist() == [1, 1, 2]
    elif count_mode == "query_length":
        # whole-read lengths for windowed reads; a read left with one
        # window (its tail under MIN_TAIL dropped) counts that window
        assert counts.tolist() == [len(long_fwd), len(long_rc), 1024 + len(short)]


def test_chunked_equals_whole_file(index, tmp_path):
    """A sample over the residency bound streams in chunks: the same
    record sets per route, counts and report as the whole-file run."""
    _, port = _classifiers(index, count_mode="query_length")
    samples = _samples(index["seqs"], 56, 1, n=57)
    runs = {}
    for name, bound in (("whole", None), ("chunked", 1)):
        q = tmp_path / name
        _write_samples(q, samples)
        folders = rt.RouteFolders.create(q, with_focus=False)
        state = AbundanceState(3)
        rep = rt.process_sample(port, q / "fc0.fastq", folders, state,
                                max_resident_bytes=bound, chunk_bytes=1 << 12)
        assert not (q / "fc0.fastq").exists()
        runs[name] = (_reports([rep]), {r: (q / r / "fc0.fastq").read_bytes() for r in ROUTES[:3]},
                      state.samples["fc0"])
    assert runs["chunked"][0] == runs["whole"][0]
    np.testing.assert_array_equal(runs["chunked"][2], runs["whole"][2])
    for r in ROUTES[:3]:
        recs = [_records(runs[k][1][r]) for k in ("chunked", "whole")]
        assert recs[0] == recs[1], r
    assert runs["whole"][0][0][2] > 40


def test_pure_python_parser_path_gives_the_same_bytes(index, tmp_path, monkeypatch):
    ref, port = _classifiers(index)
    samples = _samples(index["seqs"], 57, 2)
    _assert_clear_margins(ref, [r for reads, _ in samples.values() for r in reads])
    runs = {}
    for mode in ("native", "python"):
        if mode == "python":
            monkeypatch.setattr(native, "available", lambda: False)
        q = tmp_path / mode
        _write_samples(q, samples)
        reps = rt.run_once(port, q, tmp_path / f"o_{mode}", focus_taxa=frozenset({"Species_1"}))
        runs[mode] = (_reports(reps), *_snapshot(q, tmp_path / f"o_{mode}", 3))
    assert runs["python"][:2] == runs["native"][:2]
    for k in runs["native"][2]:
        np.testing.assert_array_equal(runs["python"][2][k], runs["native"][2][k])


def test_quarantine_and_watch_match_reference(index, tmp_path):
    """A malformed sample goes to failed/ and the others still run; watch
    stops after its idle polls."""
    ref, port = _classifiers(index)
    good = _samples(index["seqs"], 58, 1)
    _assert_clear_margins(ref, good["fc0"][0])
    runs = {}
    for name, clf, pkg in (("ref", ref, ref_rt), ("port", port, rt)):
        q = tmp_path / f"q_{name}"
        _write_samples(q, good)
        (q / "bad.fastq").write_text("this is not\na fastq file\n>>>\n")
        (q / "empty.fastq").write_text("")  # empty files are not samples
        reports = pkg.watch(clf, q, tmp_path / f"o_{name}", poll_s=0.01, max_idle_polls=1)
        assert (q / rt.FAILED_DIR / "bad.fastq").exists() and not (q / "bad.fastq").exists()
        assert (q / "empty.fastq").exists()
        runs[name] = (_reports(reports), *_snapshot(q, tmp_path / f"o_{name}", 3))
    assert runs["port"][:2] == runs["ref"][:2]
    assert [r[0] for r in runs["port"][0]] == ["fc0"]
    np.testing.assert_array_equal(runs["port"][2]["fc0"], runs["ref"][2]["fc0"])
    calls = []
    (tmp_path / "idle").mkdir()
    assert rt.watch(port, tmp_path / "idle", tmp_path / "o_idle", poll_s=0.01,
                    max_idle_polls=2, on_batch=calls.append) == []
    assert calls == []


def test_oversized_sample_in_a_pass_goes_chunked(index, tmp_path, monkeypatch):
    _, port = _classifiers(index, count_mode="query_length")
    samples = _samples(index["seqs"], 59, 2)
    samples["fc2"] = _samples(index["seqs"], 60, 1, n=30)["fc0"]
    q = tmp_path / "q"
    _write_samples(q, samples)
    monkeypatch.setattr(rt, "MAX_RESIDENT_BYTES", (q / "fc2.fastq").stat().st_size - 1)
    monkeypatch.setattr(rt, "CHUNK_BYTES", 1 << 12)
    chunked = []
    real = rt._process_sample_chunked

    def spy(classifier, sample_path, *a, **kw):
        chunked.append(sample_path.name)
        return real(classifier, sample_path, *a, **kw)

    monkeypatch.setattr(rt, "_process_sample_chunked", spy)
    reports = rt.run_once(port, q, tmp_path / "o")
    assert chunked == ["fc2.fastq"]
    assert _reports(reports)[2][:2] == ("fc2", 33)
    state = AbundanceState.load(tmp_path / "o", 3)
    assert set(state.samples) == {"fc0", "fc1", "fc2"}


def test_combined_fetch_equals_per_batch_fetch(index):
    _, port = _classifiers(index)
    genomes = [np.frombuffer(g.encode(), np.uint8) for g in index["seqs"]]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    rng = np.random.default_rng(60)
    handles, golden = [], []
    for blen in (512, 512, 1024):
        codes = np.full((24, blen), 4, np.uint8)
        lens = np.zeros(24, np.int32)
        for i in range(24):
            g = lut[genomes[int(rng.integers(0, 3))]]
            s, n = int(rng.integers(0, len(g) - blen)), int(rng.integers(blen // 2, blen))
            codes[i, :n], lens[i] = g[s : s + n], n
        golden.append(port.fetch(*port.classify(codes, lens)))
        handles.append(port.dispatch_pack(*port.classify(codes, lens)))
    split = port.split_combined(port.combine_packed(handles), handles)
    assert len(split) == len(golden)
    for got, want in zip(split, golden):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for h, want in zip(handles, golden):
        for a, b in zip(port.fetch_packed(h), want):
            np.testing.assert_array_equal(a, b)


def test_classify_counts_its_pack_route_and_both_routes_agree(index, monkeypatch):
    """``Classifier.classify`` packs each batch natively where the host
    library loads (``native.PACKED``, one a batch) and with numpy where
    it does not; both routes give the same answers."""
    _, port = _classifiers(index)
    genomes = [np.frombuffer(g.encode(), np.uint8) for g in index["seqs"]]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    rng = np.random.default_rng(61)
    batches = []
    for blen in (512, 1024, 2048):
        codes = np.full((16, blen), 4, np.uint8)
        lens = np.zeros(16, np.int32)
        for i in range(16):
            g = lut[genomes[int(rng.integers(0, 3))]]
            s, n = int(rng.integers(0, len(g) - blen)), int(rng.integers(blen // 2, blen))
            codes[i, :n], lens[i] = g[s : s + n], n
            codes[i, rng.integers(0, n, 3)] = 4  # an N inside the read
        batches.append((codes, lens))
    runs = {}
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setattr(native, "load", lambda: None)
        native.reset_counts()
        runs[route] = [port.fetch(*port.classify(c, n)) for c, n in batches]
        assert native.PACKED == {"native": 0, "numpy": 0, route: len(batches)}
    for got, want in zip(runs["native"], runs["numpy"]):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

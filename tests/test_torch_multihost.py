"""The port's multi-process runtime on the CPU: two real
``torch.distributed`` processes on the ``gloo`` backend (mirrors
``tests/test_multihost.py``, plus a case with the index axis across the
processes).

Each test starts this file twice as ``__main__`` (one process a rank);
the workers write marker files that the test reads.  Every wait is
bounded: the process group's own timeout inside the workers, and
``communicate(timeout=...)`` here, which kills both on expiry.
"""

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 150  # the test's bound on both workers together
GROUP_TIMEOUT_S = 60  # a collective that waits longer fails in the worker


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(case: str, tmp_path) -> None:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, case, str(pid), "2", str(port),
                               str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    deadline = time.time() + WAIT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"


def test_two_process_distributed_step(tmp_path):
    """(data=2, index=2) over two processes of two CPU cells each: each
    process feeds its own rows; the counts summed over the processes
    equal the single-device Classifier's on the global batch."""
    _run_workers("step", tmp_path)
    c0, c1 = (tmp_path / "ok_0").read_text(), (tmp_path / "ok_1").read_text()
    assert c0 == c1 and c0


def test_two_process_index_axis_across_processes(tmp_path):
    """(data=1, index=2): the one row spans both processes, so every hit
    gather crosses them.  Both feed the same batch and both get the
    single-device Classifier's status, acc_id, mlen and counts; run_once
    over identical folders writes the single-device tables."""
    _run_workers("index_across", tmp_path)
    assert (tmp_path / "ok_0").read_text() == (tmp_path / "ok_1").read_text()


def test_two_process_product_run_once(tmp_path):
    """Classifier + run_once in both processes, each routing its own
    samples (two against one: the filler sample runs), with per-sample
    counts and routed FASTQs equal to a single-device run of the same
    files."""
    _run_workers("product", tmp_path)
    ok0, ok1 = (tmp_path / "ok_0").read_text(), (tmp_path / "ok_1").read_text()
    assert "alpha:" in ok0 and "beta:" in ok0
    assert "gamma:" in ok1


def test_two_process_watch_synchronized_exit(tmp_path):
    """watch(): a late batch on process 0 only; the synchronized idle
    count keeps both polling through it, and both exit together."""
    _run_workers("watch", tmp_path)
    assert (tmp_path / "watch_ok_0").read_text() == "h0b1,h0b2"
    assert (tmp_path / "watch_ok_1").read_text() == "h1b1"


def test_two_process_schedule_overflow_raises_on_both(tmp_path):
    """A process whose sample overflows the lockstep plan does not raise
    before the all-gather: both gather the flag and raise together."""
    _run_workers("overflow", tmp_path)
    assert (tmp_path / "raised_0").exists()
    assert (tmp_path / "raised_1").exists()


# ---------------------------------------------------------------------------
# the workers (this file run as __main__)
# ---------------------------------------------------------------------------

SAMPLES = {0: [("alpha", 12, 100), ("beta", 7, 101)], 1: [("gamma", 9, 102)]}


def _tiny_index(n_shards: int):
    from monica_tpu_torch.index.build import build_index_from_arrays

    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 4, 20_000).astype(np.uint8) for _ in range(4)]
    return build_index_from_arrays(seqs, n_shards=n_shards, device="cpu"), seqs


def _sample_reads(seqs, n_reads, seed):
    """Variable-length reads over several buckets."""
    from monica_tpu_torch.io.encode import decode_seq

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_reads):
        g = seqs[rng.integers(0, len(seqs))]
        n = int(rng.integers(300, 900))
        start = int(rng.integers(0, len(g) - n + 1))
        out.append(decode_seq(g[start : start + n]))
    return out


def _write_fastq(path, reads):
    with open(path, "w") as fh:
        for i, s in enumerate(reads):
            fh.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def _global_batch(seqs, n_reads):
    from monica_tpu_torch.io import encode as enc

    rng = np.random.default_rng(1)
    codes = np.zeros((n_reads, 512), np.uint8)
    for r in range(n_reads):
        g = seqs[rng.integers(0, len(seqs))]
        start = rng.integers(0, len(g) - 512 + 1)
        codes[r] = g[start : start + 512]
    return enc.ReadBatch(codes, np.full(n_reads, 512, np.int32), np.arange(n_reads, dtype=np.int32))


def _run_folder(clf, root, name, samples, seqs):
    from monica_tpu_torch.align import runtime as rt
    from monica_tpu_torch.stats.abundance import AbundanceState

    q, out = os.path.join(root, f"q_{name}"), os.path.join(root, f"o_{name}")
    os.makedirs(q, exist_ok=True)
    for sname, n, seed in samples:
        _write_fastq(os.path.join(q, f"{sname}.fastq"), _sample_reads(seqs, n, seed))
    reports = rt.run_once(clf, q, out)
    state = AbundanceState.load(out, clf.meta.n_accessions)
    mapped = {s: open(os.path.join(q, "mapped", f"{s}.fastq"), "rb").read() for s, _, _ in samples}
    return reports, state, mapped


def _same_run(got, want, samples):
    (_, state, mapped), (_, gstate, gmapped) = got, want
    for name, _, _ in samples:
        assert np.array_equal(state.samples[name], gstate.samples[name]), name
        assert gstate.samples[name].sum() > 0, f"{name}: nothing mapped"
        assert mapped[name] == gmapped[name], f"{name}: routed mapped reads differ"


def _worker(case, pid, nproc, port, outdir):
    import torch

    from monica_tpu_torch.align import pipeline as pl
    from monica_tpu_torch.align import runtime as rt
    from monica_tpu_torch.parallel import dist
    from monica_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    dist.multihost_init("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=nproc,
                        rank=pid, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    assert dist.process_count() == nproc and dist.process_index() == pid
    cpu = torch.device("cpu")
    params = pl.ClassifyParams(n_slots=64)

    if case == "overflow":
        rt._MAX_SCHED_SLOTS = 4  # a tiny plan for the test
        batch = lambda: rt.enc.ReadBatch(np.zeros((2, 256), np.uint8), np.zeros(2, np.int32),  # noqa: E731
                                         np.arange(2, dtype=np.int32))
        try:
            rt._sync_batch_schedule([batch() for _ in range(6 if pid == 0 else 1)])
        except ValueError as e:
            assert "max_batch" in str(e), e
            Path(outdir, f"raised_{pid}").write_text(str(e))
            return
        raise SystemExit(f"process {pid}: expected ValueError, got none")

    if case == "step":
        built, seqs = _tiny_index(3)
        mesh = pm.make_mesh(2, 2, devices=[cpu, cpu])
        assert mesh.local_rows() == [pid] and mesh.row_groups == (None, None)
        clf = rt.Classifier(built, params, count_mode="basic", mesh=mesh)
        g = _global_batch(seqs, 32)
        lo = pid * 16
        st, ac, ml, counts = clf.fetch(*clf.classify(g.codes[lo : lo + 16], g.lengths[lo : lo + 16]))
        total = dist.process_allgather(counts).sum(axis=0)
        gold = rt.Classifier(built, params, count_mode="basic", device=cpu)
        gst, gac, gml, gcounts = gold.fetch(*gold.classify(g.codes, g.lengths))
        assert total.sum() > 0 and np.array_equal(total, gcounts), (total, gcounts)
        for x, y in zip((st, ac, ml), (gst, gac, gml)):
            assert np.array_equal(x, y[lo : lo + 16])
        Path(outdir, f"ok_{pid}").write_text(",".join(map(str, total.tolist())))
    elif case == "index_across":
        built, seqs = _tiny_index(3)
        mesh = pm.make_mesh(1, 2, devices=[cpu])
        assert mesh.owners == ((0, 1),) and mesh.row_groups[0] is not None
        clf = rt.Classifier(built, params, count_mode="basic", mesh=mesh)
        gold = rt.Classifier(built, params, count_mode="basic", device=cpu)
        g = _global_batch(seqs, 24)
        got = clf.fetch(*clf.classify(g.codes, g.lengths))
        want = gold.fetch(*gold.classify(g.codes, g.lengths))
        for x, y in zip(got, want):
            assert np.array_equal(x, y)
        samples = SAMPLES[0]  # the same samples in both processes
        _same_run(_run_folder(clf, outdir, f"mesh{pid}", samples, seqs),
                  _run_folder(gold, outdir, f"gold{pid}", samples, seqs), samples)
        Path(outdir, f"ok_{pid}").write_text(",".join(map(str, got[3].tolist())))
    elif case == "product":
        built, seqs = _tiny_index(3)
        mesh = pm.make_mesh(2, 2, devices=[cpu, cpu])
        clf = rt.Classifier(built, params, count_mode="basic", mesh=mesh)
        samples = SAMPLES[pid]
        run = _run_folder(clf, outdir, f"mesh{pid}", samples, seqs)
        assert {r.sample for r in run[0]} == {s[0] for s in samples}
        gold = rt.Classifier(built, params, count_mode="basic", device=cpu)
        _same_run(run, _run_folder(gold, outdir, f"gold{pid}", samples, seqs), samples)
        Path(outdir, f"ok_{pid}").write_text(";".join(
            f"{n}:" + ",".join(map(str, run[1].samples[n].tolist())) for n, _, _ in samples))
    elif case == "watch":
        from monica_tpu_torch.stats.abundance import AbundanceState

        built, seqs = _tiny_index(2)
        mesh = pm.make_mesh(2, 2, devices=[cpu, cpu])
        clf = rt.Classifier(built, params, count_mode="basic", mesh=mesh)
        q, out = os.path.join(outdir, f"q{pid}"), os.path.join(outdir, f"o{pid}")
        os.makedirs(q, exist_ok=True)

        def drop(name: str, n: int, seed: int):
            tmp = os.path.join(outdir, f".{pid}_{name}.tmp")
            _write_fastq(tmp, _sample_reads(seqs, n, seed))
            os.replace(tmp, os.path.join(q, f"{name}.fastq"))  # atomic

        # batch 1 is there from the start; batch 2 lands on process 0 only,
        # while watch() polls: process 1's exit must wait for it
        drop(f"h{pid}b1", 10 + 4 * pid, 200 + pid)
        if pid == 0:
            threading.Timer(1.0, drop, args=(f"h{pid}b2", 8, 300)).start()
        reports = rt.watch(clf, q, out, poll_s=0.3, max_idle_polls=8)
        expected = {f"h{pid}b1"} | ({f"h{pid}b2"} if pid == 0 else set())
        assert {r.sample for r in reports} == expected, reports
        state = AbundanceState.load(out, built.meta.n_accessions)
        assert set(state.samples) == expected and all(v.sum() > 0 for v in state.samples.values())
        Path(outdir, f"watch_ok_{pid}").write_text(",".join(sorted(state.samples)))
    else:
        raise SystemExit(f"unknown case {case}")
    dist.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])

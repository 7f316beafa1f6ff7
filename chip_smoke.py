#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``monica_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the banded-SW CUDA kernels from ``monica_tpu_torch/ops/csrc``,
holds each one bit-equal to its plain PyTorch version on the card, then
drives the port's two paths:

* the single-shard classify step — a 64 Mbase index and
  ``Classifier.classify``/``fetch`` — on the bench workload (16 batches
  of 2048 1 kb reads at 5% substitutions) and on coverage batches that
  reach every kernel (high-error rescue, matching mode, 20-30 kb reads,
  band 128), with the bench batch timed stage by stage, the device's
  busy share under ``torch.profiler`` and the matching-mode and 32 kb
  rates;
* the cross-shard merge on random tie-rich hit stacks, the card held
  equal to the CPU (``[merge_agree]``);
* the multi-shard streaming runtime — a 300 Mbase, 5-shard gut index
  (``[gut_index]``) and ``run_once`` over a folder of 8 nanopore FASTQ
  samples of 1,500 reads of 300-40,000 bp, then the abundance tables
  (``[stream]``), and the chunked, CPU and serial runs held equal to it
  (``[stream_agree]``).

Every phase prints one line; any failure raises, so the exit code is
nonzero and the final line is missing.  The last two lines are the
kernel table and ``{"ok": true, "device": {...}}``.

It needs CUDA: without a card it exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.evaluation import (bench_reads, gut_community, nanopore_lengths,
                                         nanopore_sample, random_shard_hits, sim_batch,
                                         write_fastq_sample, zymo_community)
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.io import native
from monica_tpu_torch.io import seq as seqio
from monica_tpu_torch.io.encode import pack_codes_2bit
from monica_tpu_torch.ops import _native
from monica_tpu_torch.ops import extend as ex
from monica_tpu_torch.stats.abundance import (DATAFRAME_FILENAME, RAW_DATAFRAME_FILENAME,
                                              AbundanceState, export_tables)
from monica_tpu_torch.utils.metrics import Metrics

SEED = 3
READ_LEN = 1024
BATCH = 2048
N_BATCHES = 16
SUB_RATE = 0.05
MIN_ACCURACY = 0.95
# the streaming phases (BASELINE config 3 index, config 4 traffic)
GUT_SHARDS = 5
STREAM_SAMPLES = 8
STREAM_READS = 1500
STREAM_LEN = (300, 40_000)  # log-uniform read lengths, bp
STREAM_ERROR = (0.05, 0.03, 0.03)  # substitution, insertion, deletion
STREAM_BATCH = 4096
STAGE_REPS = 16  # synced reps of the one-batch timings
SOURCE = "monica_tpu_torch/ops/csrc/banded_sw.cu"
# (kernel instance, TPU kernel it replaces)
KERNELS = {
    "banded_sw_packed_w64": "monica_tpu/ops/extend.py:449",  # _sw_kernel_pairs
    "banded_sw_packed_w128": "monica_tpu/ops/extend.py:309",  # _sw_kernel_packed
    "banded_sw_pairstate_w64": "monica_tpu/ops/extend.py:258",  # _sw_kernel
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sw_case(rng, dev, B, L, p, short=False, sub=0.08, alphabet=4):
    """Reads from a random reference at ``sub`` substitutions and their
    reference windows on the card; ``short`` PAD-tails every other read,
    and a 2-letter ``alphabet`` makes equal-score cells (ties) common."""
    W = p.band
    ref = rng.integers(0, alphabet, 400_000).astype(np.uint8)
    starts = rng.integers(0, len(ref) - L - W, B)
    q = np.stack([ref[s : s + L] for s in starts])
    m = rng.random(q.shape) < sub
    q[m] = rng.integers(0, alphabet, int(m.sum()))
    lengths = np.full(B, L, np.int32)
    if short:
        for b in range(0, B, 2):
            lengths[b] = int(rng.integers(1, L))
            q[b, lengths[b]:] = 4
    refwin = ex.extract_ref_windows(torch.from_numpy(ref).to(dev),
                                    torch.from_numpy(starts.astype(np.int32)).to(dev), L, W)
    return (torch.from_numpy(q).to(dev), refwin.contiguous(),
            torch.from_numpy(lengths).to(dev))


def compare_kernels(dev) -> dict:
    """Each kernel against banded_sw_torch on the card, bit-equal; times
    at the main path's shapes.  The packed kernel is also held at the
    8 and 16 kb buckets the stream's rescues give it, where the packed
    state's mlen takes 14 and 15 bits."""
    rng = np.random.default_rng(SEED)
    p64, p128 = ex.ExtendParams(band=64), ex.ExtendParams(band=128)
    big_match = dict(match=1 << 18)  # disables packing at small L
    cases = [  # (kernel instance, B, L, params, short, timed, alphabet)
        ("banded_sw_packed_w64", 128, 1024, p64, False, True, 4),
        ("banded_sw_packed_w64", 7, 300, p64, True, False, 4),
        ("banded_sw_packed_w64", 16, 8192, p64, True, False, 4),
        ("banded_sw_packed_w64", 16, 16384, p64, True, False, 4),
        ("banded_sw_packed_w128", 128, 1024, p128, False, True, 4),
        ("banded_sw_pairstate_w64", 8, 32768, p64, True, True, 4),
        # the pair-state tie rule on tie-rich input, and pair state at W=128
        ("banded_sw_pairstate_w64", 16, 1024, p64._replace(**big_match), True, False, 2),
        ("banded_sw_pairstate_w128", 8, 1024, p128._replace(**big_match), True, False, 4),
    ]
    out = {}
    for name, B, L, p, short, timed, alphabet in cases:
        q, refwin, lengths = sw_case(rng, dev, B, L, p, short, alphabet=alphabet)
        before = _native.LAUNCHES[name]
        ks, km = ex.banded_sw(q, refwin, lengths, p, impl="cuda")
        torch.cuda.synchronize()
        check(_native.LAUNCHES[name] == before + 1, f"{name} did not launch")
        t0 = time.perf_counter()
        ps, pm = ex.banded_sw(q, refwin, lengths, p, impl="torch")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int(max((ks - ps).abs().max(), (km - pm).abs().max()))
        check(err == 0, f"{name} B={B} L={L}: kernel differs from plain by {err}")
        check(bool((ks >= 0).all() and (km <= lengths).all()), f"{name}: implausible output")
        entry = out.setdefault(name, {"max_abs_err": 0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        msg = dict(kernel=name, B=B, L=L, W=p.band, mbits=ex.packed_mbits(L, p), bit_equal=True)
        if timed:
            reps = 3 if L > 16384 else 20
            ms = cuda_ms(lambda: ex.banded_sw(q, refwin, lengths, p, impl="cuda"), reps)
            entry.update(ms=ms, plain_ms=plain_ms)
            msg.update(kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.1f}")
        say("kernels", **msg)
    return out


def host_cpu() -> str:
    """The host CPU: its architecture and, on Linux, the model name (x86)
    or the implementer and part numbers (Arm)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                fields.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    model = fields.get("model name") or " ".join(
        f"{k}={fields[k]}" for k in ("CPU implementer", "CPU part") if k in fields)
    return f"{platform.machine()} {model or 'unknown'}"


def synced_ms(fn):
    """(fn(), wall milliseconds between two device syncs)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def median_rate(fn, n_reads: int, reps: int = 3) -> tuple[float, list[float]]:
    """Reads/s of fn() as the median of ``reps`` synced wall times."""
    dts = [synced_ms(fn)[1] / 1e3 for _ in range(reps)]
    return n_reads / float(np.median(dts)), dts


def stage_times(clf, codes, lengths) -> dict:
    """Median ms per bench batch of each stage of Classifier.classify +
    fetch, each timed on its own: the host 2-bit pack, the two pinned
    uploads, the device pipeline, the fetch, and the whole call."""
    params = pl.params_for_bucket(clf.params, codes.shape[2])
    t = {k: [] for k in ("pack", "upload_reads", "upload_lengths", "classify_batch",
                         "fetch", "classify_and_fetch")}
    for batch in codes:
        t0 = time.perf_counter()
        packed = pack_codes_2bit(batch)
        t["pack"].append((time.perf_counter() - t0) * 1e3)
        dev_packed, ms = synced_ms(lambda: clf._upload(packed))
        t["upload_reads"].append(ms)
        dev_lens, ms = synced_ms(lambda: clf._upload(lengths))
        t["upload_lengths"].append(ms)
        out, ms = synced_ms(lambda: pl.classify_batch_packed(
            clf.index, dev_packed, dev_lens, batch.shape[1], params,
            clf.meta.n_accessions, clf.count_mode))
        t["classify_batch"].append(ms)
        t0 = time.perf_counter()
        clf.fetch(*out)
        t["fetch"].append((time.perf_counter() - t0) * 1e3)
        t["classify_and_fetch"].append(synced_ms(
            lambda: clf.fetch(*clf.classify(batch, lengths)))[1])
    return {k: round(float(np.median(v)), 4) for k, v in t.items()}


def busy_share(clf, codes, lengths) -> dict:
    """Device busy share over a run of bench batches under torch.profiler:
    the union of the device's kernel and copy intervals over wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced_ms(lambda: [clf.fetch(*clf.classify(b, lengths)) for b in codes])
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0 if cur is None else cur[1] - cur[0]
    if not spans:  # the profiler saw no device activity
        return dict(batches=len(codes), wall_ms=round(wall_ms, 2), busy_share="not measured")
    return dict(batches=len(codes), wall_ms=round(wall_ms, 2), device_events=len(spans),
                busy_ms=round(busy_us / 1e3, 3), busy_share=round(busy_us / 1e3 / wall_ms, 4))


def run(clf, codes, lengths):
    out = clf.fetch(*clf.classify(codes, lengths))
    check(out[0].shape == (codes.shape[0],) and out[3].shape == (clf.meta.n_accessions,),
          "result shapes")
    check(bool(np.isin(out[0], (pl.UNMAPPED, pl.MAPPED, pl.AMBIGUOUS)).all()), "status codes")
    return out


def accuracy(out, labels) -> float:
    return float(((out[0] == pl.MAPPED) & (out[1] == labels)).mean())


def same(a, b, what: str) -> None:
    for name, x, y in zip(("status", "acc_id", "mlen", "counts"), a, b):
        check(np.array_equal(x, y), f"{what}: {name} differs")


def single_shard(dev) -> dict:
    """The single-shard paths: bench workload, coverage batches,
    agreement, stage times, busy share, rates.  Returns the kernel
    launches counted over the bench and coverage runs."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    seqs = zymo_community(rng)
    built = build_index_from_arrays(seqs, n_shards=1)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clf = rt.Classifier(built, device=dev)
    say("index", mbase=f"{sum(map(len, seqs)) / 1e6:.1f}", shards=len(built.shards),
        minimizers=built.shards[0].n_minimizers, build_s=f"{build_s:.1f}",
        upload_s=f"{time.perf_counter() - t0:.1f}", table_rows=clf.index.mz_rows.shape[0],
        device_mb=f"{torch.cuda.memory_allocated() / 2**20:.0f}")

    codes, labels = bench_reads(seqs, rng, BATCH * N_BATCHES, READ_LEN, SUB_RATE)
    codes = codes.reshape(N_BATCHES, BATCH, READ_LEN)
    labels = labels.reshape(N_BATCHES, BATCH)
    lengths = np.full(BATCH, READ_LEN, np.int32)
    run(clf, codes[0], lengths)  # warm-up (allocator, kernel load)

    # ---- the main path: launch counts cover exactly this stretch ----
    _native.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [clf.fetch(*clf.classify(codes[b], lengths)) for b in range(N_BATCHES)]
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    status = np.stack([o[0] for o in outs])
    acc = float(((status == pl.MAPPED) & (np.stack([o[1] for o in outs]) == labels)).mean())
    n = BATCH * N_BATCHES
    say("bench", reads=n, reads_per_s=f"{n / float(np.median(dts)):.1f}",
        median_s=f"{float(np.median(dts)):.4f}", reps=[f"{d:.4f}" for d in dts],
        mapped=f"{float((status == pl.MAPPED).mean()):.4f}", accuracy=f"{acc:.4f}",
        peak_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.0f}")
    check(acc >= MIN_ACCURACY, f"bench accuracy {acc:.4f} < {MIN_ACCURACY}")

    # coverage: high-error rescue, matching mode (SW on every read), long reads
    hi_c, hi_l, hi_lab = sim_batch(seqs, rng, BATCH, 800, READ_LEN, (0.10, 0.04, 0.04), READ_LEN)
    hi = run(clf, hi_c, hi_l)
    m_clf = rt.Classifier(built, count_mode="matching", device=dev)
    mat = run(m_clf, codes[1], lengths)
    long_c, long_l, long_lab = sim_batch(seqs, rng, 64, 20_000, 30_000, (0.05, 0.03, 0.03), 32768)
    lng = run(m_clf, long_c, long_l)
    w_clf = rt.Classifier(built, pl.ClassifyParams(band=128), count_mode="matching", device=dev)
    w128 = run(w_clf, codes[2], lengths)
    launches = dict(_native.LAUNCHES)
    # ---- end of the main path ----

    say("coverage", high_error_acc=f"{accuracy(hi, hi_lab):.4f}",
        matching_acc=f"{accuracy(mat, labels[1]):.4f}",
        long_acc=f"{accuracy(lng, long_lab):.4f}", band128_acc=f"{accuracy(w128, labels[2]):.4f}",
        launches=json.dumps(launches, separators=(",", ":")))
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(accuracy(mat, labels[1]) >= MIN_ACCURACY, "matching-mode accuracy")
    check(accuracy(lng, long_lab) >= MIN_ACCURACY, "long-read accuracy")

    # the plain path on the card, and the same code on the CPU
    plain = pl.ClassifyParams(extend_impl="torch")
    same(run(rt.Classifier(built, plain, device=dev), hi_c, hi_l), hi, "plain vs kernel (rescue)")
    p_m = rt.Classifier(built, plain, count_mode="matching", device=dev)
    same(run(p_m, codes[1], lengths), mat, "plain vs kernel (matching)")
    same(run(p_m, long_c, long_l), lng, "plain vs kernel (32 kb)")
    same(run(rt.Classifier(built, device="cpu"), hi_c, hi_l), hi, "cpu vs card (rescue)")
    res, _ = clf.classify(hi_c, hi_l)
    check(bool(torch.isfinite(res.mapq).all() and torch.isfinite(res.inv_identity).all()),
          "non-finite mapq / identity")
    say("agree", plain_vs_kernel=True, cpu_vs_card=True)

    # where the time goes: bench stages, device busy share, SW-heavy rates
    say("stages", unit="ms_median_per_batch",
        **stage_times(clf, codes, lengths))
    syncs = host_syncs(clf, codes[0], lengths)
    say("syncs", shards=1, host_syncs=len(syncs), sync_sites=json.dumps(syncs, separators=(",", ":")))
    say("profile", **busy_share(clf, codes[:8], lengths))
    m_rate, m_dts = median_rate(lambda: [m_clf.fetch(*m_clf.classify(b, lengths))
                                         for b in codes], n)
    l_rate, l_dts = median_rate(lambda: m_clf.fetch(*m_clf.classify(long_c, long_l)),
                                len(long_l))
    say("rates", matching_reads_per_s=f"{m_rate:.1f}",
        matching_reps_s=[f"{d:.4f}" for d in m_dts],
        long32k_reads_per_s=f"{l_rate:.1f}", long32k_reps_s=[f"{d:.4f}" for d in l_dts])

    return launches


def merge_agree(dev) -> None:
    """[merge_agree]: the cross-shard merge on the card against the same
    code on the CPU, every ReadResult field equal, on random ShardHit
    stacks of 2-6 shards full of exact ties (the first shard must win),
    same-accession ties, near-ties and reads on the float32 cost-band
    edge, with each tie band on and off."""
    rng = np.random.default_rng(SEED)
    n_stacks = n_reads = n_amb = 0
    for S in range(2, 7):
        for tol, sd in ((0.10, 1.0), (0.0, 0.0), (0.10, 0.0), (0.0, 2.0)):
            fields = random_shard_hits(rng, S, 4000, tol, sd)
            cpu = pl.merge_hits(pl.ShardHit(**{f: torch.from_numpy(a) for f, a in fields.items()}),
                                tol, sd)
            card = pl.merge_hits(pl.ShardHit(**{f: torch.from_numpy(a).to(dev)
                                                for f, a in fields.items()}), tol, sd)
            for f in pl.ReadResult._fields:
                a, b = getattr(cpu, f), getattr(card, f).cpu()
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"merge_hits S={S} bands=({tol}, {sd}): {f} differs on the card")
            n_stacks += 1
            n_reads += cpu.status.numel()
            n_amb += int((cpu.status == pl.AMBIGUOUS).sum())
    check(n_amb > n_reads // 10, f"merge_agree: only {n_amb} ambiguous of {n_reads}")
    say("merge_agree", stacks=n_stacks, shards="2-6", reads=n_reads,
        ambiguous_share=f"{n_amb / n_reads:.4f}", cpu_vs_card=True)


def gut_index(dev):
    """[gut_index]: BASELINE config 3, 200 x 1.5 Mb = 300 Mbase in 5
    shards, built on the host with a thread per shard, then stacked by
    size class on the card."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    seqs = gut_community(rng)
    built = build_index_from_arrays(seqs, n_shards=GUT_SHARDS)
    build_s = time.perf_counter() - t0
    check(len(built.shards) == GUT_SHARDS, f"{len(built.shards)} shards, not {GUT_SHARDS}")
    before = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = rt.Classifier(built, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    check(isinstance(clf.index, tuple), "a multi-shard index must be stacked in groups")
    say("gut_index", mbase=f"{sum(map(len, seqs)) / 1e6:.1f}", shards=len(built.shards),
        size_classes=[pl._size_class(len(sh.ref_codes)) for sh in built.shards],
        groups=[g.mz_rows.shape[0] for g in clf.index],
        table_rows=[g.mz_rows.shape[1] for g in clf.index],
        minimizers=[sh.n_minimizers for sh in built.shards],
        build_s=f"{build_s:.1f}", upload_s=f"{upload_s:.1f}",
        stacked_mb=f"{pl.stacked_nbytes(clf.index) / 2**20:.0f}",
        device_mb=f"{(torch.cuda.memory_allocated() - before) / 2**20:.0f}",
        device_mb_total=f"{torch.cuda.memory_allocated() / 2**20:.0f}")
    return seqs, built, clf


def counted_length(n: int) -> int:
    """What one mapped read of n bp adds in query_length mode: the whole
    read, or its one window when the rest is a tail under MIN_TAIL."""
    rows = [r for _, batch in enc.window_plan([n]) for r in batch]
    return n if len(rows) > 1 else rows[0][2]


def draw_samples(seqs, rng, folder: Path, n_samples: int, n_reads: int, prefix: str,
                 max_len: int | None = None) -> dict:
    """Write simulated nanopore FASTQ samples; returns the true tax unit
    of each read sequence."""
    folder.mkdir(parents=True, exist_ok=True)
    truth = {}
    for k in range(n_samples):
        lengths = nanopore_lengths(rng, n_reads, *STREAM_LEN)
        if max_len is not None:
            lengths = np.minimum(lengths, max_len)
        reads, labels = nanopore_sample(seqs, rng, lengths, STREAM_ERROR)
        write_fastq_sample(folder / f"{prefix}{k}.fastq", reads, prefix=f"{prefix}{k}_r")
        for r, g in zip(reads, labels):
            truth[enc.decode_seq(r)] = f"Species_{g}"
    return truth


def records(data: bytes) -> list:
    """The 4-line FASTQ records of a routed file, sorted."""
    lines = data.split(b"\n")
    return sorted(b"\n".join(lines[i : i + 4]) for i in range(0, len(lines) - 1, 4))


def routed(q: Path) -> dict:
    """Routed FASTQ bytes under a query folder, by relative path."""
    return {p.relative_to(q).as_posix(): p.read_bytes()
            for sub in (rt.MAPPED_DIR, rt.UNMAPPED_DIR, rt.AMBIGUOUS_DIR)
            for p in sorted((q / sub).glob("*.fastq"))}


def report_rows(reports) -> list:
    return sorted((r.sample, r.n_reads, r.n_mapped, r.n_unmapped, r.n_ambiguous)
                  for r in reports)


def check_consumed(q: Path, reports, n_samples: int, what: str) -> None:
    failed = sorted(p.name for p in (q / rt.FAILED_DIR).glob("*"))  # none if no failed/
    check(not failed, f"{what}: samples quarantined: {failed}")
    check(not list(q.glob("*.fastq")), f"{what}: inputs not consumed")
    check(len(reports) == n_samples, f"{what}: {len(reports)} reports for {n_samples} samples")


def same_state(a: dict, b: dict, what: str) -> None:
    check(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a),
          f"{what}: accumulators differ")


def host_syncs(clf, codes, lengths) -> list:
    """Where one classify call (before the fetch) syncs the device with
    the host, as torch's sync debug mode reports it: one "file:line"
    per sync."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = clf.classify(codes, lengths)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del out
    return [f"{Path(w.filename).name}:{w.lineno}" for w in seen
            if "synchronizing" in str(w.message)]


def stream(dev, seqs, built, clf, tmp: Path) -> dict:
    """[stream]: run_once over 8 FASTQ samples on the card (the pipelined
    path), then the tables.  Returns what [stream_agree] compares."""
    rng = np.random.default_rng(SEED + 1)
    q, out = tmp / "query", tmp / "out"
    truth = draw_samples(seqs, rng, q, STREAM_SAMPLES, STREAM_READS, "sample")
    inputs = {p.name: p.read_bytes() for p in sorted(q.glob("*.fastq"))}
    n_reads = STREAM_SAMPLES * STREAM_READS
    n_bases = sum(len(s) for s in truth)
    metrics = Metrics(verbose=False)
    native.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    # ---- the streaming path: launch counts cover exactly this stretch ----
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = rt.run_once(clf, q, out, max_batch=STREAM_BATCH, metrics=metrics)
    state = AbundanceState.load(out, built.meta.n_accessions)
    export_tables(state, built.meta, out)
    dt = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    # ---- end of the streaming path ----
    check_consumed(q, reports, STREAM_SAMPLES, "stream")
    check(sum(r.n_reads for r in reports) == n_reads, "stream: read count")
    check(native.PARSED["views"] >= STREAM_SAMPLES, "stream: the native parser did not run")
    check(launches["banded_sw_packed_w64"] > 0, "stream: banded_sw_packed_w64 never launched")
    check((out / DATAFRAME_FILENAME).exists() and (out / RAW_DATAFRAME_FILENAME).exists(),
          "stream: tables not written")
    tax_id = {t: i for i, t in enumerate(built.meta.tax_units)}
    correct = 0
    for name in inputs:
        want = np.zeros(built.meta.n_accessions, np.int64)
        for rec in seqio.read_fastq(q / rt.MAPPED_DIR / name):
            correct += truth[rec.seq] == rec.id
            want[tax_id[rec.id]] += counted_length(len(rec.seq))
        check(np.array_equal(state.samples[seqio.sample_name(name)], want),
              f"stream: alignment.npz counts of {name} differ from its routed mapped records")
    acc = correct / n_reads
    n = {k: sum(getattr(r, f"n_{k}") for r in reports) for k in ("mapped", "unmapped", "ambiguous")}
    stage = {k: sum(st.seconds for name, st in metrics.stages.items() if name.startswith(k + ":"))
             for k in ("parse", "dispatch", "classify", "route")}
    say("stream", samples=len(reports), reads=n_reads, mbases=f"{n_bases / 1e6:.1f}",
        seconds=f"{dt:.3f}", reads_per_s=f"{n_reads / dt:.1f}", mbases_per_s=f"{n_bases / 1e6 / dt:.2f}",
        accuracy=f"{acc:.4f}", **{f"{k}_share": f"{v / n_reads:.4f}" for k, v in n.items()},
        **{f"{k}_s": f"{v:.3f}" for k, v in stage.items()},
        peak_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.0f}",
        launches=json.dumps(launches, separators=(",", ":")))
    check(acc >= MIN_ACCURACY, f"stream accuracy {acc:.4f} < {MIN_ACCURACY}")

    # the rescue tier pick costs one host sync per shard and batch
    codes, labels = bench_reads(seqs, np.random.default_rng(SEED + 2), BATCH, READ_LEN, SUB_RATE)
    lengths = np.full(BATCH, READ_LEN, np.int32)
    hits = [run(clf, codes, lengths) for _ in range(2)][-1]  # warm
    reps_ms = [synced_ms(lambda: run(clf, codes, lengths))[1] for _ in range(STAGE_REPS)]
    syncs = host_syncs(clf, codes, lengths)
    say("stream_batch", shards=len(built.shards), B=BATCH, L=READ_LEN, host_syncs=len(syncs),
        sync_sites=json.dumps(syncs, separators=(",", ":")),
        classify_and_fetch_ms_median=f"{float(np.median(reps_ms)):.3f}",
        reps_ms=[f"{m:.3f}" for m in reps_ms], accuracy=f"{accuracy(hits, labels):.4f}", **busy_share(clf, codes[None], lengths))
    return dict(inputs=inputs, routed=routed(q), state=dict(state.samples),
                reports=report_rows(reports), launches=launches)


def stream_agree(dev, seqs, built, clf, tmp: Path, first: dict) -> None:
    """[stream_agree]: (a) chunked vs whole-file process_sample, (b) the
    CPU vs the card on a 200-read sample, (c) serial process_sample vs
    the pipelined run_once of [stream]."""
    n_acc = built.meta.n_accessions
    rng = np.random.default_rng(SEED + 3)
    # (a) one more sample, chunked (1 MiB) and whole-file
    draw_samples(seqs, rng, tmp / "a_src", 1, STREAM_READS, "extra")
    runs = {}
    for mode, bound in (("whole", None), ("chunked", 1 << 20)):
        q = tmp / f"a_{mode}"
        q.mkdir()
        (q / "extra0.fastq").write_bytes((tmp / "a_src" / "extra0.fastq").read_bytes())
        state = AbundanceState(n_acc)
        rep = rt.process_sample(clf, q / "extra0.fastq", rt.RouteFolders.create(q, False), state,
                                max_resident_bytes=bound, chunk_bytes=1 << 20)
        check_consumed(q, [rep], 1, f"chunked agreement ({mode})")
        runs[mode] = (report_rows([rep]), {k: records(v) for k, v in routed(q).items()},
                      dict(state.samples))
    check(runs["chunked"][0] == runs["whole"][0], "chunked vs whole: reports differ")
    check(runs["chunked"][1] == runs["whole"][1], "chunked vs whole: routed records differ")
    same_state(runs["chunked"][2], runs["whole"][2], "chunked vs whole")

    # (b) 200 reads <= 4 kb through run_once on the CPU and on the card
    draw_samples(seqs, rng, tmp / "b_src", 1, 200, "small", max_len=4096)
    cpu_clf = rt.Classifier(built, device="cpu")
    runs, secs = {}, {}
    for name, c in (("cpu", cpu_clf), ("card", clf)):
        q = tmp / f"b_{name}"
        q.mkdir()
        (q / "small0.fastq").write_bytes((tmp / "b_src" / "small0.fastq").read_bytes())
        t0 = time.perf_counter()
        reports = rt.run_once(c, q, tmp / f"b_out_{name}")
        secs[name] = time.perf_counter() - t0
        check_consumed(q, reports, 1, f"cpu-vs-card ({name})")
        runs[name] = (report_rows(reports), routed(q),
                      dict(AbundanceState.load(tmp / f"b_out_{name}", n_acc).samples))
    check(runs["cpu"][:2] == runs["card"][:2], "cpu vs card: routed bytes or reports differ")
    same_state(runs["cpu"][2], runs["card"][2], "cpu vs card")
    del cpu_clf

    # (c) the [stream] samples again, serial process_sample calls
    q, out = tmp / "c_query", tmp / "c_out"
    q.mkdir()
    for name, data in first["inputs"].items():
        (q / name).write_bytes(data)
    folders = rt.RouteFolders.create(q, False)
    state = AbundanceState(n_acc)
    reports = [rt.process_sample(clf, p, folders, state, max_batch=STREAM_BATCH)
               for p in seqio.list_sample_files(q)]
    check_consumed(q, reports, STREAM_SAMPLES, "serial")
    check(report_rows(reports) == first["reports"], "serial vs pipelined: reports differ")
    check(routed(q) == first["routed"], "serial vs pipelined: routed bytes differ")
    same_state(dict(state.samples), first["state"], "serial vs pipelined")
    say("stream_agree", chunked_vs_whole=True, cpu_vs_card=True, serial_vs_pipelined=True,
        chunks_mib=1, small_reads=200, cpu_run_s=f"{secs['cpu']:.1f}",
        card_run_s=f"{secs['card']:.2f}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        host_cpu=repr(host_cpu()), host_cores=os.cpu_count(),
        torch_threads=torch.get_num_threads())

    t0 = time.perf_counter()
    _native.load()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=_native.library_path().name,
        fastq_parser=native.library_path().name if native.available() else "unavailable")
    check(native.available(), "the native FASTQ parser did not build")

    timings = compare_kernels(dev)
    launches = single_shard(dev)
    torch.cuda.empty_cache()
    merge_agree(dev)

    seqs, built, clf = gut_index(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        first = stream(dev, seqs, built, clf, Path(tmp))
        stream_agree(dev, seqs, built, clf, Path(tmp), first)

    table = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": timings[name]["max_abs_err"],
         "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"]}
        for name, replaces in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``monica_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the banded-SW CUDA kernels from ``monica_tpu_torch/ops/csrc``,
holds each one bit-equal to its plain PyTorch version on the card, then
drives the port's main path — a 64 Mbase single-shard index and
``Classifier.classify``/``fetch`` — on the bench workload (16 batches of
2048 1 kb reads at 5% substitutions) and on coverage batches that reach
every kernel (high-error rescue, matching mode, 20-30 kb reads, band
128).  It then times the bench batch stage by stage (host pack, uploads,
device classify, fetch), the device's busy share under
``torch.profiler``, and the matching-mode and 32 kb rates.  Every phase
prints one line; any failure raises, so the exit code is nonzero and the
final line is missing.  The last two lines are the kernel table and
``{"ok": true, "device": {...}}``.

It needs CUDA: without a card it exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import time

import numpy as np
import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.evaluation import bench_reads, sim_batch, zymo_community
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.io.encode import pack_codes_2bit
from monica_tpu_torch.ops import _native
from monica_tpu_torch.ops import extend as ex

SEED = 3
READ_LEN = 1024
BATCH = 2048
N_BATCHES = 16
SUB_RATE = 0.05
MIN_ACCURACY = 0.95
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
    at the main path's shapes."""
    rng = np.random.default_rng(SEED)
    p64, p128 = ex.ExtendParams(band=64), ex.ExtendParams(band=128)
    big_match = dict(match=1 << 18)  # disables packing at small L
    cases = [  # (kernel instance, B, L, params, short, timed, alphabet)
        ("banded_sw_packed_w64", 128, 1024, p64, False, True, 4),
        ("banded_sw_packed_w64", 7, 300, p64, True, False, 4),
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
        msg = dict(kernel=name, B=B, L=L, W=p.band, bit_equal=True)
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
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=_native.library_path().name)

    timings = compare_kernels(dev)

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
    say("profile", **busy_share(clf, codes[:8], lengths))
    m_rate, m_dts = median_rate(lambda: [m_clf.fetch(*m_clf.classify(b, lengths))
                                         for b in codes], n)
    l_rate, l_dts = median_rate(lambda: m_clf.fetch(*m_clf.classify(long_c, long_l)),
                                len(long_l))
    say("rates", matching_reads_per_s=f"{m_rate:.1f}",
        matching_reps_s=[f"{d:.4f}" for d in m_dts],
        long32k_reads_per_s=f"{l_rate:.1f}", long32k_reps_s=[f"{d:.4f}" for d in l_dts])

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

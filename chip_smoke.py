#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``monica_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the banded-SW CUDA kernels from ``monica_tpu_torch/ops/csrc``
(and the FASTQ parser, both at once) and prints what ptxas and cuobjdump
say of them (``[build]``: registers, shared memory, spills, DPX
instructions); holds each kernel bit-equal to its plain PyTorch version
on the card at the main path's shapes, with its time beside its bound
(``[kernels]``); then drives the port's paths:

* the single-shard classify step — a 64 Mbase index and
  ``Classifier.classify``/``fetch`` — on the bench workload (16 batches
  of 2048 1 kb reads at 5% substitutions) and on coverage batches that
  reach every kernel (high-error rescue, matching mode, 20-30 kb reads,
  band 128), with the bench batch timed stage by stage, the device's
  busy share under ``torch.profiler`` and the matching-mode and 32 kb
  rates;
* the cross-shard merge on random tie-rich hit stacks, the card held
  equal to the CPU (``[merge_agree]``);
* the index build on the card (``[index]``: the 64 Mbase index sketched
  and sorted on the card, the ``Classifier``'s one-shard stack filled
  there bit-equal to the CPU fill of the same arrays), held bit-equal to
  the host build, with no overflow route, and a homopolymer reference
  that takes the counted overflow route (``[build_agree]``);
* the multi-shard streaming runtime — a 300 Mbase, 5-shard gut index
  sketched and sorted on the card (``[gut_index]``) and ``run_once`` over
  a folder of 8 nanopore FASTQ samples of 1,500 reads of 300-40,000 bp,
  then the abundance tables (``[stream]``, with the SW kernels' launch
  shapes), and the chunked, CPU and serial runs held equal to it
  (``[stream_agree]``); one more ``run_once`` of the same samples under
  ``torch.profiler`` gives the device's busy share over the pass and the
  SW kernels' device time and share of it (``[stream_profile]``);
* the multi-device step on meshes of the one card (``cuda:0`` repeated
  in every cell): a (data=1, index=3) mesh of the gut index held equal to
  the single-device Classifier on the stream's batches and its
  ``run_once`` tables byte-equal to ``[stream]``'s, a (2, 3) mesh's
  accuracy on the stream, both beside the single-device rate
  (``[mesh]``); the (2, 3) mesh on the card held equal to the same mesh
  on ``cpu`` x 6 (``[mesh_agree]``); two ``torch.distributed`` worker
  processes on the card (this script with ``--multiproc-worker``, backend
  ``gloo``, as NCCL refuses two ranks on one device), first with the data
  axis across them and different sample counts, then with the index axis
  across them, their tables held equal to the single-process run
  (``[multiproc]``);
* the product path — the CLI (``python -m monica_tpu_torch.cli``) on an
  offline world of the 10 Zymo genomes (taxdump, assembly summary,
  ``.fna.gz`` files) and 4 FASTQ samples of 4,000 reads: ``build_index``,
  then the analysis run on the cached index with its focus second pass
  (``[cli]``); the library run on the saved artifact and ``plot_only``
  held byte-equal to the CLI's tables and HTML (``[cli_agree]``);
* the accuracy harness, ``python -m monica_tpu_torch.concordance --device
  cuda`` at its default sizes, every row and the gate (``[concordance]``);
* the real-time loop: ``monica_tpu_torch.demo_watch`` at its default
  sizes, each pass with its batch-to-table latency (``[watch]``), and the
  CLI's ``--watch`` over the [cli] samples fed one at a time, byte-equal
  to [cli]'s outputs (``[cli_watch]``);
* the product's checks at their default sizes: quantification accuracy
  (``[abundance]``, r9_old also on the CPU, which must equal the card),
  rescue-tier demand and the r9_old gate (``[sensitivity]``), both beside
  the JAX package's artifacts, and the ingest memory bound
  (``[ingest_rss]``); each of these five phases prints its wall time;
* the measurement modules, each run as a user runs it (``python -m``, a
  child process, its exit code checked and its JSON line parsed and
  echoed), each with its wall time: ``bench`` by default, with ``--gut``
  and ``--no-extend`` (``[bench] module=...``: the device pipeline over
  16 resident batches, bench.py's window without the host pack and the
  upload that the Classifier's ``[bench] reads=...`` line above holds),
  ``profile_stages`` (five cumulative variants, launches a stage),
  ``bench_stream`` at 32,768 reads (its default 100,000 cut for time),
  ``bench_sw`` at 2048 × 1024 and
  ``roofline_sw`` (measured int32 and DPX rates, SASS instructions a
  step, both bands at 4096 × 1024), the first 128 reads of each of their
  SW calls held bit-equal to the plain version here and the ALU-ceiling
  kernel's scalar held to its plain version on the card, then
  ``exp_knobs``' 12 grid lines;
* BASELINE config 5, each a child process: ``scaling_curve`` (the mesh
  step's overhead on meshes of repeats of the card, ``[scaling_curve]``),
  ``podscale_model --no-share`` (the JAX script's structural run and the
  capacity rows from the card's memory, one shard's bytes and R1,
  ``[podscale]``) and ``podscale_model`` (the pod index's per-card share,
  ~56 shards of 64 Mbase built and classified on the card, accuracy >=
  0.95, the SW kernel launched, the (4, 2) mesh equal to the card alone,
  ``[podscale_share]``).

Every phase prints one line; any failure raises, so the exit code is
nonzero and the final line is missing.  The last two lines are the
kernel table (the three SW instances and the ALU-ceiling kernel) and
``{"ok": true, "device": {...}}``.

It needs CUDA: without a card it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import datetime
import gzip
import json
import os
import platform
import re
import runpy
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from monica_tpu_torch import bench, bench_sw, demo_watch, roofline_sw
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.evaluation import (bench_reads, gut_community, nanopore_lengths,
                                         nanopore_sample, random_shard_hits, sim_batch,
                                         write_fastq_sample, zymo_community)
from monica_tpu_torch.data import tables as tb
from monica_tpu_torch.index import artifact
from monica_tpu_torch.index import build as ib
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.io import native
from monica_tpu_torch.io import seq as seqio
from monica_tpu_torch.io.encode import pack_codes_2bit
from monica_tpu_torch.ops import _native, ceiling
from monica_tpu_torch.ops import extend as ex
from monica_tpu_torch.ops import lookup as lk
from monica_tpu_torch.parallel import dist
from monica_tpu_torch.parallel import mesh as pm
from monica_tpu_torch.plots import barplot
from monica_tpu_torch.stats.abundance import (DATAFRAME_FILENAME, RAW_DATAFRAME_FILENAME,
                                              AbundanceState, export_tables, read_dataframe)
from monica_tpu_torch.utils.metrics import Metrics, is_span

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
# the product path: the Zymo community's species (8 bacteria of 5 Mb, 2
# yeasts of 12 Mb, in zymo_community's order) and MinKNOW's default of
# 4,000 reads per FASTQ file
ZYMO_SPECIES = ["Pseudomonas aeruginosa", "Escherichia coli", "Salmonella enterica",
                "Lactobacillus fermentum", "Enterococcus faecalis", "Staphylococcus aureus",
                "Listeria monocytogenes", "Bacillus subtilis", "Saccharomyces cerevisiae",
                "Cryptococcus neoformans"]
FOCUS_SPECIES = "Escherichia coli"
CLI_SAMPLES = 4
CLI_READS = 4000
# the meshes on the one card: (n_data, n_index)
MESH_EQUAL = (1, 3)  # held equal to the single-device Classifier
MESH_SPLIT = (2, 3)  # the batch split over two data rows
MESH_AGREE_READS = (96, 32)  # [mesh_agree]'s CPU side: a 1 kb and a 4 kb batch
MULTIPROC_WAIT_S = 420  # both workers of one [multiproc] layout, together
SOURCE = "monica_tpu_torch/ops/csrc/banded_sw.cu"
# the card's peak rates, for a kernel's bound: HBM bytes/s from NVIDIA's
# H100 SXM data sheet; int32 instructions/s, which the data sheet does not
# list, as 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock, DPX
# instructions taken at the same rate ([roofline_sw] measures the DPX rate
# with the ALU-ceiling kernel; PERF.md has the reading)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 FMA instructions/s (the data sheet's 67 TFLOP/s outside the tensor
# cores, 2 flops an FMA): Hopper issues IMAD to the FMA pipe, beside the
# INT32 pipe, so the ALU-ceiling kernel's bound counts its IMADs at this rate
FMA_PER_S = 67e12 / 2
# (kernel instance, TPU kernel it replaces)
KERNELS = {
    "banded_sw_packed_w64": "monica_tpu/ops/extend.py:449",  # _sw_kernel_pairs
    "banded_sw_packed_w128": "monica_tpu/ops/extend.py:309",  # _sw_kernel_packed
    "banded_sw_pairstate_w64": "monica_tpu/ops/extend.py:258",  # _sw_kernel
}
# the ALU-ceiling kernel of [roofline_sw]: no port of a Pallas kernel, it
# takes the place of the XLA-fused int32 chain the JAX script times
CEILING = "alu_ceiling"
CEILING_SOURCE = "monica_tpu_torch/ops/csrc/alu_ceiling.cu"
CEILING_REPLACES = ("scripts/roofline_sw.py:40 (measure_vpu_ops_per_s: an XLA-fused int32 chain, "
                    "not a Pallas kernel)")
# the JSON keys of the JAX measurement programs the port's modules print
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "stat", "quiet_best",
              "loaded_floor"]  # bench.py:185-196
BENCH_SW_KEYS = ["metric", "value", "unit", "vs_baseline"]  # scripts/bench_sw.py:59-68
STREAM_KEYS = ["metric", "value", "unit", "workload", "device", "stat", "single_sample_reps",
               "single_sample_best", "n_mapped", "n_unmapped", "n_ambiguous", "index_build_s",
               "stage_reads_per_s", "cross_sample_overlap", "note"]  # scripts/bench_stream.py:166
ROOFLINE_KEYS = ["measured_vpu_gops_per_s", "measured_dpx_gops_per_s",
                 "speed_of_light_gcells_per_s", "fraction_of_light"]  # + the DPX rate
PROFILE_VARIANTS = ["sketch", "+lookup", "+chain", "full(noext)", "full(rescue)"]
SCALING_KEYS = ["what", "rows_per_device", "meshless_single_dispatch_s", "data_axis_weak_scaling",
                "index_axis", "lockstep_schedule_s_per_sample", "derived",
                "reading_guide"]  # scripts/scaling_curve.py:145-184
SCALING_DERIVED = ["mesh_entry_overhead", "sharding_overhead_8x",
                   "weak_scaling_eff_8x_cpu_core_bound", "index4_vs_index1"]
PODSCALE_KEYS = ["config", "structural_validation", "capacity_model", "seconds",
                 "verdict"]  # scripts/podscale_model.py:197-203; the port adds per_card_share
FIRST_READS = 128  # the reads of each full-card SW call held to the plain version
BENCH_STREAM_READS = 32_768  # of bench_stream's 100,000, so the smoke stays under 1,000 s


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


def sw_case(rng, dev, B, L, p, short=False, sub=0.08, alphabet=4, first=()):
    """Reads from a random reference at ``sub`` substitutions and their
    reference windows on the card; ``short`` PAD-tails every other read,
    a 2-letter ``alphabet`` makes equal-score cells (ties) common, and
    ``first`` sets the lengths of the first reads."""
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
    for b, n in enumerate(first):
        lengths[b] = n
        q[b, n:] = 4
    refwin = ex.extract_ref_windows(torch.from_numpy(ref).to(dev),
                                    torch.from_numpy(starts.astype(np.int32)).to(dev), L, W)
    return (torch.from_numpy(q).to(dev), refwin.contiguous(),
            torch.from_numpy(lengths).to(dev))


def kernel_ms(fn) -> float:
    """Mean device ms of fn() (CUDA events), after 0.2 s of calls that
    bring the card's clock up, over enough calls to fill ~0.1 s."""
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    while n < 2 or time.perf_counter() - t0 < 0.2:
        fn()
        torch.cuda.synchronize()
        n += 1
    est_ms = (time.perf_counter() - t0) / n * 1e3
    return cuda_ms(fn, max(3, int(100 / est_ms)))


def sw_bound(name: str, lengths: np.ndarray, L: int, p) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card needs for one call,
    the larger of its bytes (q, refwin and lengths read once, score and
    mlen written once) over HBM_BYTES_PER_S and its int32 instructions,
    for the rows these reads need, over INT32_OPS_PER_S.  The count is
    of instructions with Hopper's fused DPX forms, per cell and row, with
    k = ceil(log3 window) three-way maxes for the horizontal window
    (max is idempotent, so overlapping triples cover it):
    packed 7 + k — the match test and its select, the up candidate, the
    diagonal add, max and floor in one __viaddmax_s32_relu, the lane gap
    added, the gap taken off and the max in one __viaddmax_s32, the best;
    pair state 18 + k — the match test and its select, the up and
    diagonal candidates, their max with its "diagonal >= up" predicate in
    one __vibmax_s32, the floor and its predicate, m's diagonal successor
    and its two selections, the key u * 128 + d, h and the argmax taken
    from the key (shift, subtract, and), the select of the fetched m, and
    the lazy best (one __vibmax_s32 with its predicate, two selects).
    Shuffles are left out, so this stays a lower bound."""
    B, W = len(lengths), p.band
    rows = int(np.clip(lengths, 0, L).sum())
    per_cell = roofline_sw.per_cell_instructions(name.startswith("banded_sw_packed"), p)
    t_ops = rows * W * per_cell / INT32_OPS_PER_S
    t_bytes = (B * L + B * (L + W) + 12 * B) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def compare_kernels(dev) -> dict:
    """Each kernel against banded_sw_torch on the card, bit-equal, at the
    main path's shapes: the bench-era 128 x 1 kb and 8 x 32 kb, the
    stream's rescue tiers (~33 reads a tier) from 512 bp to 32 kb, reach
    20 and the full band at both widths, lengths 0 and 1, odd B, ties,
    and pair state at small L with both key widths (match 2^18: 64-bit
    keys; 8,000 and 4,000: 32-bit).  Timed cases print their bound, ns a
    row (over the longest read: the serial chain) and library_ms=none:
    no PyTorch call computes a banded SW.  The first timed case of each
    kernel goes into the JSON line."""
    rng = np.random.default_rng(SEED)
    p64, p128 = ex.ExtendParams(band=64), ex.ExtendParams(band=128)
    big = dict(match=1 << 18)  # disables packing at small L; 64-bit keys
    g20, g0 = dict(max_gap=20), dict(max_gap=0)
    cases = [  # (kernel instance, B, L, params, short, timed, alphabet, first lengths)
        ("banded_sw_packed_w64", 128, 1024, p64, False, True, 4, ()),
        ("banded_sw_packed_w64", 33, 16384, p64, True, True, 4, ()),
        ("banded_sw_packed_w64", 7, 300, p64, True, False, 4, ()),
        ("banded_sw_packed_w64", 33, 512, p64, True, False, 4, (0, 1)),
        ("banded_sw_packed_w64", 33, 2048, p64, True, False, 4, (0, 1)),
        ("banded_sw_packed_w64", 33, 4096, p64, True, False, 4, ()),
        ("banded_sw_packed_w64", 16, 8192, p64, True, False, 4, ()),
        ("banded_sw_packed_w64", 16, 16384, p64, True, False, 4, ()),
        ("banded_sw_packed_w64", 9, 1024, p64._replace(**g20), True, False, 2, (0, 1)),
        ("banded_sw_packed_w64", 9, 1024, p64._replace(**g0), True, False, 4, (1,)),
        ("banded_sw_packed_w128", 128, 1024, p128, False, True, 4, ()),
        ("banded_sw_packed_w128", 9, 1024, p128._replace(**g20), True, False, 2, (0, 1)),
        ("banded_sw_packed_w128", 9, 1024, p128._replace(**g0), True, False, 4, (1,)),
        ("banded_sw_pairstate_w64", 8, 32768, p64, True, True, 4, ()),
        ("banded_sw_pairstate_w64", 33, 32768, p64, True, True, 4, (0, 1)),
        ("banded_sw_pairstate_w64", 9, 32768, p64, True, False, 2, ()),
        ("banded_sw_pairstate_w64", 16, 1024, p64._replace(**big), True, False, 2, ()),
        ("banded_sw_pairstate_w64", 9, 1024, p64._replace(**g20, **big), True, False, 2, (0, 1)),
        ("banded_sw_pairstate_w64", 9, 1024, p64._replace(**g0, **big), True, False, 4, (1,)),
        ("banded_sw_pairstate_w64", 9, 1024, p64._replace(match=8000), True, False, 2, (0,)),
        ("banded_sw_pairstate_w128", 8, 1024, p128._replace(**big), True, False, 4, ()),
        ("banded_sw_pairstate_w128", 9, 1024, p128._replace(**g20, **big), True, False, 2, (0, 1)),
        ("banded_sw_pairstate_w128", 9, 1024, p128._replace(**g0, **big), True, False, 4, (1,)),
        ("banded_sw_pairstate_w128", 9, 2048, p128._replace(match=4000), True, False, 2, (0,)),
    ]
    out = {}
    for name, B, L, p, short, timed, alphabet, first in cases:
        q, refwin, lengths = sw_case(rng, dev, B, L, p, short, alphabet=alphabet, first=first)
        check((ex.packed_mbits(L, p) > 0) == name.startswith("banded_sw_packed"),
              f"{name} B={B} L={L}: the case takes the other kernel")
        before = _native.LAUNCHES[name]
        ks, km = ex.banded_sw(q, refwin, lengths, p, impl="cuda")
        torch.cuda.synchronize()
        check(_native.LAUNCHES[name] == before + 1, f"{name} did not launch")
        t0 = time.perf_counter()
        ps, pm = ex.banded_sw(q, refwin, lengths, p, impl="torch")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int(max((ks - ps).abs().max(), (km - pm).abs().max()))
        check(err == 0, f"{name} B={B} L={L} max_gap={p.max_gap}: kernel differs from plain by {err}")
        check(bool((ks >= 0).all() and (km <= lengths.clamp(min=0)).all()),
              f"{name}: implausible output")
        entry = out.setdefault(name, {"max_abs_err": 0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        msg = dict(kernel=name, B=B, L=L, W=p.band, max_gap=p.max_gap, match=p.match,
                   mbits=ex.packed_mbits(L, p), bit_equal=True)
        if timed:
            lens = lengths.cpu().numpy()
            ms = kernel_ms(lambda: ex.banded_sw(q, refwin, lengths, p, impl="cuda"))
            bound_ms, bound_by = sw_bound(name, lens, L, p)
            if "ms" not in entry:
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            msg.update(kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.1f}",
                       bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                       ns_per_row=f"{ms * 1e6 / max(int(lens.max()), 1):.1f}", library_ms="none")
        say("kernels", **msg)
    return out


def ptxas_summary(log: str) -> dict:
    """Per kernel (kind and width): instances, the range of registers a
    thread, shared memory and the stack and spill bytes, from -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            k = re.search(r"banded_sw_(packed|pairstate)_kernelILi(\d+)E", entry.group(1))
            name = f"banded_sw_{k.group(1)}_w{k.group(2)}" if k else None
            if name:
                e = out.setdefault(name, {"instances": 0, "regs": [], "smem": 0, "stack_spill": 0})
                e["instances"] += 1
        elif name and "spill" in line:
            out[name]["stack_spill"] += sum(int(x) for x in re.findall(r"(\d+) bytes", line))
        elif name and "Used" in line:
            out[name]["regs"].append(int(re.search(r"Used (\d+) registers", line).group(1)))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = max(out[name]["smem"], int(smem.group(1)) if smem else 0)
    for e in out.values():
        e["regs"] = f"{min(e['regs'])}-{max(e['regs'])}"
    return out


def dpx_opcodes(lib: Path) -> dict | str:
    """Counts of Hopper's DPX integer opcodes in the library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not tool.exists():
        return "cuobjdump unavailable"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    ops = re.findall(r"\b(VIADDMNMX|VIMNMX3|VIMNMX)((?:\.\w+)*)", sass)
    counts = {}
    for op, mods in ops:
        key = op + (".RELU" if "RELU" in mods else "")
        counts[key] = counts.get(key, 0) + 1
    return counts


def build_all() -> None:
    """[build]: the kernels and the FASTQ parser, built at once (nvcc and
    g++)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        main = pool.submit(_native.build)
        parser = pool.submit(native.available)
        main.result()
        parsed = parser.result()
    _native.load()
    ptxas = ptxas_summary(_native.library_path().with_suffix(".log").read_text())
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=_native.library_path().name,
        fastq_parser=native.library_path().name if parsed else "unavailable",
        ptxas=json.dumps(ptxas, separators=(",", ":")),
        dpx=json.dumps(dpx_opcodes(_native.library_path()), separators=(",", ":")))
    check(parsed, "the native FASTQ parser did not build")
    check(set(ptxas) == set(KERNELS) | {"banded_sw_pairstate_w128"},
          f"ptxas reported {sorted(ptxas)}")
    check(all(e["stack_spill"] == 0 for e in ptxas.values()), "a kernel spills or uses a stack")


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
    t = {k: [] for k in ("pack", "upload_reads", "upload_lengths", "classify_step",
                         "fetch", "classify_and_fetch")}
    for batch in codes:
        t0 = time.perf_counter()
        packed = pack_codes_2bit(batch)
        t["pack"].append((time.perf_counter() - t0) * 1e3)
        dev_packed, ms = synced_ms(lambda: clf._upload(packed))
        t["upload_reads"].append(ms)
        dev_lens, ms = synced_ms(lambda: clf._upload(lengths))
        t["upload_lengths"].append(ms)
        out, ms = synced_ms(lambda: pl.classify_batch_grouped_packed(
            clf.index, dev_packed, dev_lens, batch.shape[1], params,
            clf.meta.n_accessions, clf.count_mode))
        t["classify_step"].append(ms)
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
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not is_span(e.name)]
    if not spans:  # the profiler saw no device activity
        return dict(batches=len(codes), wall_ms=round(wall_ms, 2), busy_share="not measured")
    busy_ms = merged_ms(spans)
    return dict(batches=len(codes), wall_ms=round(wall_ms, 2), device_events=len(spans),
                busy_ms=round(busy_ms, 3), busy_share=round(busy_ms / wall_ms, 4))


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


def device_build(dev, build):
    """(build(), seconds) with the build-route counters reset first, the
    card synced on both sides and its peak memory over the build (MiB)."""
    ib.reset_build_routes()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = build()
    torch.cuda.synchronize()
    return built, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**20


def single_shard(dev):
    """The single-shard paths: the index built on the card, bench
    workload, coverage batches, agreement, stage times, busy share,
    rates.  Returns the kernel launches counted over the bench and
    coverage runs, and the Zymo sequences, index and build seconds."""
    rng = np.random.default_rng(SEED)
    seqs = zymo_community(rng)
    built, build_s, build_mb = device_build(
        dev, lambda: build_index_from_arrays(seqs, n_shards=1, device=dev))
    check(ib.BUILD_ROUTES == {"device_sketch_sort": 1, "overflow": 0},
          f"the Zymo index was not sketched and sorted on the card: {ib.BUILD_ROUTES}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = rt.Classifier(built, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    (group,) = clf.index
    check(group.mz_rows.shape[0] == 1, f"one shard, a stack of {group.mz_rows.shape[0]}")
    rbits = lk.row_bits_for(built.shards[0].n_minimizers)
    check(torch.equal(group.mz_rows[0].cpu(), filled_table(built.shards[0], clf.params.tag_bits,
                                                           rbits)),
          "the Classifier's stack on the card differs from the CPU fill of the same arrays")
    say("index", mbase=f"{sum(map(len, seqs)) / 1e6:.1f}", shards=len(built.shards),
        route="device_sketch_sort", build_s=f"{build_s:.2f}", build_peak_mb=f"{build_mb:.0f}",
        upload_s=f"{upload_s:.2f}", table_rows=group.mz_rows.shape[1], table_bit_equal=True,
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

    return launches, seqs, built, build_s


def filled_table(shard, tag_bits: int, rbits: int, device="cpu") -> torch.Tensor:
    """A shard's hash table filled by ``lookup.fill_hash_rows`` from its
    host arrays on ``device``, fetched to the CPU."""
    arrays = (shard.mz_hash.view(np.int32), shard.mz_pos, shard.mz_strand)
    return lk.fill_hash_rows(*(torch.from_numpy(a).to(device) for a in arrays), tag_bits,
                             rbits).cpu()


def build_agree(dev, seqs, built, card_s) -> None:
    """[build_agree]: the Zymo index built on the host (device cpu) against
    the card's build of [index]: the arrays the card sketched, sorted and
    fetched equal to the host shard's, and the card's table fill of them
    bit-equal to the CPU fill.  Then a homopolymer-rich reference
    overflows a segment's compaction capacity on the card: the counted
    overflow route, and the host build's arrays."""
    t0 = time.perf_counter()
    host = build_index_from_arrays(seqs, n_shards=1, device="cpu")
    host_s = time.perf_counter() - t0
    hs, ds = host.shards[0], built.shards[0]
    for f in ("ref_codes", "seq_starts", "seq_lengths", "seq_accession_id", "mz_hash",
              "mz_pos", "mz_strand", "pos_accession_id"):
        a, b = getattr(ds, f), getattr(hs, f)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"the card's {f} differs from the host's")
    tag_bits = lk.tag_bits_for(len(hs.ref_codes))
    rbits = lk.row_bits_for(hs.n_minimizers)
    check(torch.equal(filled_table(ds, tag_bits, rbits, dev), filled_table(hs, tag_bits, rbits)),
          "the card's table fill differs from the CPU fill")

    rng = np.random.default_rng(SEED + 5)
    homo = [np.concatenate([np.zeros(1 << 22, np.uint8),
                            rng.integers(0, 4, 200_000).astype(np.uint8)])]
    routed, _, _ = device_build(dev, lambda: build_index_from_arrays(homo, device=dev))
    check(ib.BUILD_ROUTES == {"device_sketch_sort": 0, "overflow": 1},
          f"homopolymer: routes {ib.BUILD_ROUTES}")
    ref = build_index_from_arrays(homo, device="cpu")
    for f in ("mz_hash", "mz_pos", "mz_strand", "pos_accession_id"):
        check(np.array_equal(getattr(routed.shards[0], f), getattr(ref.shards[0], f)),
              f"homopolymer: {f} differs from the host build")
    say("build_agree", mbase=f"{len(hs.ref_codes) / 1e6:.1f}", n_kept=hs.n_minimizers,
        table_bit_equal=True, arrays_equal=True, overflow_routes=0,
        host_build_s=f"{host_s:.2f}", card_build_s=f"{card_s:.2f}",
        homopolymer_route="overflow", homopolymer_equals_host=True)


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
    shards, each sketched and sorted on the card, the rest of the build
    on the host with a thread per shard, then stacked by size class on
    the card."""
    rng = np.random.default_rng(SEED)
    seqs = gut_community(rng)
    built, build_s, build_mb = device_build(
        dev, lambda: build_index_from_arrays(seqs, n_shards=GUT_SHARDS, device=dev))
    check(len(built.shards) == GUT_SHARDS, f"{len(built.shards)} shards, not {GUT_SHARDS}")
    check(ib.BUILD_ROUTES == {"device_sketch_sort": GUT_SHARDS, "overflow": 0},
          f"gut: not every shard was sketched and sorted on the card: {ib.BUILD_ROUTES}")
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
        minimizers=[sh.n_minimizers for sh in built.shards], route="device_sketch_sort",
        build_s=f"{build_s:.2f}", build_peak_mb=f"{build_mb:.0f}",
        upload_s=f"{upload_s:.1f}",
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
                 max_len: int | None = None, names: list[str] | None = None) -> dict:
    """Write simulated nanopore FASTQ samples; returns the true tax unit
    of each read sequence (``names[g]``, else ``Species_<g>``)."""
    folder.mkdir(parents=True, exist_ok=True)
    truth = {}
    for k in range(n_samples):
        lengths = nanopore_lengths(rng, n_reads, *STREAM_LEN)
        if max_len is not None:
            lengths = np.minimum(lengths, max_len)
        reads, labels = nanopore_sample(seqs, rng, lengths, STREAM_ERROR)
        write_fastq_sample(folder / f"{prefix}{k}.fastq", reads, prefix=f"{prefix}{k}_r")
        for r, g in zip(reads, labels):
            truth[enc.decode_seq(r)] = names[g] if names else f"Species_{g}"
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
    return bench.host_syncs(lambda: clf.classify(codes, lengths), clf.device)


def launch_shapes() -> dict:
    """The SW launches since the last reset, as "kernel:BxL" -> count."""
    return {f"{k}:{B}x{L}": n for (k, B, L), n in sorted(_native.LAUNCH_SHAPES.items())}


def merged_ms(spans) -> float:
    """Milliseconds covered by the union of (start, end) microsecond spans."""
    busy_us, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0 if cur is None else cur[1] - cur[0]
    return busy_us / 1e3


def stream_profile(dev, built, clf, tmp: Path, first: dict) -> None:
    """[stream_profile]: run_once over the [stream] samples once more, under
    torch.profiler: the device's busy share over the pass (the union of
    its kernel and copy intervals over the wall time) and each SW
    kernel's summed device ms, with their sum's share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    q, out = tmp / "p_query", tmp / "p_out"
    q.mkdir()
    for name, data in first["inputs"].items():
        (q / name).write_bytes(data)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reports, wall_ms = synced_ms(lambda: rt.run_once(clf, q, out, max_batch=STREAM_BATCH))
    check_consumed(q, reports, STREAM_SAMPLES, "stream_profile")
    check(report_rows(reports) == first["reports"], "stream_profile: reports differ from [stream]")
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not is_span(e.name)]
    check(bool(device), "stream_profile: the profiler saw no device activity")
    busy_ms = merged_ms((e.time_range.start, e.time_range.end) for e in device)
    sw_ms, sw_n = {}, {}
    for e in device:
        k = re.search(r"banded_sw_(packed|pairstate)_kernel<(\d+)", e.name)
        if k:
            name = f"banded_sw_{k.group(1)}_w{k.group(2)}"
            sw_ms[name] = sw_ms.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            sw_n[name] = sw_n.get(name, 0) + 1
    total = sum(sw_ms.values())
    say("stream_profile", wall_ms=f"{wall_ms:.1f}", device_events=len(device),
        busy_ms=f"{busy_ms:.1f}", busy_share=f"{busy_ms / wall_ms:.4f}",
        sw_ms=json.dumps({k: round(v, 3) for k, v in sorted(sw_ms.items())}, separators=(",", ":")),
        sw_launches=json.dumps(dict(sorted(sw_n.items())), separators=(",", ":")),
        sw_ms_total=f"{total:.3f}", sw_share_of_wall=f"{total / wall_ms:.4f}",
        sw_share_of_busy=f"{total / busy_ms:.4f}")
    check(sw_n.get("banded_sw_pairstate_w64", 0) > 0 and sw_n.get("banded_sw_packed_w64", 0) > 0,
          f"stream_profile: the profile shows SW launches {sw_n}")


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
    launches, shapes = dict(_native.LAUNCHES), launch_shapes()
    # ---- end of the streaming path ----
    check_consumed(q, reports, STREAM_SAMPLES, "stream")
    check(sum(r.n_reads for r in reports) == n_reads, "stream: read count")
    check(native.PARSED["views"] >= STREAM_SAMPLES, "stream: the native parser did not run")
    check(native.PACKED["native"] > 0 and native.PACKED["numpy"] == 0,
          f"stream: the native 2-bit pack did not pack every batch: {native.PACKED}")
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
        parsed=native.PARSED["views"], packed=json.dumps(native.PACKED, separators=(",", ":")),
        launches=json.dumps(launches, separators=(",", ":")),
        launch_shapes=json.dumps(shapes, separators=(",", ":")))
    check(acc >= MIN_ACCURACY, f"stream accuracy {acc:.4f} < {MIN_ACCURACY}")

    # the rescue tier pick costs one host sync per size-class group and batch
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
                reports=report_rows(reports), launches=launches, truth=truth,
                tables={f: (out / f).read_bytes()
                        for f in (DATAFRAME_FILENAME, RAW_DATAFRAME_FILENAME)})


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


def mapped_correct(q: Path, names, truth: dict) -> int:
    """Reads routed to mapped/ under their true tax unit."""
    return sum(truth[rec.seq] == rec.id for name in names
               for rec in seqio.read_fastq(q / rt.MAPPED_DIR / name))


def stream_batches(clf, tmp: Path, first: dict) -> list:
    """The [stream] samples' device batches, as run_once makes them for
    ``clf`` (padded to its row multiple)."""
    src = tmp / "batch_src"
    src.mkdir(parents=True, exist_ok=True)
    out = []
    for name, data in first["inputs"].items():
        (src / name).write_bytes(data)
        out += rt._prepare_sample(clf, src / name, enc.DEFAULT_BUCKETS, STREAM_BATCH,
                                  Metrics(verbose=False)).batches
    return out


def timed_batches(clf, batches) -> tuple[list, float]:
    """(fetched results, wall seconds between two device syncs)."""
    outs, ms = synced_ms(lambda: [clf.fetch(*clf.classify(b.codes, b.lengths)) for b in batches])
    return outs, ms / 1e3


def mesh_run(dev, seqs, built, clf, tmp: Path, first: dict, shape) -> None:
    """One [mesh] line: the gut index on an (n_data, n_index) mesh of the
    card, the stream's batches through it and through the single-device
    Classifier (timed in turn, results compared), then run_once over the
    stream's samples on the mesh, with the SW launches of the mesh's
    batches and run_once, its host syncs a bench batch and its peak."""
    nd, ni = shape
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mclf, stack_s = synced_ms(lambda: rt.Classifier(built, mesh=pm.make_mesh(
        nd, ni, devices=[dev] * (nd * ni))))
    index_mb = (torch.cuda.memory_allocated() - before) / 2**20
    mult = mclf.batch_row_multiple()
    batches = [enc.pad_rows(b, mult) for b in stream_batches(clf, tmp / f"m{nd}x{ni}", first)]
    n_reads = STREAM_SAMPLES * STREAM_READS
    mclf.fetch(*mclf.classify(batches[0].codes, batches[0].lengths))  # warm-up
    single, single_s = timed_batches(clf, batches)

    # ---- the mesh path: launch counts cover exactly this stretch ----
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    outs, mesh_s = timed_batches(mclf, batches)
    q, out = tmp / f"mesh{nd}x{ni}_query", tmp / f"mesh{nd}x{ni}_out"
    q.mkdir()
    for name, data in first["inputs"].items():
        (q / name).write_bytes(data)
    reports, run_ms = synced_ms(lambda: rt.run_once(mclf, q, out, max_batch=STREAM_BATCH))
    launches, shapes = dict(_native.LAUNCHES), launch_shapes()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # ---- end of the mesh path ----
    check_consumed(q, reports, STREAM_SAMPLES, f"mesh {nd}x{ni}")
    for name in ("banded_sw_packed_w64", "banded_sw_pairstate_w64"):
        check(launches[name] > 0, f"mesh {nd}x{ni}: {name} never launched")
    differ = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum()) for a, b in zip(outs, single))
    acc = mapped_correct(q, first["inputs"], first["truth"]) / n_reads
    state = AbundanceState.load(out, built.meta.n_accessions)
    export_tables(state, built.meta, out)
    codes, _ = bench_reads(seqs, np.random.default_rng(SEED + 2), BATCH, READ_LEN, SUB_RATE)
    syncs = host_syncs(mclf, codes, np.full(BATCH, READ_LEN, np.int32))
    if shape == MESH_EQUAL:
        for a, b in zip(outs, single):
            same(a, b, f"mesh {nd}x{ni} vs single device")
        check(routed(q) == first["routed"], f"mesh {nd}x{ni}: routed bytes differ from [stream]")
        same_state(dict(state.samples), first["state"], f"mesh {nd}x{ni} vs [stream]")
        for f, data in first["tables"].items():
            check((out / f).read_bytes() == data, f"mesh {nd}x{ni}: {f} differs from [stream]'s")
    check(acc >= MIN_ACCURACY, f"mesh {nd}x{ni}: accuracy {acc:.4f} < {MIN_ACCURACY}")
    say("mesh", data=nd, index=ni, devices=f"cuda:0x{nd * ni}",
        shards_per_rank=[mclf.index[(0, i)][0].mz_rows.shape[0] for i in range(ni)],
        stack_s=f"{stack_s / 1e3:.2f}", index_mb=f"{index_mb:.0f}", batches=len(batches),
        reads=n_reads, mesh_reads_per_s=f"{n_reads / mesh_s:.1f}",
        single_reads_per_s=f"{n_reads / single_s:.1f}", mesh_s=f"{mesh_s:.3f}",
        single_s=f"{single_s:.3f}", status_acc_differ_vs_single=differ,
        run_once_s=f"{run_ms / 1e3:.3f}", run_once_reads_per_s=f"{n_reads / run_ms * 1e3:.1f}",
        accuracy=f"{acc:.4f}", equal_to_single=shape == MESH_EQUAL or differ == 0,
        host_syncs_per_batch=len(syncs), peak_mb=f"{peak_mb:.0f}",
        launches=json.dumps(launches, separators=(",", ":")),
        launch_shapes=json.dumps(shapes, separators=(",", ":")))
    del mclf
    torch.cuda.empty_cache()


def mesh_agree(dev, seqs, built) -> None:
    """[mesh_agree]: the (2, 3) mesh on the card against the same mesh on
    cpu x 6 (the plain SW), on a 1 kb batch at high error (rescues) and
    a 4 kb batch: status, acc_id, mlen and counts equal."""
    rng = np.random.default_rng(SEED + 7)
    n1, n4 = MESH_AGREE_READS
    cases = [sim_batch(seqs, rng, n1, 800, 1024, (0.10, 0.04, 0.04), 1024)[:2],
             sim_batch(seqs, rng, n4, 2000, 4000, (0.08, 0.04, 0.04), 4096)[:2]]
    card = rt.Classifier(built, mesh=pm.make_mesh(*MESH_SPLIT, devices=[dev] * 6))
    t0 = time.perf_counter()
    cpu = rt.Classifier(built, mesh=pm.make_mesh(*MESH_SPLIT, devices=["cpu"] * 6))
    before = _native.LAUNCHES["banded_sw_packed_w64"]
    for codes, lengths in cases:
        same(cpu.fetch(*cpu.classify(codes, lengths)), card.fetch(*card.classify(codes, lengths)),
             f"mesh_agree {codes.shape}")
    check(_native.LAUNCHES["banded_sw_packed_w64"] > before, "mesh_agree: the card ran no SW")
    say("mesh_agree", data=MESH_SPLIT[0], index=MESH_SPLIT[1], batches=[list(c.shape) for c, _ in cases],
        cpu_vs_card=True, cpu_s=f"{time.perf_counter() - t0:.1f}")
    del card, cpu


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multiproc_worker(layout: str, rank: str, world: str, port: str, wdir: str) -> None:
    """One process of [multiproc] (``chip_smoke.py --multiproc-worker``):
    the gut index built on the card, a mesh of ``layout`` ("data": (2, 3),
    the data axis across the processes, 3 cells each; "index": (1, 2),
    the index axis across them, 1 cell each), run_once over its own query
    folder; its time and launches go to ``worker<rank>.json``."""
    rank, world, wdir = int(rank), int(world), Path(wdir)
    dev = torch.device("cuda")
    dist.multihost_init("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=MULTIPROC_WAIT_S))
    built = build_index_from_arrays(gut_community(np.random.default_rng(SEED)),
                                    n_shards=GUT_SHARDS, device=dev)
    shape, cells = (MESH_SPLIT, MESH_SPLIT[1]) if layout == "data" else ((1, 2), 1)
    mesh = pm.make_mesh(*shape, devices=[dev] * cells)
    clf = rt.Classifier(built, mesh=mesh)
    _native.reset_launch_counts()
    reports, ms = synced_ms(lambda: rt.run_once(clf, wdir / f"q{rank}", wdir / f"o{rank}",
                                                max_batch=STREAM_BATCH))
    (wdir / f"worker{rank}.json").write_text(json.dumps(dict(
        seconds=ms / 1e3, reads=sum(r.n_reads for r in reports), samples=len(reports),
        launches=dict(_native.LAUNCHES), owners=mesh.owners, local_rows=mesh.local_rows(),
        cross_process_rows=[d for d, g in enumerate(mesh.row_groups) if g is not None])))
    dist.shutdown()


def multiproc(dev, built, clf, tmp: Path, first: dict) -> None:
    """[multiproc]: two worker processes on the card, backend gloo (named,
    since NCCL refuses two ranks on one device).  Layout "data": 3 and 2
    of the stream's samples, so the lockstep filler runs; layout "index":
    the same 2 samples in both.  Each process's tables and routed files
    must equal the [stream] run's for its samples (the union of the
    per-process tables is the single-process result), and both workers
    must exit 0 within MULTIPROC_WAIT_S."""
    names = sorted(first["inputs"])
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    for layout, split in (("data", {0: names[:3], 1: names[3:5]}),
                          ("index", {0: names[5:7], 1: names[5:7]})):
        wdir = tmp / f"mp_{layout}"
        for rank, ns in split.items():
            (wdir / f"q{rank}").mkdir(parents=True)
            for n in ns:
                (wdir / f"q{rank}" / n).write_bytes(first["inputs"][n])
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--multiproc-worker", layout, str(rank), "2", str(port),
                                   str(wdir)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(t0 + MULTIPROC_WAIT_S - time.perf_counter(),
                                                      1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                print(log[-4000:], file=sys.stderr)
            check(p.returncode == 0, f"multiproc {layout}: a worker exited {p.returncode}")
        work = [json.loads((wdir / f"worker{r}.json").read_text()) for r in (0, 1)]
        for rank, ns in split.items():
            q, state = wdir / f"q{rank}", AbundanceState.load(wdir / f"o{rank}",
                                                                built.meta.n_accessions)
            check(set(state.samples) == {seqio.sample_name(n) for n in ns},
                  f"multiproc {layout}: process {rank} samples {sorted(state.samples)}")
            same_state(dict(state.samples), {k: first["state"][k] for k in state.samples},
                       f"multiproc {layout} process {rank} vs [stream]")
            mine = routed(q)
            check(mine == {k: v for k, v in first["routed"].items() if k.split("/")[1] in ns},
                  f"multiproc {layout}: process {rank}'s routed bytes differ from [stream]")
            check(work[rank]["launches"]["banded_sw_packed_w64"] > 0,
                  f"multiproc {layout}: process {rank} ran no SW")
        # the single-process rate on the same samples
        q = wdir / "single_query"
        q.mkdir()
        union = sorted({n for ns in split.values() for n in ns})
        for n in union:
            (q / n).write_bytes(first["inputs"][n])
        _, single_ms = synced_ms(lambda: rt.run_once(clf, q, wdir / "single_out",
                                                     max_batch=STREAM_BATCH))
        say("multiproc", layout=layout, backend="gloo", processes=2,
            mesh=f"{work[0]['owners']}", cross_process_rows=work[0]["cross_process_rows"],
            samples=[w["samples"] for w in work],
            worker_reads_per_s=[f"{w['reads'] / w['seconds']:.1f}" for w in work],
            worker_run_once_s=[f"{w['seconds']:.3f}" for w in work],
            single_process_reads_per_s=f"{len(union) * STREAM_READS / single_ms * 1e3:.1f}",
            single_process_s=f"{single_ms / 1e3:.3f}", wall_s=f"{wall:.1f}",
            tables_equal_single_process=True,
            launches=json.dumps([w["launches"] for w in work], separators=(",", ":")))


def artifact_rows(name: str) -> dict:
    """The JAX package's committed artifact ``name`` beside this script."""
    return json.loads((Path(__file__).resolve().parent / name).read_text())


def artifact_diff(row: dict, artifact_row: dict) -> dict:
    """The artifact's values of the fields (all but the timing) where
    ``row`` differs from it."""
    return {k: artifact_row.get(k) for k in row
            if k != "seconds" and row[k] != artifact_row.get(k)}


def flat(row: dict) -> dict:
    """A row for say(): lists and dicts as compact JSON."""
    return {k: json.dumps(v, separators=(",", ":")) if isinstance(v, (list, tuple, dict)) else v
            for k, v in row.items()}


def concordance_phase(tmp: Path) -> None:
    """[concordance]: ``python -m monica_tpu_torch.concordance --device
    cuda`` at its default sizes (in this process, as its __main__), every
    row printed; the gates must pass."""
    art = tmp / "concordance.json"
    _native.reset_launch_counts()
    rc, wall = run_cli(["--device", "cuda", "--out", str(art)], tmp / "concordance.log",
                       module="monica_tpu_torch.concordance")
    out = json.loads(art.read_text())
    for r in out["rows"] + out["strain_rows"]:
        say("concordance", **flat(r))
    say("concordance", verdict=repr(out["verdict"]), worst_gated_accuracy=out["worst_gated_accuracy"],
        r9_old_gate=out["r9_old_gate"]["pass"], strain_gate=out["strain_gate"],
        exit_code=rc, wall_s=f"{wall:.1f}",
        launches=json.dumps(dict(_native.LAUNCHES), separators=(",", ":")))
    check(rc == 0 and out["verdict"] == "PASS" and out["worst_gated_accuracy"] >= MIN_ACCURACY,
          f"concordance: exit {rc}, verdict {out['verdict']}")


def write_world(seqs, tmp: Path) -> list[str]:
    """An offline NCBI for the 10 Zymo genomes: a taxdump (Bacteria and
    Eukaryota, a genus and a species node per genome), one assembly
    summary naming them, and the genomes as ``.fna.gz`` files under the
    summary's ftp basenames.  Returns the CLI's transport flags."""
    taxdump, gdir = tmp / "taxdump", tmp / "genome_files"
    taxdump.mkdir()
    gdir.mkdir()
    nodes, names, rows = [(1, 1), (2, 1), (2759, 1)], {1: "root", 2: "Bacteria",
                                                       2759: "Eukaryota"}, []
    for i, (species, codes) in enumerate(zip(ZYMO_SPECIES, seqs)):
        genus, taxid = 100 + i, 200 + i
        nodes += [(genus, 2 if i < 8 else 2759), (taxid, genus)]
        names[genus], names[taxid] = species.split()[0], species
        acc = f"GCF_{taxid:09d}.1"
        ftp = f"https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/{acc}_zymo"
        rows.append({"# assembly_accession": acc, "taxid": str(taxid),
                     "species_taxid": str(taxid), "organism_name": species,
                     "infraspecific_name": "strain=ZYMO", "isolate": "na", "ftp_path": ftp})
        text = enc.decode_seq(codes)
        with gzip.open(gdir / f"{acc}_zymo_genomic.fna.gz", "wt", compresslevel=1) as fh:
            fh.write(f">NZ_{acc}_chr {species} ZYMO\n")
            fh.write("\n".join(text[j : j + 80] for j in range(0, len(text), 80)) + "\n")
    (taxdump / "nodes.dmp").write_text("".join(f"{c}\t|\t{p}\t|\trank\t|\n" for c, p in nodes))
    (taxdump / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for t, n in names.items()))
    summary = tmp / "assembly_summary.txt"
    tb.write_fixture_summary(summary, rows)
    return ["--taxdump", str(taxdump), "--offline_tables", str(summary), str(summary),
            "--offline_genomes", str(gdir)]


def run_cli(argv: list[str], log: Path, module: str = "monica_tpu_torch.cli") -> tuple[int, float]:
    """Run ``python -m <module> <argv>`` (the CLI by default) in this
    process (the module run as __main__, as the interpreter runs it, so
    the kernel launch counters see its launches), its stdout appended to
    ``log``.  Returns (exit code, wall seconds)."""
    argv0, sys.argv = sys.argv, [module, *argv]
    t0 = time.perf_counter()
    try:
        with open(log, "a") as fh, contextlib.redirect_stdout(fh):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException:
        print("".join(log.read_text().splitlines(True)[-40:]), file=sys.stderr)
        raise
    finally:
        sys.argv = argv0
    return rc, time.perf_counter() - t0


def cli(dev, seqs, tmp: Path) -> dict:
    """[cli]: the port's CLI on an offline world of the 10 Zymo genomes.
    ``build_index`` builds the guests' group and the focus group on the
    card; the analysis run (the default query_length mode) over 4 FASTQ
    samples of 4,000 nanopore reads loads the cached indexes, routes and
    counts the reads, writes the tables and the barplot, and runs the
    focus second pass."""
    rng = np.random.default_rng(SEED + 6)
    transport = write_world(seqs, tmp)
    root, q, out, log = tmp / "cli_root", tmp / "cli_query", tmp / "cli_out", tmp / "cli.log"
    units = ["_".join(sp.split()) for sp in ZYMO_SPECIES]
    truth = draw_samples(seqs, rng, q, CLI_SAMPLES, CLI_READS, "run", names=units)
    inputs = {p.name: p.read_bytes() for p in sorted(q.glob("*.fastq"))}
    n_reads, n_bases = CLI_SAMPLES * CLI_READS, sum(len(r) for r in truth)
    common = ["--root", str(root), *transport, "--device", dev.type]
    groups = ["-G", *ZYMO_SPECIES, "-F", FOCUS_SPECIES]

    ib.reset_build_routes()
    rc, build_wall = run_cli(["build_index", *common, *groups], log)
    check(rc == 0, f"cli build_index exited {rc}")
    check(ib.BUILD_ROUTES == {"device_sketch_sort": 2, "overflow": 0},
          f"cli build_index: the G_ and F_ groups did not build on the card: {ib.BUILD_ROUTES}")
    indexes = artifact.list_indexes(root / "indexes", root)
    check(sorted(p.name[:2] for p in indexes) == ["F_", "G_"], f"cli indexes: {indexes}")

    ib.reset_build_routes()
    # ---- the CLI's analysis path: launch counts cover exactly this run ----
    _native.reset_launch_counts()
    rc, wall = run_cli([*common, "-q", str(q), "-o", str(out), *groups, "--not_auto_open_plot"],
                       log)
    launches, shapes = dict(_native.LAUNCHES), launch_shapes()
    # ---- end of the CLI's analysis path ----
    check(rc == 0, f"cli analysis run exited {rc}")
    for f in (DATAFRAME_FILENAME, RAW_DATAFRAME_FILENAME, barplot.BARPLOT_FILENAME,
              "metrics.json", f"focus/{DATAFRAME_FILENAME}", f"focus/{barplot.BARPLOT_FILENAME}"):
        check((out / f).exists(), f"cli: {f} not written")
    failed = sorted(p.name for p in (q / rt.FAILED_DIR).glob("*"))
    check(not failed and not list(q.glob("*.fastq")), f"cli: quarantined {failed}, or not consumed")
    stages = json.loads((out / "metrics.json").read_text())
    check(any(k.startswith("load_index:G_") for k in stages)
          and any(k.startswith("load_index:F_") for k in stages)
          and not any(k.startswith("build_index:") for k in stages)
          and ib.BUILD_ROUTES == {"device_sketch_sort": 0, "overflow": 0},
          f"cli: the analysis run did not load both cached indexes: {sorted(stages)}")
    correct = sum(truth[rec.seq] == rec.id for name in inputs
                  for rec in seqio.read_fastq(q / rt.MAPPED_DIR / name))
    acc = correct / n_reads
    focus_mapped = sum(1 for p in (q / rt.FOCUS_DIR / rt.MAPPED_DIR).glob("*.fastq")
                       for _ in seqio.read_fastq(p))
    check(focus_mapped > 0, "cli: the focus pass mapped nothing")
    for name in ("banded_sw_packed_w64", "banded_sw_pairstate_w64"):
        check(launches[name] > 0, f"cli: {name} never launched in the analysis run")
    # the analysis run's stages (both passes); the rest of the wall time is
    # the Classifiers' set-up, the tables, the barplots and the focus copy
    split = {k: sum(v["seconds"] for name, v in stages.items() if name.startswith(k + ":"))
             for k in ("fetch", "load_index", "parse", "dispatch", "classify", "route")}
    say("cli", samples=CLI_SAMPLES, reads=n_reads, mbases=f"{n_bases / 1e6:.1f}",
        build_index_wall_s=f"{build_wall:.2f}", analysis_wall_s=f"{wall:.2f}",
        reads_per_s=f"{n_reads / wall:.1f}", mbases_per_s=f"{n_bases / 1e6 / wall:.2f}",
        accuracy=f"{acc:.4f}", focus_mapped=focus_mapped, cached_index_loaded=True,
        **{f"{k}_s": f"{v:.3f}" for k, v in split.items()},
        other_s=f"{wall - sum(split.values()):.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
        launch_shapes=json.dumps(shapes, separators=(",", ":")))
    check(acc >= MIN_ACCURACY, f"cli accuracy {acc:.4f} < {MIN_ACCURACY}")
    return dict(root=root, q=q, out=out, log=log, inputs=inputs, common=common, groups=groups)


def cli_agree(dev, tmp: Path, run: dict) -> None:
    """[cli_agree]: the same samples through the library on the G_
    artifact (load_index -> Classifier -> run_once -> export_tables):
    routed reads and both tables byte-equal to the CLI's.  Then
    ``plot_only`` re-renders the CLI's HTML: byte-equal to the library's
    barplot of its own tables, and to the CLI's run but for the title
    (plot_only knows no species and no mode)."""
    root, out = run["root"], run["out"]
    q, lib_out = tmp / "lib_query", tmp / "lib_out"
    q.mkdir()
    for name, data in run["inputs"].items():
        (q / name).write_bytes(data)
    (g_dir,) = [p for p in artifact.list_indexes(root / "indexes", root) if p.name[:2] == "G_"]
    built = artifact.load_index(g_dir)
    clf = rt.Classifier(built, device=dev)
    reports = rt.run_once(clf, q, lib_out)
    check_consumed(q, reports, CLI_SAMPLES, "cli_agree")
    norm, raw = export_tables(AbundanceState.load(lib_out, built.meta.n_accessions),
                              built.meta, lib_out)
    check(routed(q) == routed(run["q"]), "cli_agree: routed reads differ from the CLI's")
    for f in (DATAFRAME_FILENAME, RAW_DATAFRAME_FILENAME):
        check((lib_out / f).read_bytes() == (out / f).read_bytes(),
              f"cli_agree: {f} differs from the CLI's")
    html = out / barplot.BARPLOT_FILENAME
    live = html.read_bytes()
    rc, _ = run_cli(["--root", str(root), "plot_only", "-d", str(out / DATAFRAME_FILENAME),
                     "--not_auto_open_plot"], run["log"])
    check(rc == 0, f"plot_only exited {rc}")
    replot = html.read_bytes()
    lib_html = barplot.plotter(norm, raw, tmp / "lib_plot", auto_open=False).read_bytes()
    check(replot == lib_html, "plot_only differs from the library's barplot of its tables")
    title = f"Guests: {', '.join(ZYMO_SPECIES)}; analysis mode: single".encode()
    check(live.count(title) == 2 and replot == live.replace(title, b"Analysis mode: None"),
          "plot_only differs from the CLI run's barplot beyond the title")
    back = read_dataframe(out / DATAFRAME_FILENAME)
    check(back.index == norm.index and np.array_equal(back.values, norm.values, equal_nan=True),
          "read_dataframe differs from the table written")
    say("cli_agree", routed_equal=True, tables_byte_equal=True, plot_only_equals_library=True,
        plot_only_equals_cli_but_title=True, html_bytes=len(replot))


def watch_phase(dev, tmp: Path, smi: str) -> None:
    """[watch]: ``monica_tpu_torch.demo_watch`` at its default sizes on the
    card (the JAX demo's workload: a feeder thread renames 4 batches of
    8,192 1 kb reads into the query folder 2 s apart while ``watch``
    polls), every pass printed with its batch-to-table latency.  The gate,
    32,768 reads, and a total that grows by 8,192,000 counted bases for
    each file a pass took, from the warm sample's 4,096,000 to 36,864,000."""
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    payload, _ = demo_watch.run(dev, tmp / "watch", **demo_watch.FULL)
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    full = demo_watch.FULL
    total = full["warm_reads"] * demo_watch.READ_LEN
    for b in payload["batch_log"]:
        say("watch", **flat(b))
        total += len(b["samples"]) * full["reads"] * demo_watch.READ_LEN
        check(b["accumulated_count_total"] == total,
              f"watch: total {b['accumulated_count_total']} after {b['samples']}, not {total}")
    lat = [b["latency_s"] for b in payload["batch_log"]]
    say("watch", verdict=payload["verdict"], reads_processed=payload["reads_processed"],
        mapped=payload["mapped"], passes=len(lat), latency_s_max=f"{max(lat):.4f}",
        latency_s_median=f"{float(np.median(lat)):.4f}", index_build_s=payload["index_build_s"],
        device=repr(payload["device"]), gpu=repr(smi), wall_s=f"{wall:.1f}",
        launches=json.dumps(launches, separators=(",", ":")))
    n = full["n_batches"] * full["reads"]
    check(payload["verdict"] == "PASS", f"watch: verdict {payload['verdict']}")
    check(payload["reads_processed"] == n, f"watch: {payload['reads_processed']} reads, not {n}")
    check(total == 36_864_000, f"watch: final total {total}")
    torch.cuda.empty_cache()


def cli_watch(tmp: Path, run: dict) -> None:
    """[cli_watch]: the [cli] analysis run again on the cached indexes with
    ``--watch --poll 0.5 --max_idle_polls 8``, its 4 samples renamed into
    an empty query folder one at a time, 1 s apart, by a feeder thread:
    the routed reads and both tables byte-equal to [cli]'s, which found
    all 4 at once."""
    q, out = tmp / "cliw_query", tmp / "cliw_out"
    q.mkdir()

    def feeder():
        for name, data in sorted(run["inputs"].items()):
            part = q / f".{name}.tmp"
            part.write_bytes(data)
            part.rename(q / name)
            time.sleep(1.0)

    th = threading.Thread(target=feeder)
    _native.reset_launch_counts()
    th.start()
    try:
        rc, wall = run_cli([*run["common"], "-q", str(q), "-o", str(out), *run["groups"],
                            "--not_auto_open_plot", "--watch", "--poll", "0.5",
                            "--max_idle_polls", "8"], run["log"])
    finally:
        th.join()
    launches = dict(_native.LAUNCHES)
    check(rc == 0, f"cli --watch exited {rc}")
    check(not list(q.glob("*.fastq")) and not (q / rt.FAILED_DIR).exists(),
          "cli --watch: a sample was not consumed, or quarantined")
    check(routed(q) == routed(run["q"]), "cli --watch: routed reads differ from [cli]'s")
    for f in (DATAFRAME_FILENAME, RAW_DATAFRAME_FILENAME):
        check((out / f).read_bytes() == (run["out"] / f).read_bytes(),
              f"cli --watch: {f} differs from [cli]'s")
    for name in ("banded_sw_packed_w64", "banded_sw_pairstate_w64"):
        check(launches[name] > 0, f"cli --watch: {name} never launched")
    say("cli_watch", exit_code=rc, wall_s=f"{wall:.2f}", samples=len(run["inputs"]),
        feed_gap_s=1.0, routed_equal=True, tables_byte_equal=True,
        launches=json.dumps(launches, separators=(",", ":")))


def abundance_phase(tmp: Path) -> None:
    """[abundance]: ``python -m monica_tpu_torch.abundance_accuracy --device
    cuda`` at its default sizes (8,192 reads x 4 profiles), every row
    beside ``ABUNDANCE_r05.json``'s (the JAX package's), the gate; then the
    r9_old profile on the CPU (its own host build), which must equal the
    card's row."""
    art = tmp / "abundance.json"
    _native.reset_launch_counts()
    rc, wall = run_cli(["--device", "cuda", "--out", str(art)], tmp / "abundance.log",
                       module="monica_tpu_torch.abundance_accuracy")
    launches = dict(_native.LAUNCHES)
    out = json.loads(art.read_text())
    ref = {r["profile"]: r for r in artifact_rows("ABUNDANCE_r05.json")["rows"]}
    for r in out["rows"]:
        diff = artifact_diff(r, ref[r["profile"]])
        say("abundance", **flat(r), artifact_equal=not diff,
            artifact_diff=json.dumps(diff, separators=(",", ":")))
    say("abundance", gate=out["gate"]["passed"], exit_code=rc, wall_s=f"{wall:.1f}",
        launches=json.dumps(launches, separators=(",", ":")))
    check(rc == 0 and out["gate"]["passed"], f"abundance: exit {rc}, gate {out['gate']}")
    check(launches["banded_sw_packed_w64"] > 0, "abundance: banded_sw_packed_w64 never launched")

    from monica_tpu_torch import abundance_accuracy as aa  # after runpy ran it as __main__

    seqs = aa.community(aa.GENOME_LENGTHS)
    t0 = time.perf_counter()
    cpu_row = aa.run_profile(build_index_from_arrays(seqs, device="cpu"), seqs, aa.MIXTURE,
                             dict(aa.PROFILES)["r9_old"], 8192, 1000, tmp / "abundance_cpu",
                             device="cpu")
    card_row = next(r for r in out["rows"] if r["profile"] == "r9_old")
    equal = all(card_row[k] == v for k, v in cpu_row.items())
    say("abundance", profile="r9_old", cpu_vs_card=equal, cpu_s=f"{time.perf_counter() - t0:.1f}")
    check(equal, f"abundance: r9_old on the CPU {cpu_row} differs from the card's {card_row}")


def sensitivity_phase(tmp: Path) -> None:
    """[sensitivity]: ``python -m monica_tpu_torch.sensitivity_r9 --device
    cuda`` at its default sizes (8 x 500 kb, 1,024 reads at 300, 1,000
    and 5,000 bp), every saturation and setting row beside
    ``SENSITIVITY_r05.json``'s (the JAX package's); the r9_old gate."""
    art = tmp / "sensitivity.json"
    _native.reset_launch_counts()
    rc, wall = run_cli(["--device", "cuda", "--out", str(art)], tmp / "sensitivity.log",
                       module="monica_tpu_torch.sensitivity_r9")
    launches = dict(_native.LAUNCHES)
    out, ref = json.loads(art.read_text()), artifact_rows("SENSITIVITY_r05.json")
    for part, key in (("saturation", ("profile", "read_len")),
                      ("rows", ("setting", "profile", "read_len"))):
        want = {tuple(r[k] for k in key): r for r in ref[part]}
        for r in out[part]:
            diff = artifact_diff(r, want[tuple(r[k] for k in key)])
            say("sensitivity", **flat(r), artifact_equal=not diff,
                artifact_diff=json.dumps(diff, separators=(",", ":")))
    say("sensitivity", r9_old_gate=out["gate"]["passed"], exit_code=rc, wall_s=f"{wall:.1f}",
        launches=json.dumps(launches, separators=(",", ":")))
    check(rc == 0 and out["gate"]["passed"], f"sensitivity: exit {rc}, gate {out['gate']}")


def ingest_phase(tmp: Path) -> None:
    """[ingest_rss]: ``python -m monica_tpu_torch.ingest_rss`` at its
    default 256 MB file and 32 MB chunks: the record counts equal (the
    module exits 1 otherwise) and the chunked parse's RSS above the
    baseline within 4 chunks."""
    art = tmp / "ingest_rss.json"
    rc, wall = run_cli(["--out", str(art)], tmp / "ingest_rss.log",
                       module="monica_tpu_torch.ingest_rss")
    check(rc == 0, f"ingest_rss exited {rc}")
    out = json.loads(art.read_text())
    say("ingest_rss", **flat({k: v for k, v in out.items() if k != "bound"}), wall_s=f"{wall:.1f}")
    check(out["chunked_delta_over_chunk"] <= 4,
          f"ingest_rss: chunked parse {out['chunked_delta_mb']} MB over the baseline")
    check(out["whole_delta_mb"] > out["chunked_delta_mb"] > 0,
          "ingest_rss: the whole-file parse must peak above the chunked one, both above the "
          "baseline")


def run_module(module: str, argv: list[str], smi: str, timeout: float,
               json_last: bool = True) -> tuple[list[str], str, float]:
    """``python -m <module> <argv>`` in a child process, as a user runs it,
    from the checkout's root: (its stdout lines, its stderr, wall s).  It
    must exit 0 and print the card's nvidia-smi line (``smi``) just
    before its JSON line (``json_last``), else as its last line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parent, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"{module} {argv} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) >= 2 and lines[-2 if json_last else -1] == smi,
          f"{module} {argv}: no card line ({smi!r}) before its last line")
    return lines, proc.stderr, wall


def echo(phase: str, lines) -> None:
    for line in lines:
        print(f"[{phase}] | {line}", flush=True)


def module_launches(lines: list[str]) -> dict:
    """The ``launches {...}`` line a module prints on the card."""
    return json.loads(next(ln for ln in lines if ln.startswith("launches {"))[len("launches "):])


def bench_phase(smi: str) -> None:
    """[bench]: ``python -m monica_tpu_torch.bench`` (the device pipeline
    over 16 resident batches, bench.py's window: no host pack, no upload),
    by default, with ``--gut`` and with ``--no-extend``: bench.py's JSON
    keys, the stderr line with syncs a batch and peak MiB, every read
    mapped as bench.py's workload maps them (>= 0.95)."""
    for flags in ([], ["--gut"], ["--no-extend"]):
        lines, err, wall = run_module("monica_tpu_torch.bench", flags, smi, 600)
        out = json.loads(lines[-1])
        check(list(out) == BENCH_KEYS and out["value"] > 0, f"bench {flags}: JSON line {out}")
        line = next(ln for ln in err.splitlines() if ln.startswith("[bench] index="))
        mapped = float(re.search(r"mapped_frac=([\d.]+)", line).group(1))
        syncs = re.search(r"host_syncs_per_batch=(\d+)", line)
        check(syncs is not None and re.search(r"peak_mib=\d+", line) is not None,
              f"bench {flags}: no syncs a batch or peak MiB on the card: {line}")
        check(mapped >= MIN_ACCURACY, f"bench {flags}: mapped_frac {mapped}")
        echo("bench", [line])
        say("bench", module="monica_tpu_torch.bench", flags=" ".join(flags) or "default",
            wall_s=f"{wall:.1f}", **flat(out))


def profile_stages_phase(smi: str) -> None:
    """[profile_stages]: ``python -m monica_tpu_torch.profile_stages``: the
    five cumulative variants' ms a batch (the JAX script's keys) and each
    variant's launches over one batch."""
    lines, _, wall = run_module("monica_tpu_torch.profile_stages", [], smi, 600)
    out = json.loads(lines[-1])
    check(list(out) == ["ms_per_batch_2048"] and list(out["ms_per_batch_2048"]) == PROFILE_VARIANTS,
          f"profile_stages: JSON line {out}")
    counted = {ln.split()[1]: dict(kv.split("=") for kv in ln.split()[2:] if "=" in kv)
               for ln in lines if ln.startswith("launches ")}
    check(list(counted) == PROFILE_VARIANTS
          and all(int(c.get("kernels", 0)) > 0 for c in counted.values()),
          f"profile_stages: launches {counted}")
    echo("profile_stages", lines[:-2])
    say("profile_stages", wall_s=f"{wall:.1f}", ms_per_batch_2048=json.dumps(
        out["ms_per_batch_2048"], separators=(",", ":")),
        launches=json.dumps(counted, separators=(",", ":")))


def bench_stream_phase(tmp: Path, smi: str) -> None:
    """[bench_stream]: ``python -m monica_tpu_torch.bench_stream`` with
    ``--reads 32768`` (of its default 100,000: the smoke's time limit; 8
    samples of the module's 4,096-read floor): the JAX script's payload
    keys, single-sample and pipelined reads/s, overlap_speedup."""
    lines, _, wall = run_module("monica_tpu_torch.bench_stream",
                                ["--work", str(tmp / "bench_stream"), "--reads",
                                 str(BENCH_STREAM_READS)], smi, 900)
    out = json.loads(lines[-1])
    check(list(out) == STREAM_KEYS, f"bench_stream: keys {list(out)}")
    n = out["n_mapped"] + out["n_unmapped"] + out["n_ambiguous"]
    check(out["n_mapped"] >= MIN_ACCURACY * n, f"bench_stream: {out['n_mapped']} of {n} mapped")
    ov = out["cross_sample_overlap"]
    say("bench_stream", wall_s=f"{wall:.1f}", reads_per_s=out["value"], stat=out["stat"],
        single_sample_reps=json.dumps(out["single_sample_reps"]), device=repr(out["device"]),
        mapped=f"{out['n_mapped']}/{n}", index_build_s=out["index_build_s"],
        stage_reads_per_s=json.dumps(out["stage_reads_per_s"], separators=(",", ":")),
        **{k: json.dumps(v) if isinstance(v, list) else v for k, v in ov.items()})


def first_reads_equal(name: str, q, refwin, lengths, p) -> None:
    """One SW call on the whole batch, its first FIRST_READS reads held
    bit-equal to banded_sw_torch on the card (the plain version of the
    whole batch would take tens of seconds)."""
    ks, km = ex.banded_sw(q, refwin, lengths, p, impl="cuda")
    n = FIRST_READS
    ps, pm = ex.banded_sw_torch(q[:n], refwin[:n], lengths[:n], p)
    check(torch.equal(ks[:n], ps) and torch.equal(km[:n], pm),
          f"{name} B={q.shape[0]} L={q.shape[1]}: the first {n} reads differ from the plain "
          "version")


def bench_sw_phase(dev, smi: str) -> None:
    """[bench_sw]: ``python -m monica_tpu_torch.bench_sw`` at 2048 x 1024,
    band 64 (Mcells/s, bench_sw.py's keys), its time beside the bound of
    these inputs; then the same inputs here, the first reads bit-equal."""
    lines, err, wall = run_module("monica_tpu_torch.bench_sw", [], smi, 300)
    out = json.loads(lines[-1])
    check(list(out) == BENCH_SW_KEYS and out["value"] > 0, f"bench_sw: JSON line {out}")
    B, L, W = 2048, 1024, 64
    p = ex.ExtendParams(band=W)
    q, refwin, lengths = bench_sw.inputs(B, L, W, dev)
    name = "banded_sw_packed_w64"
    first_reads_equal(name, q, refwin, lengths, p)
    ms = B * L * W / (out["value"] * 1e6) * 1e3
    bound_ms, bound_by = sw_bound(name, lengths.cpu().numpy(), L, p)
    echo("bench_sw", err.strip().splitlines())
    say("bench_sw", kernel=name, B=B, L=L, W=W, mcells_per_s=out["value"],
        vs_baseline=out["vs_baseline"], ms=f"{ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        bound_by=bound_by, share_of_bound=f"{bound_ms / ms:.4f}",
        launches=module_launches(lines)[name], first_reads_bit_equal=FIRST_READS,
        wall_s=f"{wall:.1f}")


def roofline_phase(dev, tmp: Path, smi: str) -> dict:
    """[roofline_sw]: ``python -m monica_tpu_torch.roofline_sw``: the
    measured int32 and DPX rates, SASS instructions a step, both bands at
    4096 x 1024 beside their bound; then here the ceiling kernel's scalar
    held to its plain version on the card (both chains, both unrolls) and
    the first reads of each band's call bit-equal.  Returns the ceiling
    kernel's entry of the kernels line."""
    art = tmp / "roofline.json"
    lines, _, wall = run_module("monica_tpu_torch.roofline_sw", ["--out", str(art)], smi, 300)
    out, payload = json.loads(lines[-1]), json.loads(art.read_text())
    check(list(out) == ROOFLINE_KEYS and out["measured_vpu_gops_per_s"] > 0
          and out["measured_dpx_gops_per_s"] > 0, f"roofline_sw: JSON line {out}")
    launches = module_launches(lines)
    echo("roofline_sw", [ln for ln in lines if ln.startswith("ceiling ")])
    for ch, m in payload["chains"].items():
        say("roofline_sw", chain=ch, sass_per_step=(payload["sass_per_step"] or {}).get(
            ch, {}).get("per_step", "not measured"), jax_ops_per_step=3 if ch == "int32" else 1,
            seconds=json.dumps(m["seconds"], separators=(",", ":")),
            ratio_1024_over_256=f"{m['ratio']:.4f}", linearity=f"{m['linearity']:.4f}",
            fixed_us=f"{m['fixed_s'] * 1e6:.2f}", steps_per_s=f"{m['steps_per_s']:.6g}")
    for r in payload["kernels"]:
        p = ex.ExtendParams(band=r["band"])
        q, refwin, lengths = roofline_sw.kernel_inputs(r["band"], r["batch"], r["read_len"], dev)
        first_reads_equal(r["kernel"], q, refwin, lengths, p)
        bound_ms, bound_by = sw_bound(r["kernel"], lengths.cpu().numpy(), r["read_len"], p)
        say("roofline_sw", **flat(r), ms_median=f"{r['seconds_median'] * 1e3:.4f}",
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
            share_of_bound=f"{bound_ms / (r['seconds_median'] * 1e3):.4f}",
            launches=launches[r["kernel"]], first_reads_bit_equal=FIRST_READS)
    say("roofline_sw", **flat(out),
        ceiling_instructions_per_s=f"{payload['ceiling_instructions_per_s']:.6g}",
        assumed_int32_ops_per_s=f"{INT32_OPS_PER_S:.6g}", wall_s=f"{wall:.1f}")

    x = torch.from_numpy(ceiling.chain_input()).to(dev).reshape(-1)
    err, plain_ms = 0, {}
    for ch in ceiling.CHAINS:
        for u in _native.ALU_UNROLLS:
            k = ceiling.low32(ceiling.alu_chain(x, u, ch).cpu())
            plain, plain_ms[ch, u] = synced_ms(lambda: ceiling.low32(
                ceiling.alu_chain_torch(x, u, ch).cpu()))
            check(k == plain, f"alu_ceiling {ch} unroll {u}: kernel {k:#x}, plain {plain:#x}")
            err = max(err, abs(k - plain))
    # the timed instance: the int32 chain at unroll 1024; its bound counts
    # each SASS instruction a step on its pipe (IMAD on the FMA pipe)
    ms = kernel_ms(lambda: ceiling.alu_chain(x, 1024, "int32"))
    n = x.numel()
    ops = (payload["sass_per_step"] or {}).get("int32", {}).get("opcodes_per_step")
    check(bool(ops), "roofline_sw: no SASS count of the int32 chain")
    t_ops = 1024 * n * max((sum(ops.values()) - ops.get("IMAD", 0)) / INT32_OPS_PER_S,
                           ops.get("IMAD", 0) / FMA_PER_S)
    t_bytes = (4 * n + 4) / HBM_BYTES_PER_S
    entry = dict(launches=launches[CEILING], max_abs_err=err, ms=ms,
                 plain_ms=plain_ms["int32", 1024], bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    say("roofline_sw", kernel=CEILING, chains=",".join(ceiling.CHAINS),
        unrolls=",".join(map(str, _native.ALU_UNROLLS)), lanes=n, scalar_equals_plain=True,
        kernel_ms_int32_1024=f"{ms:.4f}",
        plain_ms=json.dumps({f"{c}_{u}": round(v, 1) for (c, u), v in plain_ms.items()}),
        sass_opcodes_per_step=json.dumps(ops, separators=(",", ":")),
        bound_ms=f"{entry['bound_ms']:.5f}", bound_by=entry["bound_by"],
        share_of_bound=f"{entry['bound_ms'] / ms:.4f}", launches=entry["launches"])
    check(entry["launches"] > 0, "roofline_sw: the ceiling kernel never launched")
    return entry


def exp_knobs_phase(smi: str) -> None:
    """[exp_knobs]: ``python -m monica_tpu_torch.exp_knobs``: the JAX
    script's 12 grid lines (S x extend at frac 1.0 and 0.5)."""
    lines, _, wall = run_module("monica_tpu_torch.exp_knobs", [], smi, 600, json_last=False)
    grid = [ln for ln in lines if re.match(r"S=\d+ frac=", ln)]
    check(len(grid) == 12 and sum(ln.startswith("--- frac=") for ln in lines) == 2,
          f"exp_knobs: {len(grid)} grid lines")
    echo("exp_knobs", lines[:-1])
    say("exp_knobs", lines=len(grid), wall_s=f"{wall:.1f}")


def scaling_curve_phase(tmp: Path, smi: str) -> Path:
    """[scaling_curve]: ``python -m monica_tpu_torch.scaling_curve``: the
    mesh rows (meshes of repeats of the card), the JAX script's payload
    keys and its derived block.  Returns the payload's path."""
    art = tmp / "SCALING_torch.json"
    lines, _, wall = run_module("monica_tpu_torch.scaling_curve", ["--out", str(art)], smi, 300)
    out, payload = json.loads(lines[-1]), json.loads(art.read_text())
    check(list(payload) == SCALING_KEYS and list(out) == SCALING_DERIVED
          and out == payload["derived"], f"scaling_curve: keys {list(payload)}, {out}")
    echo("scaling_curve", lines[:-2])
    say("scaling_curve", wall_s=f"{wall:.1f}", **flat(out),
        meshless_single_dispatch_s=payload["meshless_single_dispatch_s"],
        lockstep_schedule_s_per_sample=payload["lockstep_schedule_s_per_sample"])
    return art


def podscale_payload(args: list[str], smi: str, timeout: float) -> tuple[dict, float]:
    lines, _, wall = run_module("monica_tpu_torch.podscale_model", args, smi, timeout)
    out = json.loads(lines[-1])
    check(list(out)[: len(PODSCALE_KEYS)] == PODSCALE_KEYS and "per_card_share" in out,
          f"podscale_model {args}: keys {list(out)}")
    check(out["verdict"] == "PASS", f"podscale_model {args}: verdict {out['verdict']}")
    return out, wall


def podscale_phase(scaling: Path, smi: str) -> None:
    """[podscale]: ``python -m monica_tpu_torch.podscale_model --no-share``:
    the structural run at the JAX script's size (24 genomes × 60 kb, 24
    shards; a (4, 2) mesh of the card equal to the card alone) and the
    capacity rows from the card's memory, one shard's device bytes and
    R1 (the share's reads against its first shard), with the measured
    mesh overheads folded in."""
    out, wall = podscale_payload(["--no-share", "--scaling", str(scaling)], smi, 300)
    st, model = out["structural_validation"], out["capacity_model"]
    check(st["mesh_equals_single_device"] and st["n_shards"] == 24,
          f"podscale: structural {st}")
    say("podscale", **flat(st))
    cap = out["per_card_share"]["capacity_inputs"]
    check(cap["hbm_bytes"] == torch.cuda.get_device_properties(0).total_memory,
          f"podscale: the model's memory {cap['hbm_bytes']} is not the card's")
    say("podscale", **flat(cap))
    for row in model["scaling_rows"]:
        say("podscale", **flat({k: v for k, v in row.items() if k != "note"}))
    say("podscale", **flat({k: v for k, v in model["measured_overheads"].items() if k != "note"}),
        wall_s=f"{wall:.1f}")


def podscale_share_phase(scaling: Path, smi: str) -> None:
    """[podscale_share]: ``python -m monica_tpu_torch.podscale_model``:
    config 5's per-card share on the card (the shards the capacity model
    puts on one card, or a cut listed under ``reduced``): reads/s through
    the Classifier beside R1, ``work_conserving_ratio``, accuracy >= 0.95,
    ``banded_sw_packed_w64`` launched, syncs and launches a batch, device
    and host memory, and the (4, 2) mesh equal to the card alone at the
    share's size."""
    out, wall = podscale_payload(["--scaling", str(scaling)], smi, 600)
    share = out["per_card_share"]
    check(share["full"] and (share["shards"] == share["shards_model"] or share["reduced"]),
          f"podscale_share: {share['shards']} shards of the model's {share['shards_model']}, "
          f"nothing listed under reduced")
    check(share["structural"]["mesh_equals_single_device"]
          and share["structural"]["n_shards"] == share["shards"],
          f"podscale_share: structural {share['structural']}")
    check(share["accuracy"] >= MIN_ACCURACY, f"podscale_share: accuracy {share['accuracy']}")
    check(share["sw_launches"] >= 1, "podscale_share: banded_sw_packed_w64 never launched")
    say("podscale_share", **flat({k: share[k] for k in (
        "shards", "shards_model", "genomes", "genomes_per_shard", "gbase", "reduced",
        "reads_per_s", "r1_reads_per_s", "work_conserving_ratio", "accuracy",
        "host_syncs_per_batch", "launches_per_batch", "sw_launches", "stacked_mib",
        "stacked_bytes_per_base", "peak_device_mib", "host_rss_peak_mb",
        "mem_available_mb_before", "pass_s", "r1_pass_s")}))
    say("podscale_share", **flat({k: share[k] for k in ("sync_sites", "structural", "seconds")}),
        wall_s=f"{wall:.1f}")
    for row in out["capacity_model"]["scaling_rows"]:
        say("podscale_share", **flat({k: v for k, v in row.items() if k != "note"}))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card")
    if sys.argv[1:2] == ["--multiproc-worker"]:
        return multiproc_worker(*sys.argv[2:])
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        host_cpu=repr(host_cpu()), host_cores=os.cpu_count(),
        torch_threads=torch.get_num_threads())

    build_all()
    timings = compare_kernels(dev)
    launches, zymo, zymo_built, zymo_build_s = single_shard(dev)
    build_agree(dev, zymo, zymo_built, zymo_build_s)
    del zymo_built
    torch.cuda.empty_cache()
    merge_agree(dev)

    seqs, built, clf = gut_index(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        first = stream(dev, seqs, built, clf, Path(tmp))
        stream_agree(dev, seqs, built, clf, Path(tmp), first)
        stream_profile(dev, built, clf, Path(tmp), first)
        for shape in (MESH_EQUAL, MESH_SPLIT):
            mesh_run(dev, seqs, built, clf, Path(tmp), first, shape)
        mesh_agree(dev, seqs, built)
        multiproc(dev, built, clf, Path(tmp), first)
    del seqs, built, clf, first
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        run = cli(dev, zymo, Path(tmp))
        cli_agree(dev, Path(tmp), run)
        concordance_phase(Path(tmp))
        for name, phase in (("watch", lambda: watch_phase(dev, Path(tmp), smi)),
                            ("cli_watch", lambda: cli_watch(Path(tmp), run)),
                            ("abundance", lambda: abundance_phase(Path(tmp))),
                            ("sensitivity", lambda: sensitivity_phase(Path(tmp))),
                            ("ingest_rss", lambda: ingest_phase(Path(tmp)))):
            t0 = time.perf_counter()
            phase()
            say("phase_wall", name=name, seconds=f"{time.perf_counter() - t0:.1f}")

    # the measurement modules, each run as a user runs it (a child process)
    torch.cuda.empty_cache()
    measured = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_measure_") as tmp:
        for name, phase in (("bench", lambda: bench_phase(smi)),
                            ("profile_stages", lambda: profile_stages_phase(smi)),
                            ("bench_stream", lambda: bench_stream_phase(Path(tmp), smi)),
                            ("bench_sw", lambda: bench_sw_phase(dev, smi)),
                            ("roofline_sw", lambda: measured.update(
                                ceiling=roofline_phase(dev, Path(tmp), smi))),
                            ("exp_knobs", lambda: exp_knobs_phase(smi)),
                            ("scaling_curve", lambda: measured.update(
                                scaling=scaling_curve_phase(Path(tmp), smi))),
                            ("podscale", lambda: podscale_phase(measured["scaling"], smi)),
                            ("podscale_share", lambda: podscale_share_phase(
                                measured["scaling"], smi))):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            phase()
            say("phase_wall", name=name, seconds=f"{time.perf_counter() - t0:.1f}")

    table = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": timings[name]["max_abs_err"],
         "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"],
         "bound_ms": timings[name]["bound_ms"], "bound_by": timings[name]["bound_by"],
         "library_ms": None}
        for name, replaces in KERNELS.items()
    ]
    table.append({"name": CEILING, "route": "cuda", "source": CEILING_SOURCE,
                  "replaces": CEILING_REPLACES, **measured["ceiling"], "library_ms": None})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

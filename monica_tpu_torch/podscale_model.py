"""BASELINE config 5 (pod-scale full-RefSeq quantification) on one card —
the port's counterpart of ``scripts/podscale_model.py``.

Config 5 is ~20k genomes (~60 Gbase) sharded over a pod.  One card
cannot hold the pod, but it holds what one card of the pod would: one
index rank's share of the pod index.  Three parts:

* :func:`structural_run` — the JAX script's check (seed 5; 128 reads of
  600 bp; ``ClassifyParams(n_slots=64)``, count mode ``basic``): a
  many-shard index through ``run_once`` on the single device and on a
  (data=4, index=2) mesh of repeats of it, the mapped count and the
  abundance table equal.  24 genomes × 60 kb in 24 shards, as the JAX
  script.
* :func:`capacity_model` — the JAX script's pod arithmetic (the smallest
  index axis whose per-card shard group fits in half a card's memory,
  the work-conserving rate ``R1 × chips / shards``) with its inputs as
  arguments: here the card's memory (``total_memory``), one shard's
  device bytes (``pipeline.stacked_nbytes``) and the per-shard rate R1,
  each measured in the same run.  The key ``fits_16gb_hbm`` keeps its
  name (the JAX payload's) and compares with 80% of the given memory.
* :func:`share_run` — config 5's per-card share on the card: random
  genomes of the model's 3 Mb mean (drawn on the device from seed 8, a
  shard's genomes at a time) in as many 2^26-base shards
  as the model puts on one card (``S_local``), built on the card; 8
  batches of 2048 × 1,000 bp reads at the r9_hac profile (5/3/3%, random
  strand), so reads reach the B/8 rescue tier; reads/s through
  ``Classifier.classify`` + ``fetch`` (median of 3 reps), accuracy, host
  syncs and launches a batch; R1, the same reads against a one-shard
  index of the share's first shard; ``work_conserving_ratio`` = R_S × S
  / R1 (the model assumes 1.0); build, upload, memory; and the
  structural check at the share's size (the single-device stack dropped
  before the mesh's is built: two would crowd the card).  Where host
  memory forces a smaller S (or ``--quick`` cuts it), the cut is listed
  under ``reduced``; the shard size, genome length and read shape never
  change.

``--no-share`` stops the share after R1 (no full build): the capacity
rows from the first shard's bytes.  ``--scaling`` folds
``scaling_curve``'s measured overheads into the model, as the JAX
script.  Prints progress lines, the card's name and power limit, then
the payload as ONE JSON line; exits 1 unless every structural equality
holds and the share maps >= 0.95 of its reads with at least one
``banded_sw_packed_w64`` launch (counted on a card only).  ``--quick``
(CPU tests): 8 × 20 kb in 8 shards; a share of 3 shards of 5 × 50 kb
genomes at a 2^18-base shard cap, 2 batches of 64 reads.

    python -m monica_tpu_torch.podscale_model [--out PODSCALE_torch.json]
        [--scaling SCALING_torch.json] [--no-share] [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from monica_tpu_torch import bench
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch import profile_stages
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index import build as ib
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.ops import _native
from monica_tpu_torch.parallel import mesh as pm
from monica_tpu_torch.stats.abundance import AbundanceState

STRUCT_SEED = 5
SHARE_SEED = 8
PARAMS = pl.ClassifyParams(n_slots=64)
MESH = (4, 2)
GBASE = 60e9  # ~20k genomes x ~3 Mb mean  [assumption]
MEAN_GENOME = 3_000_000  # [assumption]
SHARD_BASES = 1 << 26  # hard cap (ops/lookup tag bits)  [layout]
CHIPS = (64, 128, 256)
INDEX_AXES = (1, 2, 4, 8, 16, 32, 64)
R9_HAC = (0.05, 0.03, 0.03)
MIN_ACCURACY = 0.95
SW_KERNEL = "banded_sw_packed_w64"
STRUCT = (24, 60_000, 24)
SHARE = dict(genome_len=MEAN_GENOME, max_shard_bytes=SHARD_BASES, batch=2048, n_batches=8,
             read_len=1000, reps=3, gbase=GBASE, shard_bases=SHARD_BASES)
QUICK_STRUCT = (8, 20_000, 8)
QUICK_SHARE = dict(genome_len=50_000, max_shard_bytes=1 << 18, batch=64, n_batches=2,
                   read_len=1000, reps=1, gbase=GBASE * 2**18 / 2**26, shard_bases=1 << 18,
                   hbm_bytes=int(1e9), max_shards=3)


# ---------------------------------------------------------------------------
# structural validation
# ---------------------------------------------------------------------------

def structural_reads(seqs, rng: np.random.Generator, n: int = 128):
    """The JAX script's draw: n exact 600 bp substrings of random genomes."""
    out = np.zeros((n, 600), np.uint8)
    lens = np.full(n, 600, np.int32)
    for i in range(n):
        g = seqs[rng.integers(0, len(seqs))]
        s = rng.integers(0, len(g) - 600)
        out[i] = g[s : s + 600]
    return out, lens


def structural_sample(clf: rt.Classifier, codes: np.ndarray) -> tuple[int, np.ndarray]:
    """One FASTQ sample of ``codes`` through ``run_once``: (reads mapped,
    the sample's abundance row as ``AbundanceState.load`` reads it)."""
    with tempfile.TemporaryDirectory() as td:
        q, out = os.path.join(td, "q"), os.path.join(td, "o")
        os.makedirs(q)
        with open(os.path.join(q, "s.fastq"), "w") as fh:
            for i, row in enumerate(codes):
                s = enc.decode_seq(row)
                fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
        reps = rt.run_once(clf, q, out)
        st = AbundanceState.load(out, clf.meta.n_accessions)
        return reps[0].n_mapped, st.samples["s"].copy()


def mesh_of(device) -> pm.Mesh:
    """The (data=4, index=2) mesh, every cell ``device``."""
    return pm.make_mesh(*MESH, devices=[device] * (MESH[0] * MESH[1]))


def structural_summary(n_genomes: int, n_shards: int, results: dict) -> dict:
    """The JAX payload's ``structural_validation`` from the single and
    mesh runs' (mapped, abundance row)."""
    ok = (results["single"][0] == results["mesh"][0]
          and np.array_equal(results["single"][1], results["mesh"][1])
          and results["single"][0] > 100)
    return {
        "n_genomes": n_genomes,
        "n_shards": n_shards,
        "mesh": "(data=4, index=2) -> S_local = %d shards per device" % (n_shards // 2),
        "mapped": int(results["single"][0]),
        "mesh_equals_single_device": bool(ok),
    }


def structural_results(n_genomes: int, glen: int, n_shards: int, *, device):
    """The JAX ``structural_run``'s world through the single device and
    the mesh: (n_genomes, shards built, {"single"|"mesh": (mapped, row)})."""
    rng = np.random.default_rng(STRUCT_SEED)
    seqs = [rng.integers(0, 4, glen).astype(np.uint8) for _ in range(n_genomes)]
    built = build_index_from_arrays(seqs, n_shards=n_shards, device=device)
    codes, _ = structural_reads(seqs, rng)
    results = {
        name: structural_sample(rt.Classifier(built, PARAMS, count_mode="basic", **where), codes)
        for name, where in (("single", dict(device=device)), ("mesh", dict(mesh=mesh_of(device))))
    }
    return n_genomes, len(built.shards), results


def structural_run(n_genomes: int, glen: int, n_shards: int, *, device) -> dict:
    """Many-shard index through the product path on a (data=4, index=2)
    mesh of ``device`` against the single device."""
    return structural_summary(*structural_results(n_genomes, glen, n_shards, device=device))


# ---------------------------------------------------------------------------
# capacity model
# ---------------------------------------------------------------------------

def pod_shards(gbase: float = GBASE, shard_bases: int = SHARD_BASES) -> int:
    return int(np.ceil(gbase / shard_bases))


def index_axis(n_shards: int, shard_bytes: float, hbm_bytes: float, n_chips: int) -> int:
    """The smallest index axis whose per-card shard group fits in half of
    ``hbm_bytes``."""
    for i in INDEX_AXES:
        if i <= n_chips and np.ceil(n_shards / i) * shard_bytes < hbm_bytes * 0.5:
            return i
    raise ValueError(f"{n_shards} shards of {shard_bytes:.4g} B fit no index axis of "
                     f"{n_chips} cards of {hbm_bytes:.4g} B")


def shards_per_card(hbm_bytes: float, shard_bytes: float, gbase: float = GBASE,
                    shard_bases: int = SHARD_BASES, chips=CHIPS) -> int:
    """The most shards the model puts on one card over its pod sizes."""
    n = pod_shards(gbase, shard_bases)
    return max(int(np.ceil(n / index_axis(n, shard_bytes, hbm_bytes, c))) for c in chips)


def capacity_model(hbm_bytes: float, shard_bytes: float, reads_per_s_1shard: float, *,
                   gbase: float = GBASE, shard_bases: int = SHARD_BASES, chips=CHIPS,
                   inputs: dict | None = None) -> dict:
    """The pod model of ``scripts/podscale_model.py:capacity_model`` with
    its inputs as arguments: every read scores every shard, so the pod's
    rate is work-conserving, R1 × chips / shards, for any (data, index)
    split; the split only moves memory, the index axis chosen to keep a
    card's shard group under half its memory.  ``inputs`` labels each
    input measured / layout / assumption."""
    n_shards = pod_shards(gbase, shard_bases)
    rows = []
    for n_chips in chips:
        n_index = index_axis(n_shards, shard_bytes, hbm_bytes, n_chips)
        s_local = int(np.ceil(n_shards / n_index))
        hbm = s_local * shard_bytes
        reads_per_s = reads_per_s_1shard * n_chips / n_shards
        rows.append({
            "chips": n_chips,
            "mesh": f"(data={n_chips // n_index}, index={n_index})",
            "index_shards": n_shards,
            "shards_per_chip": s_local,
            "hbm_per_chip_gb": round(hbm / 1e9, 2),
            "fits_16gb_hbm": bool(hbm < hbm_bytes * 0.8),
            "modeled_reads_per_s": int(reads_per_s),
            "note": "work-conserving bound: each batch gathers every index rank's ShardHit "
                    "rows (10 fields x 4 B x batch) to its data row; the counts are one "
                    "(n_acc,) vector per batch; fits_16gb_hbm compares with 80% of the "
                    "card's memory",
        })
    return {
        "inputs": inputs or {},
        "per_batch_dcn_traffic": "zero on the feed path (each host feeds its own rows); "
            "a torch.distributed gather of per-rank hits and one summed count vector a "
            "batch; host fetch = one packed int32 transfer a sample",
        "scaling_rows": rows,
        "caveat": "MODEL, not a measurement of a pod: one card holds one index rank's "
            "share (per_card_share).  The mesh machinery it assumes is checked at shape by "
            "structural_run and the two-process tests (tests/test_torch_multihost.py).",
    }


def model_inputs(hbm_bytes: float, shard_bytes: float, r1: float, gbase: float,
                 shard_bases: int, card: str, share_bases: int) -> dict:
    """The labels of the port's measured inputs (the JAX payload's keys,
    plus the card's memory, which the JAX script kept as a constant)."""
    return {
        "genomes": f"~20k RefSeq bacteria+archaea+fungi, ~{gbase / 1e9:g} Gbase [assumption]",
        "bytes_per_base": f"{shard_bytes / share_bases:.4f} B/base: one shard's device bytes "
                          f"(pipeline.stacked_nbytes) over its {share_bases} bases [measured]",
        "table_overhead": "in the measured shard bytes: 2^rbits hash rows x 8 slots x 4 B, "
                          "int32 pos_acc (4 B/base), codes (1 B/base) [layout]",
        "per_shard_throughput": f"{r1:.1f} reads/s through Classifier.classify + fetch against "
                                f"one {share_bases}-base shard on {card} [measured]",
        "hbm_per_chip": f"{hbm_bytes} B, the device's total memory ({card}) [spec]",
        "shard_bases": f"{shard_bases} [layout]",
    }


def fold_scaling(model: dict, sc: dict, source: str) -> None:
    """The JAX script's ``--scaling`` fold: ``sharding_overhead_8x`` as a
    throughput derate on the work-conserving bound (none below 1.0), and
    the measured overheads beside the rows."""
    d = sc["derived"]
    derate = max(float(d["sharding_overhead_8x"]), 1.0)
    for row in model["scaling_rows"]:
        row["modeled_reads_per_s_with_measured_overhead"] = int(
            row["modeled_reads_per_s"] / derate)
    model["measured_overheads"] = {
        "source": source,
        "mesh_entry_overhead": d["mesh_entry_overhead"],
        "sharding_overhead_8x_data": d["sharding_overhead_8x"],
        "index4_vs_index1_dispatch": d["index4_vs_index1"],
        "lockstep_schedule_s_per_sample": sc["lockstep_schedule_s_per_sample"],
        "applied_derate": derate,
        "note": sc["reading_guide"],
    }


# ---------------------------------------------------------------------------
# the per-card share
# ---------------------------------------------------------------------------

def _status_kb(key: str, path: str = "/proc/self/status") -> int | None:
    try:
        with open(path) as fh:
            for line in fh:
                if line.startswith(key + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class RssPeak:
    """Peak resident memory of this process: ``VmHWM`` where the kernel
    keeps it, else the largest ``VmRSS`` a thread samples every 10 ms."""

    def __init__(self):
        self.peak_kb = _status_kb("VmRSS") or 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self):
        while not self._done.wait(0.01):
            self.peak_kb = max(self.peak_kb, _status_kb("VmRSS") or 0)

    def stop(self) -> float:
        """MiB."""
        self._done.set()
        self._thread.join()
        hwm = _status_kb("VmHWM")
        return (hwm if hwm is not None else max(self.peak_kb, _status_kb("VmRSS") or 0)) / 1024


def draw_genomes(gen: torch.Generator, n: int, genome_len: int) -> list[np.ndarray]:
    """n random genomes (uint8 codes 0-3) drawn on ``gen``'s device, one
    block a call, and copied to the host."""
    block = torch.randint(0, 4, (n, genome_len), generator=gen, device=gen.device,
                          dtype=torch.uint8)
    return list(block.cpu().numpy())


def genomes_per_shard(genome_len: int, max_shard_bytes: int, n_genomes: int) -> int:
    """Genomes of ``genome_len`` in the first shard the build packs out
    of ``n_genomes`` of them (the guard slack grows with the count)."""
    return len(ib._assign_units([genome_len] * n_genomes, None, max_shard_bytes)[0])


def classify_rate(clf: rt.Classifier, batches, reps: int):
    """reads/s of ``classify`` + ``fetch`` a batch over ``batches``: one
    warm batch, then the median of ``reps`` passes.  Returns (reads/s,
    seconds a pass, the last pass's (status, acc_id) a batch)."""
    clf.fetch(*clf.classify(*batches[0][:2]))
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [clf.fetch(*clf.classify(c, l))[:2] for c, l, _ in batches]
        dts.append(time.perf_counter() - t0)
    n = sum(len(b[1]) for b in batches)
    return n / float(np.median(dts)), dts, outs


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def share_run(device, *, genome_len: int, max_shard_bytes: int, batch: int, n_batches: int,
              read_len: int, reps: int, gbase: float, shard_bases: int, hbm_bytes: float,
              max_shards: int | None = None, cut_why: str = "max_shards", full: bool = True,
              seed: int = SHARE_SEED) -> dict:
    """Config 5's per-card share on ``device`` (see the module docstring).
    Returns the ``per_card_share`` block; ``capacity_inputs`` holds what
    :func:`capacity_model` takes."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_all = time.perf_counter()
    secs: dict[str, float] = {}
    mem_available_mb = (_status_kb("MemAvailable", "/proc/meminfo") or 0) / 1024
    rss = RssPeak()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    # the share's first shard, alone: its device bytes fix S, and it is R1's index
    t0 = time.perf_counter()
    g = genomes_per_shard(genome_len, max_shard_bytes, max_shard_bytes // genome_len + 1)
    seqs = draw_genomes(gen, g, genome_len)
    built1 = build_index_from_arrays(seqs, max_shard_bytes=max_shard_bytes, device=dev)
    clf1 = rt.Classifier(built1, PARAMS, count_mode="basic", device=dev)
    shard_bytes_1 = pl.stacked_nbytes(clf1.index)
    sh = built1.shards[0]
    host_shard_bytes = sh.ref_codes.nbytes + sh.pos_accession_id.nbytes + 9 * sh.n_minimizers
    bench.sync(dev)
    secs["first_shard"] = time.perf_counter() - t0

    s_model = shards_per_card(hbm_bytes, shard_bytes_1, gbase, shard_bases)
    S, reduced = s_model, []
    if max_shards is not None and max_shards < S:
        reduced.append(dict(what="shards", model=S, run=max_shards, why=cut_why))
        S = max_shards
    # host memory of the build: the genomes plus every shard's host arrays
    # (8 shards built at once), with a 25% margin
    need_mb = (S * g * genome_len + (S + 8) * host_shard_bytes) * 1.25 / 2**20
    if full and mem_available_mb and need_mb > mem_available_mb:
        fit = max(int(mem_available_mb / need_mb * S), 1)
        reduced.append(dict(what="shards", model=S, run=fit,
                            why=f"host MemAvailable {mem_available_mb:.0f} MiB < "
                                f"{need_mb:.0f} MiB the build needs"))
        S = fit
    n = S * g
    if genomes_per_shard(genome_len, max_shard_bytes, n) != g:
        raise RuntimeError(f"{n} genomes pack {genomes_per_shard(genome_len, max_shard_bytes, n)}"
                           f" a shard, not {g}")

    t0 = time.perf_counter()
    for _ in range(S - 1):  # a shard's genomes a block
        seqs += draw_genomes(gen, g, genome_len)
    secs["genomes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = np.random.default_rng(seed + 1)
    bucket = enc.bucket_for_length(read_len)
    batches = [ev.sim_batch(seqs, rr, batch, read_len, read_len, R9_HAC, bucket)
               for _ in range(n_batches)]
    secs["reads"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    r1, r1_dts, _ = classify_rate(clf1, batches, reps)
    secs["r1"] = time.perf_counter() - t0
    del clf1, built1, sh
    _free(dev)

    out = {
        "source": "BASELINE.json configs[4]; scripts/podscale_model.py's pod model",
        "genome_len": genome_len,
        "genomes_per_shard": g,
        "shards_model": s_model,
        "shards": S,
        "genomes": n,
        "gbase": n * genome_len / 1e9,
        "reduced": reduced,
        "reads": dict(batches=n_batches, batch=batch, read_len=read_len, bucket=bucket,
                      profile="r9_hac", error=list(R9_HAC), strand="random"),
        "r1_reads_per_s": r1,
        "r1_pass_s": r1_dts,
        "mem_available_mb_before": mem_available_mb,
        "full": full,
    }
    cap = dict(hbm_bytes=hbm_bytes, shard_bytes=shard_bytes_1, reads_per_s_1shard=r1,
               shard_bytes_from="one-shard index of the share's first shard")
    if not full:
        out.update(capacity_inputs=cap, seconds=secs, host_rss_peak_mb=rss.stop())
        out["seconds"]["total"] = time.perf_counter() - t_all
        return out

    t0 = time.perf_counter()
    built = build_index_from_arrays(seqs, max_shard_bytes=max_shard_bytes, device=dev)
    bench.sync(dev)
    secs["build"] = time.perf_counter() - t0
    if len(built.shards) != S:
        raise RuntimeError(f"the share built {len(built.shards)} shards, not {S}")
    t0 = time.perf_counter()
    clf = rt.Classifier(built, PARAMS, count_mode="basic", device=dev)
    bench.sync(dev)
    secs["upload"] = time.perf_counter() - t0
    stacked = pl.stacked_nbytes(clf.index)

    t0 = time.perf_counter()
    sw_before = _native.LAUNCHES[SW_KERNEL]
    rate, dts, outs = classify_rate(clf, batches, reps)
    sw = _native.LAUNCHES[SW_KERNEL] - sw_before
    secs["classify"] = time.perf_counter() - t0
    ok = sum(int(((st == pl.MAPPED) & (acc == labels)).sum())
             for (st, acc), (_, _, labels) in zip(outs, batches))
    codes0, lens0, _ = batches[0]
    syncs = bench.host_syncs(lambda: clf.classify(codes0, lens0), dev)
    launches = profile_stages.count_launches(lambda: clf.classify(codes0, lens0), dev)

    # the structural check at the share's size: the single-device stack is
    # dropped before the mesh's is built
    t0 = time.perf_counter()
    codes, _ = structural_reads(seqs, np.random.default_rng(STRUCT_SEED))
    results = {"single": structural_sample(clf, codes)}
    del clf
    _free(dev)
    t1 = time.perf_counter()
    mclf = rt.Classifier(built, PARAMS, count_mode="basic", mesh=mesh_of(dev))
    bench.sync(dev)
    secs["mesh_upload"] = time.perf_counter() - t1
    results["mesh"] = structural_sample(mclf, codes)
    del mclf
    _free(dev)
    secs["structural"] = time.perf_counter() - t0
    secs["total"] = time.perf_counter() - t_all

    cap.update(shard_bytes=stacked / S, shard_bytes_from="pipeline.stacked_nbytes of the "
               "share's stacked groups over its shards")
    out.update(
        reads_per_s=rate,
        pass_s=dts,
        accuracy=ok / (batch * n_batches),
        work_conserving_ratio=rate * S / r1,
        host_syncs_per_batch=None if syncs is None else len(syncs),
        sync_sites=None if syncs is None else sorted(set(syncs)),
        launches_per_batch=launches,
        sw_launches=sw if on_card else None,
        stacked_mib=stacked / 2**20,
        stacked_bytes_per_base=stacked / (n * genome_len),
        peak_device_mib=torch.cuda.max_memory_allocated(dev) / 2**20 if on_card else None,
        host_rss_peak_mb=rss.stop(),
        structural=structural_summary(n, S, results),
        capacity_inputs=cap,
        seconds=secs,
    )
    return out


def share_gates(share: dict) -> dict:
    """The share's gates: structural equality, accuracy, and the SW
    kernel launched (counted on a card only)."""
    if not share["full"]:
        return {}
    return {
        "mesh_equals_single_device": share["structural"]["mesh_equals_single_device"],
        "accuracy": share["accuracy"] >= MIN_ACCURACY,
        "sw_launched": share["sw_launches"] is None or share["sw_launches"] >= 1,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.podscale_model",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--scaling", help="SCALING_torch.json from monica_tpu_torch.scaling_curve: "
                    "folds the measured mesh overheads into the model")
    ap.add_argument("--no-share", dest="share", action="store_false",
                    help="stop the per-card share after R1 (no full build)")
    ap.add_argument("--device", default="cuda", help="torch device of every build and classify")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    t0 = time.time()
    sizes = dict(QUICK_SHARE if args.quick else SHARE)
    hbm = sizes.pop("hbm_bytes", None)
    max_shards = sizes.pop("max_shards", None)
    if hbm is None:
        if dev.type != "cuda":
            raise SystemExit("podscale_model: off a card only --quick names a device memory")
        hbm = torch.cuda.get_device_properties(dev).total_memory
    gpu = bench.card(dev)

    structural = structural_run(*(QUICK_STRUCT if args.quick else STRUCT), device=dev)
    print(json.dumps({"structural_validation": structural}), flush=True)
    share = share_run(dev, **sizes, hbm_bytes=hbm, max_shards=max_shards,
                      cut_why="--quick: CPU test size", full=args.share)
    cap = share["capacity_inputs"]
    model = capacity_model(
        cap["hbm_bytes"], cap["shard_bytes"], cap["reads_per_s_1shard"],
        gbase=sizes["gbase"], shard_bases=sizes["shard_bases"],
        inputs=model_inputs(cap["hbm_bytes"], cap["shard_bytes"], cap["reads_per_s_1shard"],
                            sizes["gbase"], sizes["shard_bases"], gpu,
                            share["genomes_per_shard"] * sizes["genome_len"]))
    if args.scaling:
        with open(args.scaling) as fh:
            fold_scaling(model, json.load(fh), args.scaling)
    share["gates"] = share_gates(share)
    passed = structural["mesh_equals_single_device"] and all(share["gates"].values())
    payload = {
        "config": "BASELINE config 5: pod-scale full-RefSeq quantification",
        "structural_validation": structural,
        "capacity_model": model,
        "seconds": round(time.time() - t0, 1),
        "verdict": "PASS" if passed else "FAIL",
        "per_card_share": share,
    }
    print(gpu, flush=True)
    print(json.dumps(payload), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())

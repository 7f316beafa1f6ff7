"""Banded-SW kernel roofline on one card — the port's counterpart of
``scripts/roofline_sw.py``.

The ceiling is measured, not taken from a data sheet: the hand-written
kernel ``ops/csrc/alu_ceiling.cu`` (:mod:`monica_tpu_torch.ops.ceiling`)
runs the JAX script's int32 chain ``y = (y + x) ^ (y >> 1) ^ (2i + 1)``
over 2048 × 1024 int32 lanes (seed 0), reduced to one scalar, at unroll
256 and 1024; the difference of the two times (the median of 5 calls
each, CUDA events) cancels the launch, the load and the reduction, so
the slope is the ALU's rate (unroll 512 checks that the time is linear
in the unroll, ``linearity`` 1.0): ``measured_vpu_gops_per_s`` counts 3 ops a
step, as the JAX script does.  The same difference over a chain of
``__viaddmax_s32`` (one DPX instruction a step) gives
``measured_dpx_gops_per_s``.  On the card, ``cuobjdump`` counts the SASS
instructions a step of each chain (the compiler may fold the two xors
into one LOP3), and the int32 instruction rate (SASS a step × steps/s)
is the ceiling the SW kernels are held to.

The per-cell counts are the port's kernels' own, with Hopper's fused
DPX forms (``chip_smoke.py``'s ``sw_bound``): packed 7 + k, pair state
18 + k instructions a cell, k = ceil(log3 window) three-way maxes for a
window of the next power of two >= the gap reach.  ``speed_of_light``
is the ceiling over them, in Gcells/s.

The kernels are timed as the JAX script times them: ``banded_sw`` at
band 64 and 128, B = 4096, L = 1024, uniform random reads and reference
windows from seed 1 (:func:`kernel_inputs`), 1 warm-up and 5 calls each
timed with CUDA events.  Both bands take ``banded_sw_packed<W>`` at 1 kb.

Prints a JSON line per kernel, a line per ceiling chain, the card's name
and power limit, then ONE JSON line with the JAX script's keys plus
``measured_dpx_gops_per_s``; the whole payload goes to ``--out``.
``--quick`` (CPU tests, the plain versions): 64 × 64 lanes at unroll 8,
16 and 32, B = 8, L = 128.

    python -m monica_tpu_torch.roofline_sw [--out ROOFLINE_torch.json] [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from monica_tpu_torch import bench
from monica_tpu_torch.ops import _native, ceiling
from monica_tpu_torch.ops import extend as ex

OPS_PER_STEP = 3  # the JAX script's count of the int32 chain's step
REPS = 5
FULL = dict(size=ceiling.SIZE, unrolls=(256, 512, 1024), B=4096, L=1024)
QUICK = dict(size=(64, 64), unrolls=(8, 16, 32), B=8, L=128)
BANDS = (64, 128)


def per_cell_instructions(packed: bool, p: ex.ExtendParams) -> int:
    """Instructions a DP cell with the fused DPX forms: packed 7 + k, pair
    state 18 + k, k three-way maxes over the window (the next power of
    two >= the gap reach; max is idempotent, so overlapping triples
    cover it)."""
    window, k = 1 << int(np.ceil(np.log2(ex._gap_reach(p.band, p.max_gap)))), 0
    while 3**k < window:
        k += 1
    return (7 if packed else 18) + k


def measure_ceiling(x: torch.Tensor, chain: str, unrolls, reps: int = REPS) -> dict:
    """The chain's median seconds at each unroll (lo, mid, hi); its
    steps/s from the difference of lo and hi (the JAX script's slope);
    ``linearity``, the slope from mid to hi over the slope from lo to mid
    (1.0 when the time is linear in the unroll, so the difference
    cancels a fixed cost only); ``fixed_s``, the time at unroll 0 on that
    line (launch, load, reduction)."""
    t = {u: float(np.median(bench.call_seconds(lambda u=u: ceiling.alu_chain(x, u, chain),
                                                reps, x.device)))
         for u in unrolls}
    lo, mid, hi = unrolls
    per_step = (t[hi] - t[lo]) / (hi - lo)
    return dict(seconds=t, ratio=t[hi] / t[lo],
                linearity=(t[hi] - t[mid]) / (hi - mid) / ((t[mid] - t[lo]) / (mid - lo)),
                fixed_s=t[lo] - lo * per_step, steps_per_s=x.numel() / max(per_step, 1e-15))


def kernel_inputs(band: int, B: int, L: int, device):
    """The JAX script's draws (seed 1): uniform random reads and windows."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8)).to(device)
    refwin = torch.from_numpy(rng.integers(0, 4, (B, L + band), dtype=np.uint8)).to(device)
    return q, refwin, torch.full((B,), L, dtype=torch.int32, device=device)


def measure_kernel(band: int, B: int, L: int, device, reps: int = REPS) -> dict:
    p = ex.ExtendParams(band=band)
    q, refwin, lengths = kernel_inputs(band, B, L, device)
    ts = bench.call_seconds(lambda: ex.banded_sw(q, refwin, lengths, p), reps, device)
    dt, cells = float(np.median(ts)), B * L * band
    kind = "packed" if ex.packed_mbits(L, p) else "pairstate"
    return dict(band=band, batch=B, read_len=L, kernel=f"banded_sw_{kind}_w{band}",
                seconds_median=dt, seconds_best=min(ts),
                gcells_per_s=round(cells / dt / 1e9, 2),
                gcells_per_s_best=round(cells / min(ts) / 1e9, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.roofline_sw",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="ROOFLINE_torch.json", help="write the payload here")
    ap.add_argument("--device", default="cuda", help="torch device of the chains and kernels")
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    sizes = QUICK if args.quick else FULL

    x = torch.from_numpy(ceiling.chain_input(sizes["size"])).to(dev).reshape(-1)
    chains = {c: measure_ceiling(x, c, sizes["unrolls"]) for c in ceiling.CHAINS}
    sass = None
    if dev.type == "cuda":
        sass = ceiling.sass_instructions(_native.library_path())
    vpu = OPS_PER_STEP * chains["int32"]["steps_per_s"]
    dpx = chains["dpx"]["steps_per_s"]  # one VIADDMNMX a step
    counted = sass or {}
    # the instruction rate of the int32 chain: SASS a step where counted
    ins_per_step = counted["int32"]["per_step"] if "int32" in counted else OPS_PER_STEP
    ceiling_ips = ins_per_step * chains["int32"]["steps_per_s"]
    for c, m in chains.items():
        s = counted.get(c)
        print(f"ceiling {c}: ops_per_step={OPS_PER_STEP if c == 'int32' else 1} "
              f"sass_per_step={s['per_step'] if s else 'not measured'} "
              f"sass_opcodes_per_step={json.dumps(s['opcodes_per_step']) if s else '-'} "
              f"seconds={json.dumps({u: round(t, 7) for u, t in m['seconds'].items()})} "
              f"ratio={m['ratio']:.3f} linearity={m['linearity']:.3f} "
              f"fixed_us={m['fixed_s'] * 1e6:.1f} steps_per_s={m['steps_per_s']:.4g}", flush=True)

    rows = [measure_kernel(b, sizes["B"], sizes["L"], dev) for b in BANDS]
    for r in rows:
        print(json.dumps(r), flush=True)
    if dev.type == "cuda":
        print(f"launches {json.dumps(_native.LAUNCHES)}", flush=True)
    p = ex.ExtendParams()
    per_cell = {"packed": per_cell_instructions(True, p),
                "pairstate": per_cell_instructions(False, p)}
    sol = {k: ceiling_ips / v for k, v in per_cell.items()}
    gpu = bench.card(dev)
    payload = dict(
        what=("banded-SW roofline on one card: the kernels against a measured integer-ALU "
              "ceiling (an int32 chain in a hand-written kernel, unroll 1024 minus 256), "
              "converted to cells/s by the kernels' own instructions a cell"),
        device=gpu,
        measured_vpu_gops_per_s=round(vpu / 1e9, 1),
        measured_dpx_gops_per_s=round(dpx / 1e9, 1),
        ceiling_instructions_per_s=ceiling_ips,
        sass_per_step=sass,
        chains=chains,
        ops_per_cell=per_cell,
        speed_of_light_gcells_per_s={k: round(v / 1e9, 1) for k, v in sol.items()},
        kernels=rows,
        fraction_of_light={
            f"band{r['band']}": round(r["batch"] * r["read_len"] * r["band"] / r["seconds_best"]
                                      / sol[r["kernel"].split("_")[2]], 4)
            for r in rows},
    )
    print(gpu, flush=True)
    print(json.dumps({k: payload[k] for k in (
        "measured_vpu_gops_per_s", "measured_dpx_gops_per_s", "speed_of_light_gcells_per_s",
        "fraction_of_light")}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Banded Smith–Waterman kernel throughput (Mcells/s) on one card — the
port's counterpart of ``scripts/bench_sw.py``.

Same positional ``B L W`` (defaults 2048, 1024, 64: ``banded_sw_packed<64>``
at 1 kb) and the same input draws: seed 0, a 4 Mbase random reference,
B windows at random starts, the reads copied from them with 8%
substitutions (:func:`inputs`).  The reads go through ``ex.banded_sw``
(a CUDA tensor launches the hand-written kernel), 1 warm-up, then 5 reps,
each timed with CUDA events (on the CPU, the plain version timed with the
host clock); the value is from their mean.  Cells = B × L × W.

Prints a stderr line (``bench_sw.py``'s fields), the card's name and
power limit, then ONE JSON line with ``bench_sw.py``'s keys.
``--quick`` (CPU tests): B = 16, L = 128 unless given.

    python -m monica_tpu_torch.bench_sw [B] [L] [W] [--device cuda] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from monica_tpu_torch import bench
from monica_tpu_torch.ops import _native
from monica_tpu_torch.ops import extend as ex

REPS = 5
# CPU SIMD SW (e.g. ksw2) sustains ~1-5 Gcells/s a core; 3 Gcells/s is
# bench_sw.py's single-core baseline denominator
BASELINE_MCELLS_PER_S = 3000.0


def inputs(B: int, L: int, W: int, device):
    """``bench_sw.py``'s draws: (q (B, L) uint8, refwin (B, L + W) uint8,
    lengths (B,) int32) on ``device``."""
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    starts = rng.integers(0, len(ref) - L - W, B)
    q = np.stack([ref[s : s + L] for s in starts])
    m = rng.random(q.shape) < 0.08
    q[m] = rng.integers(0, 4, int(m.sum()))
    refwin = ex.extract_ref_windows(torch.from_numpy(ref).to(device),
                                    torch.from_numpy(starts.astype(np.int32)).to(device), L, W)
    return (torch.from_numpy(q).to(device), refwin.contiguous(),
            torch.full((B,), L, dtype=torch.int32, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monica_tpu_torch.bench_sw",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("B", type=int, nargs="?")
    ap.add_argument("L", type=int, nargs="?")
    ap.add_argument("W", type=int, nargs="?", default=64,
                    help="band (64 or 128 on the card; 64 is the production default)")
    ap.add_argument("--device", default="cuda", help="torch device of the inputs")
    ap.add_argument("--quick", action="store_true", help="B = 16, L = 128 by default (CPU tests)")
    args = ap.parse_args(argv)
    dev = bench.check_device(args.device)
    B = args.B or (16 if args.quick else 2048)
    L = args.L or (128 if args.quick else 1024)
    W = args.W

    p = ex.ExtendParams(band=W)
    q, refwin, lengths = inputs(B, L, W, dev)
    out = {}

    def call():
        out["score"], out["mlen"] = ex.banded_sw(q, refwin, lengths, p)

    dt = float(np.mean(bench.call_seconds(call, REPS, dev)))
    if dev.type == "cuda":
        print(f"launches {json.dumps(_native.LAUNCHES)}", flush=True)
    mcells = B * L * W / dt / 1e6
    gpu = bench.card(dev)
    sys.stderr.write(f"[bench_sw] B={B} L={L} W={W} dt={dt * 1e3:.4f}ms "
                     f"median_score={np.median(out['score'].cpu().numpy()):.0f} device={gpu}\n")
    print(gpu, flush=True)
    print(json.dumps({
        "metric": "banded_sw_mcells_per_s_per_chip",
        "value": round(mcells, 1),
        "unit": "Mcells/s",
        "vs_baseline": round(mcells / BASELINE_MCELLS_PER_S, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

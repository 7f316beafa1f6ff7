"""Synthetic reference and read generators (host side, numpy) —
counterparts of ``zymo_community`` and ``simulate_read_codes`` in
``monica_tpu/evaluation.py``, drawing the same values from the same
generator, plus the two batch draws ``chip_smoke.py`` classifies."""

from __future__ import annotations

import numpy as np


def zymo_community(rng: np.random.Generator, scale: float = 1.0) -> list[np.ndarray]:
    """The ZymoBIOMICS mock-community analog: 8 bacteria and 2 yeasts,
    modelled as 8 × 5 Mb + 2 × 12 Mb ≈ 64 Mbase of random reference."""
    sizes = [int(5e6 * scale)] * 8 + [int(12e6 * scale)] * 2
    return [rng.integers(0, 4, size=n).astype(np.uint8) for n in sizes]


def _homopolymer_mask(frag: np.ndarray, min_run: int = 3) -> np.ndarray:
    """True at positions inside a homopolymer run of >= min_run."""
    if len(frag) == 0:
        return np.zeros(0, bool)
    starts = np.flatnonzero(np.concatenate([[True], frag[1:] != frag[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(frag)]]))
    return np.repeat(lens >= min_run, lens)


def simulate_read_codes(
    rng: np.random.Generator,
    genome: np.ndarray,
    read_len: int,
    sub: float,
    ins: float,
    dele: float,
    rc: bool,
    hp_bias: float = 1.0,
) -> np.ndarray:
    """One read (uint8 codes) with nanopore-like errors: substitutions
    that always change the base, deletions, and insertions, whose rates
    inside homopolymer runs are multiplied by ``hp_bias`` (capped at
    0.5); an insertion in a run repeats the run's base."""
    L = min(read_len + int(read_len * dele * 2) + 16, len(genome))
    start = int(rng.integers(0, len(genome) - L + 1))
    frag = genome[start : start + L]
    if rc:
        frag = (3 - frag)[::-1]
    hp = _homopolymer_mask(frag)
    p_del = np.where(hp, np.minimum(dele * hp_bias, 0.5), dele)
    r = rng.random(len(frag))
    keep = r >= p_del
    frag = frag.copy()
    is_sub = (r >= p_del) & (r < p_del + sub)
    frag[is_sub] = (frag[is_sub] + rng.integers(1, 4, int(is_sub.sum()))) % 4
    hp = hp[keep]
    frag = frag[keep]
    p_ins = np.where(hp, np.minimum(ins * hp_bias, 0.5), ins)
    n_ins = rng.random(len(frag)) < p_ins
    if n_ins.any():
        out = np.empty(len(frag) + int(n_ins.sum()), dtype=np.uint8)
        j = 0
        ins_vals = rng.integers(0, 4, int(n_ins.sum())).astype(np.uint8)
        vi = 0
        for i, c in enumerate(frag):
            out[j] = c
            j += 1
            if n_ins[i]:
                out[j] = c if hp[i] else ins_vals[vi]
                j += 1
                vi += 1
        frag = out
    return frag[:read_len]


def bench_reads(seqs, rng: np.random.Generator, n_reads: int, read_len: int = 1024,
                sub: float = 0.05):
    """The bench workload's reads: start positions uniform over the
    community (genome drawn by size), ``sub`` random-base substitutions.
    Returns (codes (n_reads, read_len) uint8, source genome per read)."""
    sizes = np.array([len(s) for s in seqs], dtype=np.float64)
    gsel = rng.choice(len(seqs), size=n_reads, p=sizes / sizes.sum())
    codes = np.empty((n_reads, read_len), dtype=np.uint8)
    for i, g in enumerate(gsel):
        s = rng.integers(0, len(seqs[g]) - read_len)
        codes[i] = seqs[g][s : s + read_len]
    m = rng.random(codes.shape) < sub
    codes[m] = rng.integers(0, 4, int(m.sum()))
    return codes, gsel


def sim_batch(seqs, rng: np.random.Generator, n: int, lo: int, hi: int, error, bucket: int):
    """n simulated reads of length in [lo, hi] (random strand, ``error``
    = (sub, ins, del)), padded into one ``bucket``-wide batch.
    Returns (codes, lengths, source genome per read)."""
    labels = rng.integers(0, len(seqs), n)
    codes = np.full((n, bucket), 4, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, g in enumerate(labels):
        r = simulate_read_codes(rng, seqs[g], int(rng.integers(lo, hi + 1)), *error,
                                bool(rng.random() < 0.5))
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return codes, lengths, labels

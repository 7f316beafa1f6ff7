"""Synthetic reference and read generators (host side, numpy) —
counterparts of ``zymo_community`` and ``simulate_read_codes`` in
``monica_tpu/evaluation.py`` and of the gut community ``bench.py --gut``
draws, drawing the same values from the same generator, plus the batch
draws and the FASTQ samples ``chip_smoke.py`` classifies, and the random
ShardHit stacks on which the merge is held to the JAX package (tests)
and the card to the CPU (``chip_smoke.py``)."""

from __future__ import annotations

import numpy as np


def zymo_community(rng: np.random.Generator, scale: float = 1.0) -> list[np.ndarray]:
    """The ZymoBIOMICS mock-community analog: 8 bacteria and 2 yeasts,
    modelled as 8 × 5 Mb + 2 × 12 Mb ≈ 64 Mbase of random reference."""
    sizes = [int(5e6 * scale)] * 8 + [int(12e6 * scale)] * 2
    return [rng.integers(0, 4, size=n).astype(np.uint8) for n in sizes]


def gut_community(rng: np.random.Generator) -> list[np.ndarray]:
    """The gut-microbiome analog of BASELINE config 3 (a 200-genome
    RefSeq subset): 200 × 1.5 Mb = 300 Mbase of random reference, more
    than one 2^26-base shard holds."""
    return [rng.integers(0, 4, 1_500_000).astype(np.uint8) for _ in range(200)]


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
        # after each base drawn for an insertion: a copy of it inside a
        # homopolymer run, else the next random base
        at = np.flatnonzero(n_ins)
        ins_vals = rng.integers(0, 4, len(at)).astype(np.uint8)
        frag = np.insert(frag, at + 1, np.where(hp[at], frag[at], ins_vals))
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


def nanopore_lengths(rng: np.random.Generator, n: int, lo: int = 300,
                     hi: int = 40_000) -> np.ndarray:
    """n read lengths drawn log-uniform over [lo, hi] bp (int64)."""
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)


def nanopore_sample(seqs, rng: np.random.Generator, lengths, error):
    """One simulated read per length (random genome, random strand,
    ``error`` = (sub, ins, del)).  Returns (reads as uint8 code arrays,
    source genome per read)."""
    labels = rng.integers(0, len(seqs), len(lengths))
    reads = [simulate_read_codes(rng, seqs[g], int(n), *error, bool(rng.random() < 0.5))
             for g, n in zip(labels, lengths)]
    return reads, labels


SHARD_HIT_DTYPES = dict(acc_id=np.int32, inv_identity=np.float32, merge_cost=np.float32,
                        mlen=np.int32, mapq=np.float32, votes=np.int32, passed=bool, rc=bool,
                        ref_pos=np.int32, tied=bool)


def fma_cost_band(best: np.ndarray, tie_rel_tol: float) -> np.ndarray:
    """float32 ``best * (1 + tie_rel_tol) + 1e-6`` rounded once, as a
    fused multiply-add rounds it."""
    return (best.astype(np.float64) * np.float64(np.float32(1.0 + tie_rel_tol))
            + np.float64(np.float32(1e-6))).astype(np.float32)


def random_shard_hits(rng: np.random.Generator, S: int, B: int, tie_rel_tol: float,
                      vote_tie_sd: float) -> dict:
    """The fields of an (S, B) ShardHit stack as numpy arrays (dtypes of
    :data:`SHARD_HIT_DTYPES`), full of what the cross-shard merge must
    decide exactly: exact ties, same-accession ties, near-ties inside and
    outside both bands, reads on the exact cost-band edge (rounded once
    and rounded twice) and one ulp outside it."""
    passed = rng.random((S, B)) < 0.7
    acc = rng.integers(0, 4, (S, B))
    cost = (rng.random((S, B)) * 0.3).astype(np.float32)
    votes = rng.integers(1, 80, (S, B))
    best = cost[0]
    kind = rng.integers(0, 8, B)
    for j in range(1, S):
        r = rng.random(B)
        u = np.where(r < 0.5, rng.uniform(0.2, 0.95, B), rng.uniform(1.05, 1.8, B))
        cost[j] = np.select(
            [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
            [best,  # exact tie
             best * (1 + np.float32(tie_rel_tol) * u.astype(np.float32)),  # near the band
             fma_cost_band(best, tie_rel_tol),  # on the single-rounded edge
             best * np.float32(1.0 + tie_rel_tol) + np.float32(1e-6),  # the two-step edge
             np.nextafter(fma_cost_band(best, tie_rel_tol), np.float32(2))],  # one ulp out
            cost[j]).astype(np.float32)
        vu = np.round(np.sqrt(votes[0]) * vote_tie_sd * u * np.sign(r - 0.5)).astype(np.int64)
        votes[j] = np.where(kind == 5, np.maximum(votes[0] + vu, 1), votes[j])
        acc[j] = np.where(kind == 6, acc[0], acc[j])  # same-accession tie
    fields = dict(
        acc_id=acc, inv_identity=rng.random((S, B)), merge_cost=cost,
        mlen=rng.integers(1, 5000, (S, B)), mapq=rng.random((S, B)) * 60,
        votes=votes, passed=passed, rc=rng.random((S, B)) < 0.5,
        ref_pos=rng.integers(0, 1 << 20, (S, B)), tied=rng.random((S, B)) < 0.15,
    )
    return {f: np.asarray(v, SHARD_HIT_DTYPES[f]) for f, v in fields.items()}


_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def write_fastq_sample(path, reads, prefix: str = "read") -> None:
    """Write code arrays as a 4-line FASTQ sample, ids ``<prefix><i>``
    and constant quality."""
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                               _BASES[np.minimum(r, 4)].tobytes(),
                                               b"I" * len(r)))

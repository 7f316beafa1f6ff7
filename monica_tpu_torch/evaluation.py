"""Accuracy harness and synthetic data (host side, numpy) — counterpart
of ``monica_tpu/evaluation.py``: the mock community with conserved
blocks and repeats, strain siblings, the Zymo community and the read
simulator, drawing the same values from the same generator; ``evaluate``
and ``strain_pair_eval``, which score simulated reads classified through
the port's ``Classifier`` against their truth (``concordance.py`` drives
them); the gut community ``bench.py --gut`` draws; and the batch draws,
FASTQ samples and random ShardHit stacks that ``chip_smoke.py`` and the
tests use.

Every performance knob (minimizer scaling, seed slots, hits per seed)
is validated against this harness before it changes a default.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def mock_community(
    rng: np.random.Generator,
    n_genomes: int,
    genome_len: int,
    shared_blocks: int = 4,
    shared_len: int = 2000,
    tandem_repeats: int = 0,
    dispersed_repeats: int = 0,
) -> list[np.ndarray]:
    """Random genomes with conserved blocks copied between neighbours (the
    16S or mobile-element analog): classification must rely on the unique
    remainder, and reads wholly inside a shared block are ambiguous.

    ``tandem_repeats``: per genome, loci where a 100-400 bp unit repeats
    4-12 times in place; ``dispersed_repeats``: per genome, 500-1500 bp
    blocks copied to 3 more places in the same genome (a read inside one
    has several equal loci in one genome, which must not become
    cross-genome ambiguity)."""
    seqs = [rng.integers(0, 4, size=genome_len).astype(np.uint8) for _ in range(n_genomes)]
    for _ in range(shared_blocks):
        block = rng.integers(0, 4, size=shared_len).astype(np.uint8)
        for g in range(n_genomes):
            if rng.random() < 0.5:  # each genome carries about half the blocks
                start = int(rng.integers(0, genome_len - shared_len))
                seqs[g][start : start + shared_len] = block
    for g in range(n_genomes):
        for _ in range(tandem_repeats):
            unit = rng.integers(0, 4, size=int(rng.integers(100, 400))).astype(np.uint8)
            n_copies = int(rng.integers(4, 13))
            span = len(unit) * n_copies
            if span < genome_len:
                start = int(rng.integers(0, genome_len - span))
                seqs[g][start : start + span] = np.tile(unit, n_copies)
        for _ in range(dispersed_repeats):
            blen = int(rng.integers(500, 1500))
            src = int(rng.integers(0, genome_len - blen))
            block = seqs[g][src : src + blen].copy()
            for _ in range(3):
                dst = int(rng.integers(0, genome_len - blen))
                seqs[g][dst : dst + blen] = block
    return seqs


def sibling_genome(rng: np.random.Generator, base: np.ndarray, divergence: float,
                   indel_frac: float = 0.3) -> np.ndarray:
    """A strain sibling at ANI = 1 - ``divergence``: point substitutions
    (always a real base change) plus short 1-3 bp deletions and
    insertions alternating along the genome (``indel_frac`` of the
    events' bases)."""
    n = len(base)
    n_events = int(n * divergence)
    out = base.copy()
    n_sub = int(n_events * (1.0 - indel_frac))
    if n_sub:
        pos = rng.choice(n, size=n_sub, replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, n_sub)) % 4
    n_indel_bases = n_events - n_sub
    if n_indel_bases <= 0:
        return out
    parts = []
    cursor = 0
    budget = n_indel_bases
    sites = np.sort(rng.choice(n - 8, size=max(n_indel_bases // 2, 1), replace=False))
    for i, s in enumerate(sites):
        if budget <= 0 or s <= cursor:
            continue
        ln = int(rng.integers(1, 4))
        parts.append(out[cursor:s])
        if i % 2 == 0:  # deletion
            cursor = s + ln
        else:  # insertion
            parts.append(rng.integers(0, 4, ln).astype(np.uint8))
            cursor = s
        budget -= ln
    parts.append(out[cursor:])
    return np.concatenate(parts)


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


@dataclass
class EvalResult:
    n_reads: int
    n_mapped: int = 0
    n_correct: int = 0
    n_wrong: int = 0
    n_ambiguous: int = 0
    n_unmapped: int = 0
    settings: dict = field(default_factory=dict)

    @property
    def accuracy(self) -> float:
        """Share of ALL reads assigned to their true genome."""
        return self.n_correct / max(self.n_reads, 1)

    @property
    def precision(self) -> float:
        """Share of MAPPED reads assigned correctly."""
        return self.n_correct / max(self.n_mapped, 1)

    def row(self) -> dict:
        return dict(
            **self.settings,
            reads=self.n_reads,
            accuracy=round(self.accuracy, 4),
            # no calls: precision is undefined, not zero (all-ambiguous is
            # the right outcome on a near-identical pair)
            precision=round(self.precision, 4) if self.n_mapped else None,
            mapped=self.n_mapped,
            wrong=self.n_wrong,
            ambiguous=self.n_ambiguous,
            unmapped=self.n_unmapped,
        )


def evaluate(
    built,
    seqs: list[np.ndarray],
    params,
    rng: np.random.Generator,
    n_reads: int = 512,
    read_len: int = 1000,
    error: tuple[float, float, float] = (0.05, 0.03, 0.03),
    batch: int = 512,
    hp_bias: float = 1.0,
    classifier=None,
    *,
    device=None,
    mesh=None,
) -> EvalResult:
    """Classify simulated reads against a built index and score them
    against their truth, through the port's ``Classifier`` (the product
    dispatch path: packed wire, grouped or mesh stacking, per-bucket
    params).  Without ``classifier``, one is made in basic count mode on
    ``device`` or ``mesh``.  The reads are drawn in the JAX package's
    order, so one seed gives the same reads in both packages."""
    from monica_tpu_torch.align import pipeline as pl
    from monica_tpu_torch.align import runtime as rt

    sub, ins, dele = error
    labels = rng.integers(0, len(seqs), n_reads)
    rcs = rng.random(n_reads) < 0.5
    codes = np.full((n_reads, read_len), 4, dtype=np.uint8)
    lengths = np.zeros(n_reads, dtype=np.int32)
    for i in range(n_reads):
        r = simulate_read_codes(rng, seqs[labels[i]], read_len, sub, ins, dele, rcs[i],
                                hp_bias=hp_bias)
        codes[i, : len(r)] = r
        lengths[i] = len(r)

    clf = classifier or rt.Classifier(built, params, count_mode="basic", device=device,
                                      mesh=mesh)
    mult = clf.batch_row_multiple()
    res = EvalResult(n_reads=n_reads)
    for s0 in range(0, n_reads, batch):
        n = min(batch, n_reads - s0)
        rows = -(-n // mult) * mult  # padding rows: length 0, masked
        c = np.full((rows, read_len), 4, np.uint8)
        c[:n] = codes[s0 : s0 + n]
        ln = np.zeros(rows, np.int32)
        ln[:n] = lengths[s0 : s0 + n]
        st, ac, _ml, _c = clf.fetch(*clf.classify(c, ln))
        for r, lab in enumerate(labels[s0 : s0 + n]):
            if st[r] == pl.MAPPED:
                res.n_mapped += 1
                if ac[r] == lab:
                    res.n_correct += 1
                else:
                    res.n_wrong += 1
            elif st[r] == pl.AMBIGUOUS:
                res.n_ambiguous += 1
            else:
                res.n_unmapped += 1
    return res


def strain_pair_eval(
    rng: np.random.Generator,
    params,
    genome_len: int = 1_000_000,
    divergence: float = 0.03,
    n_reads: int = 512,
    read_len: int = 1000,
    error: tuple[float, float, float] = (0.05, 0.03, 0.03),
    hp_bias: float = 1.0,
    *,
    device,
) -> EvalResult:
    """Strain discrimination at ANI = 1 - ``divergence``: a base genome
    and its sibling indexed together (built on ``device``), reads drawn
    from both.  At high ANI many reads cannot be told apart and the right
    answer is AMBIGUOUS, not a guess: precision (correct / mapped) is the
    gated metric."""
    from monica_tpu_torch.index.build import build_index_from_arrays

    base = rng.integers(0, 4, genome_len).astype(np.uint8)
    sib = sibling_genome(rng, base, divergence)
    built = build_index_from_arrays([base, sib], tax_units=["Base_sp", "Sibling_sp"],
                                    device=device)
    res = evaluate(built, [base, sib], params, rng, n_reads=n_reads, read_len=read_len,
                   error=error, hp_bias=hp_bias, device=device)
    res.settings = dict(kind="strain_pair", ani=round(1.0 - divergence, 4),
                        genome_len=genome_len, read_len=read_len, error=error, hp_bias=hp_bias)
    return res


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

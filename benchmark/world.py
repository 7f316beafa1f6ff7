"""The benchmark's inputs, made from ``--seed``: the genomes of a
deployment and the read batches of a traffic mix.

The read simulator and the batching rule are frozen copies of the
port's ``evaluation.simulate_read_codes`` and ``io.encode.window_plan``,
so a later change to the program cannot move the yardstick.  Every seed
gets the same set of read lengths (drawn once from the mix's length
distribution by a generator of its own, then shuffled) and so the same
batch shapes; the seed picks genomes (weighted by the configuration's
abundances), positions, strands and errors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PAD_CODE = 4
DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
MIN_TAIL = 256

# sub-streams of the seed (the genomes come from a generator on the device)
_READS, _SAMPLE = 2, 3


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def _each_genome(config: dict):
    """Every genome entry of the configuration, an entry with a
    ``count`` repeated that many times."""
    return [g for g in config["genomes"] for _ in range(g.get("count", 1))]


def draw_genomes(config: dict, seed: int, device) -> list[np.ndarray]:
    """Uniform random genomes of the configuration's sizes, drawn in one
    call on ``device`` from the seed and brought to the host once (the
    build takes host arrays).  Returns one uint8 code array a genome,
    all views of one buffer."""
    sizes = [g["length"] for g in _each_genome(config)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 2 + 1)
    flat = torch.randint(0, 4, (sum(sizes),), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [flat[offs[i]: offs[i + 1]] for i in range(len(sizes))]


def window_plan(lengths, buckets=DEFAULT_BUCKETS, max_batch=None):
    """Device rows for a set of read lengths, the runtime's rule
    (``io.encode.window_plan``): ``[(bucket_len, [(read_idx, offset,
    wlen), ...]), ...]``, ascending buckets, at most ``max_batch`` rows a
    batch; a read longer than the largest bucket is split into windows."""
    B = buckets[-1]
    per: dict[int, list] = {}
    for i, n in enumerate(lengths):
        n = int(n)
        if n <= B:
            per.setdefault(next(b for b in buckets if n <= b), []).append((i, 0, n))
            continue
        off = 0
        while off < n:
            w = min(B, n - off)
            if w < MIN_TAIL:
                break
            per.setdefault(next(b for b in buckets if w <= b), []).append((i, off, w))
            off += w
    out = []
    for blen in sorted(per):
        rows = per[blen]
        step = max_batch or len(rows)
        for s in range(0, len(rows), step):
            out.append((blen, rows[s: s + step]))
    return out


def genome_weights(config: dict) -> np.ndarray:
    """The share of the reads that each genome gives: its entry's
    ``abundance`` (a share of the sample's DNA; reads have the same
    length distribution whatever their genome), equal where none is
    given."""
    w = np.array([g.get("abundance", 1.0) for g in _each_genome(config)], np.float64)
    return w / w.sum()


def file_lengths(traffic: dict) -> np.ndarray:
    """The read lengths of one file, the same set for every seed:
    ``file_reads`` draws from a gamma distribution of the mix's mean and
    standard deviation, by a generator seeded with the mix's
    ``draw_seed``; a draw under ``lo`` bp is drawn again."""
    spec = traffic["lengths"]
    if spec["dist"] != "gamma":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    shape = (spec["mean"] / spec["sd"]) ** 2
    scale = spec["sd"] ** 2 / spec["mean"]
    rng = np.random.default_rng(spec["draw_seed"])
    out = rng.gamma(shape, scale, traffic["file_reads"])
    while (low := out < spec["lo"]).any():
        out[low] = rng.gamma(shape, scale, int(low.sum()))
    return out.astype(np.int64)


def _homopolymer_mask(frag: np.ndarray, min_run: int = 3) -> np.ndarray:
    if len(frag) == 0:
        return np.zeros(0, bool)
    starts = np.flatnonzero(np.concatenate([[True], frag[1:] != frag[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(frag)]]))
    return np.repeat(lens >= min_run, lens)


def simulate_read_codes(rng, genome, read_len, sub, ins, dele, rc, hp_bias=1.0):
    """One nanopore-like read (``evaluation.simulate_read_codes``):
    substitutions that always change the base, deletions, insertions
    (a homopolymer's base inside a run)."""
    L = min(read_len + int(read_len * dele * 2) + 16, len(genome))
    start = int(rng.integers(0, len(genome) - L + 1))
    frag = genome[start: start + L]
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
        at = np.flatnonzero(n_ins)
        ins_vals = rng.integers(0, 4, len(at)).astype(np.uint8)
        frag = np.insert(frag, at + 1, np.where(hp[at], frag[at], ins_vals))
    return frag[:read_len]


def _file_reads(genomes, weights, traffic: dict, rng) -> tuple[list[np.ndarray], np.ndarray]:
    """One file of reads -> (reads, source genome of each): genomes
    drawn by ``weights``, either strand, the mix's error rates."""
    lengths = rng.permutation(file_lengths(traffic))
    err = traffic["errors"]
    src = rng.choice(len(genomes), size=len(lengths), p=weights)
    reads = [simulate_read_codes(rng, genomes[g], int(n), err["sub"], err["ins"],
                                 err["del"], bool(rng.random() < 0.5))
             for g, n in zip(src, lengths)]
    return reads, src


@dataclass
class Batch:
    """One device batch as the runtime forms it: codes (n, L) uint8 with
    PAD past each length, lengths (n,) int32, and the source genome of
    each row (the ground truth)."""

    codes: np.ndarray
    lengths: np.ndarray
    source: np.ndarray

    @property
    def rows(self) -> int:
        return len(self.lengths)


def make_pool(genomes, weights, traffic: dict, seed: int) -> list[Batch]:
    """``pool_files`` files of the mix, each cut into batches by the
    runtime's rule (``window_plan`` over the default buckets, at most
    ``max_batch`` rows; a read over the largest bucket gives a row a
    window), in file order."""
    rng = rng_for(seed, _READS)
    pool = []
    for _ in range(traffic["pool_files"]):
        reads, src = _file_reads(genomes, weights, traffic, rng)
        for blen, rows in window_plan([len(r) for r in reads], DEFAULT_BUCKETS,
                                      traffic["max_batch"]):
            codes = np.full((len(rows), blen), PAD_CODE, np.uint8)
            lengths = np.zeros(len(rows), np.int32)
            source = np.zeros(len(rows), np.int32)
            for j, (i, off, w) in enumerate(rows):
                codes[j, :w] = reads[i][off: off + w]
                lengths[j] = w
                source[j] = src[i]
            pool.append(Batch(codes, lengths, source))
    return pool


def check_rows(pool: list[Batch], traffic: dict, seed: int) -> list[np.ndarray]:
    """The rows of each pool batch that the check compares, drawn from
    the seed: ``check_rows_per_batch`` of them, and the batch's longest
    read always among them."""
    rng = rng_for(seed, _SAMPLE)
    out = []
    for b in pool:
        k = min(traffic["check_rows_per_batch"], b.rows)
        pick = set(rng.choice(b.rows, size=k, replace=False).tolist())
        pick.add(int(np.argmax(b.lengths)))
        out.append(np.array(sorted(pick), np.int64))
    return out

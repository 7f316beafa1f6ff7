"""The plain reference's classification of read batches: what the port's
``Classifier.classify`` must give for each read — status, accession id
and matched length — frozen from the port's plain versions
(``minimizer.sketch_reads``, ``lookup.lookup_anchors``,
``chain.chain_votes``, ``pipeline.classify_shard``, ``finalize_single``,
``merge_hits``, ``extend.extend_hits`` and ``banded_sw_torch``).

Each read's answer depends only on the read and its batch's bucket
length (the rescue tier extends every candidate whatever its size, and
every other step works row by row), so the reference classifies any
subset of a batch's rows at the batch's width.  Its banded SW runs in
numpy on the host (:mod:`.sw`), every job of every batch and shard in
one call per DP form; the rest runs in PyTorch on the device it is
given.

Reads reach the port's pipeline as 2-bit codes (``Classifier.classify``
packs them), so a base other than A, C, G or T, the padding past a
read's length included, reads as A; only the extension masks a read
past its length again.  The reference takes its input the same way.

``fdt`` and ``sw_int16`` lower the precision for the control: the vote
statistics (identity, mapq, the merge's costs) in ``fdt`` instead of
float32, the DP in 16-bit integers instead of 32-bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import sw as swmod
from benchmark.reference.index import (INVALID_HASH, MASK32, ROW_SLOTS, RefIndex, kmer_hashes,
                                       select_minimizers)

UNMAPPED, MAPPED, AMBIGUOUS = 0, 1, 2
DIAG_SHIFT = 8
INVALID_KEY = 1 << 30


@dataclass(frozen=True)
class Params:
    """The pipeline's parameters as the configuration states them."""

    k: int = 15
    w: int = 10
    frac: float = 1.0
    n_slots: int = 128
    mapping_quality: float = 60.0
    min_votes: int = 3
    band: int = 64
    rescue_nm_rate: float = 0.35
    rescue_min_cov: float = 0.5
    rescue_min_votes: int = 1
    anchors_per_seed: int = 2
    tie_rel_tol: float = 0.10
    vote_tie_sd: float = 1.0


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    lo = x.min(dim=-1, keepdim=True).values
    return torch.where(x == lo, iota, n).min(dim=-1).values


def sketch(codes: torch.Tensor, lengths: torch.Tensor, n_slots: int, p: Params):
    """Positional minimizer slots of each read: slot j the first smallest
    hash of segment j (segments of ceil(m / n_slots) k-mers), winnowed
    only where a segment is shorter than w; a slot is valid when its
    hash is and its k-mer lies inside the read."""
    h, s = kmer_hashes(codes, p.k)
    B, m = h.shape
    seg = -(-m // n_slots)
    pad = seg * n_slots - m
    if seg >= p.w and p.frac >= 1.0:
        key = h
    else:
        key = torch.where(select_minimizers(h, p.w, p.frac), h, INVALID_HASH)
    if pad:
        key = torch.cat([key, torch.full((B, pad), INVALID_HASH, dtype=key.dtype,
                                         device=key.device)], -1)
        s = torch.cat([s, torch.zeros((B, pad), dtype=s.dtype, device=s.device)], -1)
    key = key.reshape(B, n_slots, seg)
    j = first_argmin(key)
    hh = torch.gather(key, 2, j[..., None])[..., 0]
    ss = torch.gather(s.reshape(B, n_slots, seg), 2, j[..., None])[..., 0]
    base = torch.arange(n_slots, device=codes.device) * seg
    pos = torch.clamp(base[None, :] + j, max=m - 1).to(torch.int32)
    valid = (hh != INVALID_HASH) & (pos < (lengths[:, None] - p.k + 1))
    return hh, pos, ss, valid


def lookup(table: torch.Tensor, qh, qp, qs, qv, tag_bits: int, bucket_len: int, A: int):
    """Anchors of each read in one shard: (key, diag, read_pos, ref_pos),
    each (B, S * A); verified hits ranked by their unsigned entry,
    highest first, A a seed."""
    B, S = qh.shape
    rbits = int(np.log2(table.shape[0]))
    payload = 32 - tag_bits
    e = table[qh >> (32 - rbits)].to(torch.int64) & MASK32
    qtag = (qh & ((1 << tag_bits) - 1))[..., None]
    ps = e & ((1 << payload) - 1)
    ok = (qv & (qh != INVALID_HASH))[..., None] & ((e >> payload) == qtag) & (ps != 0)
    if A and A < ROW_SLOTS:
        e = torch.sort(torch.where(ok, e, 0), dim=-1, descending=True).values[..., :A]
        ps = e & ((1 << payload) - 1)
        ok = e != 0
    ps = ps.to(torch.int32)
    ref_pos = ps >> 1
    rc = qs[..., None] ^ (ps & 1).to(torch.bool)
    rp = qp[..., None]
    diag = torch.where(rc, ref_pos + rp, ref_pos - rp)
    key = torch.where(ok, (rc.to(torch.int32) << 24) | ((diag + bucket_len) >> DIAG_SHIFT),
                      INVALID_KEY)
    n = key.shape[-1]
    return (key.reshape(B, S * n), diag.reshape(B, S * n),
            rp.expand(rc.shape).reshape(B, S * n), ref_pos.reshape(B, S * n))


class Chain(NamedTuple):
    f1: torch.Tensor
    f2: torch.Tensor
    rep_read_pos: torch.Tensor
    rep_ref_pos: torch.Tensor
    rc: torch.Tensor
    rep2_ref_pos: torch.Tensor


def _take(x, i):
    return torch.gather(x, 1, i[:, None])[:, 0]


def chain(key, diag, read_pos, ref_pos, max_run: int) -> Chain:
    """Diagonal votes: the best (strand, bin) merged with bin + 1 (the
    stretch of sorted keys in {k, k + 1}, capped at max_run), the best
    vote outside it, and each locus's anchor of the smallest read
    position; first occurrence on every tie."""
    skeys = torch.sort(key, dim=-1).values
    valid = skeys != INVALID_KEY
    A = skeys.shape[-1]
    end = torch.searchsorted(skeys, skeys + 1, right=True)
    runs = torch.clamp(end - torch.arange(A, device=key.device), max=min(max_run, A))
    merged = torch.where(valid, runs.to(torch.int32), 0)
    best_i = first_argmin(-merged.to(torch.int64))
    f1 = _take(merged, best_i)
    best_key = _take(skeys, best_i)
    far = valid & ((skeys - best_key[:, None]).abs() > 1)
    f2m = torch.where(far, merged, 0)
    f2_i = first_argmin(-f2m.to(torch.int64))
    f2 = _take(f2m, f2_i)
    second = _take(skeys, f2_i)

    def rep(k):
        inside = (key == k[:, None]) | (key == k[:, None] + 1)
        i = first_argmin(torch.where(inside, read_pos, 1 << 30))
        return _take(read_pos, i), _take(ref_pos, i)

    rrp, rfp = rep(best_key)
    _, rfp2 = rep(second)
    return Chain(f1, f2, rrp, rfp, (best_key >> 24) > 0, rfp2)


def mapq_from_votes(f1, f2, fdt):
    f1f, f2f = f1.to(fdt), f2.to(fdt)
    safe = torch.clamp(f1f, min=1.0)
    q = 40.0 * (1.0 - f2f / safe) * torch.clamp(f1f / 10.0, max=1.0) * torch.log(safe * 15.0)
    return torch.clamp(torch.where(f1 > 0, q, 0.0), 0.0, 60.0)


def ref_windows(ref_codes, codes, lengths, ch: Chain, k: int, W: int):
    """The extension's inputs of each read: its codes with PAD past its
    length, and L + W reference bases around its chained locus, taken
    on the anti-diagonal, flipped and complemented for a reverse-strand
    locus; the window start clamped into the (padded) reference."""
    B, L = codes.shape
    i = torch.arange(L, device=codes.device)[None, :]
    q = torch.where(i < lengths[:, None], codes, 4).to(torch.uint8)
    fwd = ch.rep_ref_pos - ch.rep_read_pos - W // 2
    rc_start = ch.rep_ref_pos + ch.rep_read_pos + (k - 1) - (L - 1) - W // 2
    diag = torch.where(ch.rc, rc_start, fwd) + W // 2
    T = ref_codes.shape[0]
    start = torch.clamp(diag.to(torch.int64) - W // 2, 0, max(T - (L + W), 0))
    win = ref_codes[start[:, None] + torch.arange(L + W, device=codes.device)[None, :]]
    flipped = torch.flip(win, dims=(-1,))
    comp = torch.where(flipped < 4, 3 - flipped, flipped).to(torch.uint8)
    return q, torch.where(ch.rc[:, None], comp, win)


@dataclass
class _Shard:
    """One shard's state of one batch between the vote and the SW."""

    ch: Chain
    mapq: torch.Tensor
    mlen: torch.Tensor
    inv: torch.Tensor
    cost: torch.Tensor
    passed: torch.Tensor
    ext_rows: torch.Tensor  # rows that take the SW
    cand: torch.Tensor | None  # rescue candidates (None: every row extended)
    jobs: slice | None = None  # their place in the SW call


class _Batch:
    def __init__(self, codes, lengths, bucket_len):
        self.codes, self.lengths, self.L = codes, lengths, bucket_len
        self.shards: list[_Shard] = []


def _vote(index: RefIndex, b: _Batch, p: Params, matching: bool, fdt):
    n_slots = 64 if b.L > 512 and p.n_slots > 64 else p.n_slots
    qh, qp, qs, qv = sketch(b.codes, b.lengths, n_slots, p)
    lf = b.lengths.to(fdt)
    for sh in index.shards:
        ch = chain(*lookup(sh.table, qh, qp, qs, qv, index.tag_bits, b.L, p.anchors_per_seed),
                   max_run=min(128, n_slots))
        mapq = mapq_from_votes(ch.f1, ch.f2, fdt)
        n_valid = torch.clamp(qv.sum(dim=-1), min=1).to(fdt)
        frac = torch.clamp(ch.f1.to(fdt) / n_valid, 1e-6, 1.0)
        identity = torch.exp(torch.log(frac) / p.k)
        mlen = torch.clamp(identity * lf, min=1.0)
        inv = (1.0 - identity) / torch.clamp(identity, min=1e-6)
        passed = (mapq >= p.mapping_quality) & (ch.f1 >= p.min_votes) & (b.lengths > 0)
        if matching:
            cand, rows = None, torch.arange(len(b.lengths), device=b.codes.device)
        else:
            cand = (~passed & (ch.f1 >= p.rescue_min_votes) & (ch.f2 * 2 <= ch.f1)
                    & (b.lengths > 0))
            rows = torch.nonzero(cand)[:, 0]
        b.shards.append(_Shard(ch, mapq, mlen, inv, inv, passed, rows, cand))


def _finish_shard(sh: _Shard, ref: torch.Tensor, b: _Batch, score, mlen_x, p: Params, fdt):
    """The shard's hit of each read once its SW results are in."""
    dev = b.codes.device
    lf = b.lengths.to(fdt)
    ch, mlen, inv, passed = sh.ch, sh.mlen, sh.inv, sh.passed
    if len(sh.ext_rows):
        score = torch.from_numpy(score).to(dev)
        mlen_x = torch.from_numpy(mlen_x).to(dev)
        nm = torch.clamp(torch.div(2 * mlen_x - score, 4, rounding_mode="floor"), min=0)
        x_inv = nm.to(fdt) / torch.clamp(mlen_x, min=1).to(fdt)
        r = sh.ext_rows
        if sh.cand is None:
            mlen = mlen_x.to(fdt)
            inv = x_inv
            rescued = ((ch.f1 >= p.rescue_min_votes) & (ch.f2 * 2 <= ch.f1)
                       & (x_inv <= p.rescue_nm_rate) & (mlen_x.to(fdt) >= p.rescue_min_cov * lf)
                       & (b.lengths > 0))
        else:
            ok = (x_inv <= p.rescue_nm_rate) & (mlen_x.to(fdt) >= p.rescue_min_cov * lf[r])
            rescued = torch.zeros_like(passed).index_put_((r,), ok)
            inv_sc = torch.zeros_like(inv).index_put_((r,), torch.where(ok, x_inv, 0.0).to(fdt))
            mlen_sc = torch.zeros_like(mlen).index_put_(
                (r,), torch.where(ok, mlen_x.to(fdt), 0.0).to(fdt))
            inv = torch.where(rescued, inv_sc, inv)
            mlen = torch.where(rescued, mlen_sc, mlen)
        passed = passed | rescued
    T = ref.pos_acc.shape[0]
    acc = ref.pos_acc[torch.clamp(ch.rep_ref_pos, 0, T - 1).long()]
    acc2 = ref.pos_acc[torch.clamp(ch.rep2_ref_pos, 0, T - 1).long()]
    tied = (ch.f2 == ch.f1) & (ch.f1 >= p.min_votes) & (acc2 != acc) & (b.lengths > 0)
    return dict(acc=acc, inv=inv, cost=sh.cost, mlen=mlen.to(torch.int32), votes=ch.f1,
                passed=passed & ~tied, tied=tied)


def _merge(hits: list[dict], p: Params, fdt):
    """The best passing shard of each read by cost (the first on an exact
    tie); AMBIGUOUS when another passing shard with another accession
    lies within best * (1 + tie_rel_tol) + 1e-6 (rounded once) or within
    vote_tie_sd * sqrt(best votes); with none passing, AMBIGUOUS when a
    shard reports a tie inside it."""
    st = {f: torch.stack([h[f] for h in hits]) for f in hits[0]}
    S = st["passed"].shape[0]
    dev = st["passed"].device
    cost = torch.where(st["passed"], st["cost"], torch.full((), 1e9, dtype=fdt, device=dev))
    best_s = first_argmin(cost.T)

    def take(x):
        return torch.gather(x, 0, best_s[None, :])[0]

    best_cost = take(cost)
    band = (best_cost.double() * float(np.float32(1.0 + p.tie_rel_tol))
            + float(np.float32(1e-6))).to(fdt)
    near = cost <= band[None, :]
    if p.vote_tie_sd > 0.0:
        bv = take(st["votes"]).to(fdt)
        vband = torch.full((), p.vote_tie_sd, dtype=fdt, device=dev) * torch.sqrt(
            torch.clamp(bv, min=1.0))
        near = near | (torch.abs(st["votes"].to(fdt) - bv[None, :]) <= vband[None, :])
    is_best = torch.arange(S, device=dev)[:, None] == best_s[None, :]
    best_acc = take(st["acc"])
    tie = (near & ~is_best & st["passed"] & (st["acc"] != best_acc[None, :])).any(dim=0)
    status = torch.where(st["passed"].any(dim=0), torch.where(tie, AMBIGUOUS, MAPPED),
                         torch.where(st["tied"].any(dim=0), AMBIGUOUS, UNMAPPED))
    mapped = status == MAPPED
    return status, torch.where(mapped, best_acc, -1), torch.where(mapped, take(st["mlen"]), 0)


def _finalize(hit: dict):
    status = torch.where(hit["passed"], MAPPED, torch.where(hit["tied"], AMBIGUOUS, UNMAPPED))
    return (status, torch.where(hit["passed"], hit["acc"], -1),
            torch.where(hit["passed"], hit["mlen"], 0))


def classify(index: RefIndex, batches, p: Params, matching: bool, device,
             fdt=torch.float32, sw_int16: bool = False):
    """``batches``: (codes (n, L) uint8, lengths (n,)) host arrays, each at
    its batch's bucket width L.  Returns one (status, acc_id, mlen) of
    int32 host arrays a batch."""
    work = []
    for codes, lengths in batches:
        b = _Batch(torch.from_numpy(np.where(codes < 4, codes, 0).astype(np.uint8)).to(device),
                   torch.from_numpy(np.asarray(lengths, np.int32)).to(device), codes.shape[1])
        _vote(index, b, p, matching, fdt)
        work.append(b)

    # every SW job, by DP form: the packed buckets in one call, the
    # pair-state buckets in another
    forms: dict[int, list] = {}
    for b in work:
        form = 1 if sw_int16 or swmod.packed_mbits(b.L, p.band) == 0 else 0
        for sh, ref in zip(b.shards, index.shards):
            if len(sh.ext_rows):
                r = sh.ext_rows
                q, win = ref_windows(ref.ref_codes, b.codes[r], b.lengths[r],
                                     Chain(*(f[r] for f in sh.ch)), p.k, p.band)
                forms.setdefault(form, []).append(
                    (sh, q.cpu().numpy(), win.cpu().numpy(), b.lengths[r].cpu().numpy(), b.L))
    results = {}
    for form, jobs in forms.items():
        width = max(j[4] for j in jobs)
        n = sum(len(j[3]) for j in jobs)
        q = np.full((n, width), 4, np.uint8)
        win = np.full((n, width + p.band), 4, np.uint8)
        lens = np.zeros(n, np.int64)
        o = 0
        for sh, jq, jw, jl, _L in jobs:
            m = len(jl)
            q[o: o + m, : jq.shape[1]] = jq
            win[o: o + m, : jw.shape[1]] = jw
            lens[o: o + m] = jl
            sh.jobs = slice(o, o + m)
            o += m
        results[form] = swmod.banded_sw(q, win, lens, p.band, width, int16=sw_int16)

    out = []
    for b in work:
        form = 1 if sw_int16 or swmod.packed_mbits(b.L, p.band) == 0 else 0
        hits = []
        for sh, ref in zip(b.shards, index.shards):
            score = mlen_x = None
            if len(sh.ext_rows):
                score, mlen_x = (r[sh.jobs] for r in results[form])
            hits.append(_finish_shard(sh, ref, b, score, mlen_x, p, fdt))
        res = _merge(hits, p, fdt) if index.grouped else _finalize(hits[0])
        out.append(tuple(t.to(torch.int32).cpu().numpy() for t in res))
    return out


def candidates(index: RefIndex, codes: np.ndarray, lengths: np.ndarray, p: Params,
               matching: bool, device) -> list[np.ndarray]:
    """The rows of one batch that each shard must extend: every row in
    matching mode, else the rescue candidates (what the SW's work is
    counted over)."""
    b = _Batch(torch.from_numpy(np.where(codes < 4, codes, 0).astype(np.uint8)).to(device),
               torch.from_numpy(np.asarray(lengths, np.int32)).to(device), codes.shape[1])
    _vote(index, b, p, matching, torch.float32)
    return [sh.ext_rows.cpu().numpy() for sh in b.shards]


def count_reads(status, acc_id, mlen, lengths, n_accessions: int, mode: str) -> np.ndarray:
    """Per-accession counts of one batch: basic 1, query_length the read
    length, matching mlen, for each MAPPED read."""
    mapped = status == MAPPED
    value = {"basic": np.ones_like(lengths), "query_length": lengths,
             "matching": mlen}[mode].astype(np.int64)
    return np.bincount(acc_id[mapped], weights=value[mapped],
                       minlength=n_accessions).astype(np.int64)

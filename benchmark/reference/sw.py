"""The plain banded Smith-Waterman of the reference, in numpy on the host.

The port's DP (``ops/extend.py`` ``banded_sw_torch``), row for row: row
i pairs read base i with ``refwin[i : i + W]``; match +2, mismatch -4,
linear gap -4; the in-row gap a windowed prefix max over min(16, W)
lanes by doubling passes; local (floor 0).  Two forms, as in the port:
the packed state ``score << mbits | mlen`` for buckets where it fits
int32 (ties go to the larger mlen) and the pair state beyond (the
rightmost best lane's mlen, the first row that reaches the best).

The reads are taken longest first and row i updates only the reads
longer than i: a read's result is fixed once its rows are done, so this
gives what running every read to the bucket length gives, in the work
the reads need.  The packed form's result does not depend on mbits as
long as every mlen fits it, so one call serves every packed bucket.
"""

from __future__ import annotations

import numpy as np

NEG = -(1 << 20)
NEG16 = -(1 << 14)
MATCH, MISMATCH, GAP, MAX_GAP = 2, 4, 4, 16


def packed_mbits(L: int, band: int) -> int:
    """mlen bit width for reads up to L, or 0 when (score, mlen) does not
    fit one int32 (the pair state then runs)."""
    mbits = max(int(np.ceil(np.log2(L + 1))), 1)
    score_max = MATCH * L + GAP * band + 1
    return mbits if (score_max << mbits) + L < (1 << 31) else 0


def _active(lengths: np.ndarray) -> np.ndarray:
    """Reads sorted longest first: how many are longer than each row."""
    L = int(lengths.max()) if len(lengths) else 0
    return np.searchsorted(-lengths, -np.arange(L), side="left")


def _shl1(x, fill):
    out = np.empty_like(x)
    out[:, :-1] = x[:, 1:]
    out[:, -1] = fill
    return out


def _shr(x, s, fill):
    out = np.empty_like(x)
    out[:, :s] = fill
    out[:, s:] = x[:, :-s]
    return out


def _packed(q, rw, lengths, W, mbits):
    n = len(lengths)
    scale = 1 << mbits
    reach = min(MAX_GAP, W)
    lane_gp = (np.arange(W, dtype=np.int32) * (GAP << mbits)).astype(np.int32)
    P = np.zeros((n, W), np.int32)
    best = np.zeros(n, np.int32)
    d_match = np.int32((MATCH + MISMATCH) * scale + 1)
    for i, a in enumerate(_active(lengths)):
        Pa = P[:a]
        qc = q[:a, i: i + 1]
        hit = (qc == rw[:a, i: i + W]) & (qc < 4)
        cand_d = Pa + hit * d_match - np.int32(MISMATCH * scale)
        cand_u = _shl1(Pa, NEG) - np.int32(GAP * scale)
        t = np.maximum(np.maximum(cand_u, cand_d), 0)
        u = t + lane_gp
        s = 1
        while s < reach:
            u = np.maximum(u, _shr(u, s, NEG))
            s *= 2
        Pa = np.maximum(u - lane_gp, t)
        P[:a] = Pa
        best[:a] = np.maximum(best[:a], Pa.max(1))
    return best >> mbits, best & (scale - 1)


def _pair(q, rw, lengths, W, dt, neg):
    n = len(lengths)
    reach = min(MAX_GAP, W)
    lane_g = (np.arange(W) * GAP).astype(dt)
    h = np.zeros((n, W), dt)
    m = np.zeros((n, W), dt)
    best = np.zeros(n, dt)
    bm = np.zeros(n, dt)
    for i, a in enumerate(_active(lengths)):
        ha, ma = h[:a], m[:a]
        qc = q[:a, i: i + 1]
        im = ((qc == rw[:a, i: i + W]) & (qc < 4)).astype(dt)
        cand_d = ha + im * dt(MATCH + MISMATCH) - dt(MISMATCH)
        md = ma + im
        cand_u = _shl1(ha, neg) - dt(GAP)
        mu = _shl1(ma, 0)
        up = cand_u > cand_d
        t = np.where(up, cand_u, cand_d)
        mt = np.where(up, mu, md)
        zero = t < 0
        t[zero] = 0
        mt[zero] = 0
        u, mh = t + lane_g, mt
        s = 1
        while s < reach:
            pu, pm = _shr(u, s, neg), _shr(mh, s, 0)
            take = pu > u
            u = np.where(take, pu, u)
            mh = np.where(take, pm, mh)
            s *= 2
        hz = u - lane_g
        hor = hz > t
        ha = np.where(hor, hz, t)
        ma = np.where(hor, mh, mt)
        rb = ha.max(1)
        rm = np.where(ha == rb[:, None], ma, 0).max(1)
        better = rb > best[:a]
        best[:a] = np.where(better, rb, best[:a])
        bm[:a] = np.where(better, rm, bm[:a])
        h[:a], m[:a] = ha, ma
    return best.astype(np.int32), bm.astype(np.int32)


def banded_sw(q: np.ndarray, refwin: np.ndarray, lengths: np.ndarray, band: int,
              bucket_len: int, int16: bool = False):
    """(score, mlen) int32 of each read: q (n, >= len) uint8 read codes
    (PAD past the length), refwin (n, >= len + band) uint8, lengths (n,).
    ``bucket_len`` picks the form as the port does (packed where
    ``packed_mbits`` allows).  ``int16`` runs the pair state in 16-bit
    arithmetic (the control)."""
    n = len(lengths)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    lengths = np.asarray(lengths, np.int64)
    order = np.argsort(-lengths, kind="stable")
    q, rw, ln = q[order], refwin[order], lengths[order]
    mbits = packed_mbits(bucket_len, band)
    if int16:
        score, mlen = _pair(q, rw, ln, band, np.int16, NEG16)
    elif mbits:
        score, mlen = _packed(q, rw, ln, band, mbits)
    else:
        score, mlen = _pair(q, rw, ln, band, np.int32, NEG)
    out_s = np.empty(n, np.int32)
    out_m = np.empty(n, np.int32)
    out_s[order], out_m[order] = score, mlen
    return out_s, out_m

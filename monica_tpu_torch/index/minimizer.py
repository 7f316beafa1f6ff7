"""Read sketching on torch tensors — counterpart of
``monica_tpu/index/minimizer.py`` (``kmer_hashes``,
``select_minimizers``, ``sketch_reads_jax``).

Same algorithm and bit-identical output: 2-bit rolling k-mers on both
strands by log-composition, canonical = min(fwd, rc), murmur3
finalizer, winnowing by shifted min/max passes.  Hashes are unsigned
32-bit values held in int64 (:mod:`monica_tpu_torch._u32`).

The host index build runs the same functions on CPU tensors.
"""

from __future__ import annotations

import torch

from monica_tpu_torch._u32 import MASK32, mul32

# minimap2's map-ont preset (k=15, w=10) and classic winnowing
K_DEFAULT = 15
W_DEFAULT = 10
FRAC_DEFAULT = 1.0

INVALID_HASH = MASK32


def frac_threshold(frac: float) -> int:
    """Largest hash kept under scaled winnowing (inclusive)."""
    return min(max(int(frac * 4294967296.0), 1), 0xFFFFFFFE)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer on int64-held u32 values."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _shift_fill(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x shifted left by s along the last axis (x[i] := x[i+s]), tail
    filled; a shift past the width gives an all-fill tensor."""
    if s == 0:
        return x
    if s >= x.shape[-1]:
        return torch.full_like(x, fill)
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def _windowed(x: torch.Tensor, w: int, fill, op) -> torch.Tensor:
    """op-reduction over forward windows: out[i] = op(x[i..i+w-1])."""
    p2 = 1
    while p2 * 2 <= w:
        p2 *= 2
    a = x
    s = 1
    while s < p2:
        a = op(a, _shift_fill(a, s, fill))
        s *= 2
    if w != p2:
        a = op(a, _shift_fill(a, w - p2, fill))
    return a


def kmer_hashes(codes: torch.Tensor, k: int = K_DEFAULT):
    """Canonical k-mer hashes at every position.

    codes: (..., n) uint8.  Returns (hashes int64 u32-valued, strands
    bool), each (..., n-k+1); strand True where the reverse complement
    is canonical.  Non-ACGT and strand-symmetric k-mers hash to
    INVALID_HASH.  k <= 16 keeps every k-mer value below 2^32."""
    n = codes.shape[-1]
    m = n - k + 1
    if m <= 0:
        raise ValueError(f"sequence shorter than k={k}")
    c = codes.to(torch.int64)
    fw = c & 3
    rv = (3 - fw) & 3
    bd = c >= 4
    blocks = {1: (fw, rv, bd)}
    width = 1
    while width * 2 <= k:
        sh = 2 * width
        fw2 = (fw << sh) | _shift_fill(fw, width, 0)
        rv2 = (_shift_fill(rv, width, 0) << sh) | rv
        bd2 = bd | _shift_fill(bd, width, True)
        width *= 2
        fw, rv, bd = fw2, rv2, bd2
        blocks[width] = (fw, rv, bd)
    fwd = rc = bad = None
    off = 0
    for p in sorted((1 << b for b in range(k.bit_length()) if (k >> b) & 1),
                    reverse=True):
        fp, rp, bp = blocks[p]
        fseg = _shift_fill(fp, off, 0)
        rseg = _shift_fill(rp, off, 0)
        bseg = _shift_fill(bp, off, True)
        if fwd is None:
            fwd, rc, bad = fseg, rseg, bseg
        else:
            fwd = (fwd << (2 * p)) | fseg
            rc = (rseg << (2 * off)) | rc
            bad = bad | bseg
        off += p
    fwd, rc, bad = fwd[..., :m], rc[..., :m], bad[..., :m]
    strand = rc < fwd
    h = fmix32(torch.minimum(fwd, rc))
    h = torch.where(bad | (fwd == rc), INVALID_HASH, h)
    return h, strand


def select_minimizers(hashes: torch.Tensor, w: int = W_DEFAULT,
                      frac: float = FRAC_DEFAULT) -> torch.Tensor:
    """Winnowing keep-mask over (..., m) hashes; ``frac < 1`` also
    keeps only hashes <= frac * 2^32 (scaled winnowing)."""
    mins = _windowed(hashes, w, INVALID_HASH, torch.minimum)
    pad = torch.zeros(hashes.shape[:-1] + (w - 1,), dtype=hashes.dtype,
                      device=hashes.device)
    mins_r = torch.cat([pad, mins], dim=-1)
    maxs = _windowed(mins_r, w, 0, torch.maximum)[..., : hashes.shape[-1]]
    keep = (maxs == hashes) & (hashes != INVALID_HASH)
    if frac < 1.0:
        keep = keep & (hashes <= frac_threshold(frac))
    return keep


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST minimum along the last axis (jnp.argmin's
    tie rule), independent of the backend's argmin tie behaviour."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    lo = x.min(dim=-1, keepdim=True).values
    return torch.where(x == lo, iota, n).min(dim=-1).values


def sketch_reads(codes: torch.Tensor, n_slots: int, k: int = K_DEFAULT,
                 w: int = W_DEFAULT, frac: float = FRAC_DEFAULT):
    """Sketch a (B, L) uint8 read batch into ``n_slots`` positional
    minimizer slots -> (hash int64, pos int32, strand bool, valid bool),
    each (B, n_slots).

    Slot j takes the smallest hash of segment j (segments of
    ceil(m/n_slots) k-mer positions), first occurrence on ties.  As in
    the reference, when every segment spans at least a w-window and
    frac == 1 the winnowing mask is skipped (the segment argmin is a
    window minimum anyway), so only true tail segments shortened below
    w can select a non-winnowed position; and the reported position is
    clamped to m-1.  The reference computes the per-segment argmin with
    shifted min-select passes; a reshape + first-occurrence argmin
    selects the same (hash, pos, strand)."""
    h, s = kmer_hashes(codes, k)
    B, m = h.shape
    seg = -(-m // n_slots)
    pad_to = seg * n_slots
    pad = pad_to - m
    if seg >= w and frac >= 1.0:
        key = h
    else:
        keep = select_minimizers(h, w, frac=frac)
        key = torch.where(keep, h, INVALID_HASH)
    st = s
    if pad:
        key = torch.cat(
            [key, torch.full((B, pad), INVALID_HASH, dtype=key.dtype, device=key.device)],
            dim=-1,
        )
        st = torch.cat(
            [st, torch.zeros((B, pad), dtype=st.dtype, device=st.device)], dim=-1
        )
    key = key.reshape(B, n_slots, seg)
    j = first_argmin(key)  # (B, n_slots) offset within the segment
    hh = torch.gather(key, 2, j[..., None])[..., 0]
    ss = torch.gather(st.reshape(B, n_slots, seg), 2, j[..., None])[..., 0]
    base = torch.arange(n_slots, device=codes.device) * seg
    pos = torch.clamp(base[None, :] + j, max=m - 1).to(torch.int32)
    return hh, pos, ss, hh != INVALID_HASH

"""Banded Smith–Waterman extension — counterpart of
``monica_tpu/ops/extend.py``.

Host side (window extraction, orientation, NM estimate) in torch, and
the DP itself in two forms that compute the same function:

* :func:`banded_sw_torch`, the plain PyTorch version: one row of tensor
  ops per read base, exactly the reference's ``banded_sw_jnp`` (packed
  branch and pair-state branch);
* the hand-written CUDA kernels in ``csrc/banded_sw.cu``, bound by
  :mod:`monica_tpu_torch.ops._native`.

:func:`banded_sw` dispatches on the tensors' device: a CPU tensor takes
the plain version, a CUDA tensor the kernel.  Nothing falls back.

DP geometry (shared by every form): row i pairs read base i with
``refwin[i : i + W]``; scoring is match +2, mismatch -4, linear gap -4;
the in-row horizontal gap term is a windowed prefix max over
``reach = min(max_gap, W)`` lanes computed by doubling passes
s = 1, 2, 4, ... with NEG fill; the alignment is local (floor at 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -(1 << 20)  # -inf for int32 DP without overflow


class ExtendParams(NamedTuple):
    band: int = 128  # band width W (the CUDA kernels take 64 or 128)
    match: int = 2
    mismatch: int = 4  # positive penalty
    gap: int = 4  # positive linear gap penalty
    max_gap: int = 16  # horizontal reach per row in lanes (0 = full band)


def _gap_reach(width: int, max_gap: int) -> int:
    """Horizontal prefix-max reach in lanes (0 = exact/full band)."""
    return width if max_gap <= 0 else min(max_gap, width)


def packed_mbits(L: int, p: ExtendParams) -> int:
    """mlen bit width for reads of length <= L, or 0 if the packed DP
    cannot hold (score, mlen) for this length/scoring in int32."""
    mbits = max(int(np.ceil(np.log2(L + 1))), 1)
    score_max = p.match * L + p.gap * p.band + 1  # + lane_g headroom
    if (score_max << mbits) + L < (1 << 31):
        return mbits
    return 0


def extract_ref_windows(ref_codes: torch.Tensor, diag: torch.Tensor, L: int,
                        band: int) -> torch.Tensor:
    """refwin[b, p] = ref[diag[b] - band//2 + p], p in [0, L + band),
    with the start clamped to [0, max(T - (L + band), 0)] as the
    reference's CLIP gather does."""
    T = ref_codes.shape[0]
    start = torch.clamp(diag.to(torch.int64) - band // 2, 0, max(T - (L + band), 0))
    offs = torch.arange(L + band, device=ref_codes.device)
    return ref_codes[start[:, None] + offs[None, :]]


# ---------------------------------------------------------------------------
# plain PyTorch DP (the CPU path and the kernels' comparison reference)
# ---------------------------------------------------------------------------

def _shift_right(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """out[..., d] = x[..., d - s] for d >= s, else ``fill``."""
    out = torch.full_like(x, fill)
    out[..., s:] = x[..., :-s]
    return out


def _shift_left1(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[..., d] = x[..., d + 1], last lane ``fill`` (the up move)."""
    out = torch.full_like(x, fill)
    out[..., :-1] = x[..., 1:]
    return out


def _row_update(h, m, qcol, rrow, lane_g, p: ExtendParams, reach: int):
    """One pair-state DP row (reference ``_row_update``)."""
    is_match = ((qcol == rrow) & (qcol < 4)).to(torch.int32)
    cand_d = h + is_match * (p.match + p.mismatch) - p.mismatch
    md = m + is_match
    cand_u = _shift_left1(h, NEG) - p.gap
    mu = _shift_left1(m, 0)
    up = cand_u > cand_d
    t = torch.where(up, cand_u, cand_d)
    mt = torch.where(up, mu, md)
    zero = t < 0
    t = torch.where(zero, 0, t)
    mt = torch.where(zero, 0, mt)
    u, mh = t + lane_g, mt
    s = 1
    while s < reach:
        pu = _shift_right(u, s, NEG)
        pm = _shift_right(mh, s, 0)
        take = pu > u
        u = torch.where(take, pu, u)
        mh = torch.where(take, pm, mh)
        s *= 2
    hz = u - lane_g
    hor = hz > t
    return torch.where(hor, hz, t), torch.where(hor, mh, mt)


def _row_update_packed(P, qcol, rrow, lane_gp, p: ExtendParams, mbits: int,
                       reach: int):
    """One packed-state row, P = score << mbits | mlen (reference
    ``_row_update_packed``)."""
    scale = 1 << mbits
    is_match = ((qcol == rrow) & (qcol < 4)).to(torch.int32)
    # substitution: score += match or -mismatch, mlen += is_match
    cand_d = P + is_match * ((p.match + p.mismatch) * scale + 1) - p.mismatch * scale
    cand_u = _shift_left1(P, NEG) - p.gap * scale
    t = torch.clamp(torch.maximum(cand_u, cand_d), min=0)
    u = t + lane_gp
    s = 1
    while s < reach:
        u = torch.maximum(u, _shift_right(u, s, NEG))
        s *= 2
    return torch.maximum(u - lane_gp, t)


def banded_sw_torch(q: torch.Tensor, refwin: torch.Tensor, lengths: torch.Tensor,
                    p: ExtendParams):
    """q (B, L) uint8; refwin (B, L+W) uint8; lengths (B,) int32 ->
    (best_score, best_mlen) int32 (B,).  Packed-state DP whenever
    (score, mlen) fits int32 (reads up to ~16 kb), pair-state beyond:
    the reference's ``banded_sw_jnp``, row for row."""
    B, L = q.shape
    W = p.band
    dev = q.device
    reach = _gap_reach(W, p.max_gap)
    qi = q.to(torch.int32)
    ri = refwin.to(torch.int32)
    lengths = lengths.to(torch.int32)
    mbits = packed_mbits(L, p)
    lane = torch.arange(W, dtype=torch.int32, device=dev)
    if mbits:
        lane_gp = lane * (p.gap << mbits)
        P = torch.zeros((B, W), dtype=torch.int32, device=dev)
        best = torch.zeros((B,), dtype=torch.int32, device=dev)
        for i in range(L):
            P = _row_update_packed(P, qi[:, i : i + 1], ri[:, i : i + W], lane_gp,
                                   p, mbits, reach)
            rb = P.max(dim=-1).values
            best = torch.where(i < lengths, torch.maximum(rb, best), best)
        return best >> mbits, best & ((1 << mbits) - 1)

    lane_g = lane * p.gap
    h = torch.zeros((B, W), dtype=torch.int32, device=dev)
    m = torch.zeros_like(h)
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    bm = torch.zeros_like(best)
    for i in range(L):
        h, m = _row_update(h, m, qi[:, i : i + 1], ri[:, i : i + W], lane_g, p, reach)
        rb = h.max(dim=-1).values
        rm = torch.where(h == rb[:, None], m, 0).max(dim=-1).values
        better = (i < lengths) & (rb > best)
        best = torch.where(better, rb, best)
        bm = torch.where(better, rm, bm)
    return best, bm


def banded_sw(q: torch.Tensor, refwin: torch.Tensor, lengths: torch.Tensor,
              p: ExtendParams, impl: str = "auto"):
    """Dispatch the banded SW.

    ``auto``: a CUDA tensor launches the kernel, a CPU tensor runs the
    plain version.  ``cuda``: the kernel (raises on a CPU tensor).
    ``torch``: the plain version on whatever device the tensors are."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "cuda":
        from monica_tpu_torch.ops import _native

        return _native.banded_sw_cuda(q, refwin, lengths, p)
    if impl == "torch":
        return banded_sw_torch(q, refwin, lengths, p)
    raise ValueError(f"unknown banded_sw impl {impl!r} (auto | torch | cuda)")


class Extension(NamedTuple):
    score: torch.Tensor  # (B,) int32 best local score
    mlen: torch.Tensor  # (B,) int32 matched bases on the optimal path
    nm: torch.Tensor  # (B,) int32 edit-distance estimate
    inv_identity: torch.Tensor  # (B,) f32 NM/mlen


def extend_hits(ref_codes, codes, lengths, rep_ref_pos, rep_read_pos, rc,
                k: int, p: ExtendParams, impl: str = "auto") -> Extension:
    """Banded extension of each read at its chained locus (reference
    ``extend_hits``).  The read is never reoriented: for rc anchors the
    reference window is taken on the anti-diagonal, flipped and
    complemented, so row i always pairs read base i with
    window[i + band/2]."""
    B, L = codes.shape
    W = p.band
    i = torch.arange(L, device=codes.device)[None, :]
    q = torch.where(i < lengths[:, None], codes, 4).to(torch.uint8)

    fwd_start = rep_ref_pos - rep_read_pos - W // 2
    anti = rep_ref_pos + rep_read_pos + (k - 1)
    rc_start = anti - (L - 1) - W // 2
    start = torch.where(rc, rc_start, fwd_start)
    refwin = extract_ref_windows(ref_codes, start + W // 2, L, W)
    flipped = torch.flip(refwin, dims=(-1,))
    comp = torch.where(flipped < 4, 3 - flipped, flipped).to(torch.uint8)
    refwin = torch.where(rc[:, None], comp, refwin).contiguous()
    score, mlen = banded_sw(q.contiguous(), refwin, lengths.to(torch.int32).contiguous(),
                            p, impl=impl)
    denom = max(min(p.mismatch, p.gap), 1)
    nm = torch.clamp(torch.div(p.match * mlen - score, denom, rounding_mode="floor"), min=0)
    inv_identity = nm.to(torch.float32) / torch.clamp(mlen, min=1).to(torch.float32)
    return Extension(score=score, mlen=mlen, nm=nm, inv_identity=inv_identity)

"""Chain scoring by diagonal voting — counterpart of
``monica_tpu/ops/chain.py``.

Anchors sharing a (strand, diagonal-bin) key are co-linear, so the vote
count of a bin (merged with bin+1) is a gapless-chain score.  The
reference sorts with a bitonic network on the TPU; here ``torch.sort``
does the row sort.  Every argmax/argmin takes the FIRST occurrence on
ties, as jnp's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monica_tpu_torch.index.minimizer import first_argmin
from monica_tpu_torch.ops.lookup import INVALID_KEY


class ChainResult(NamedTuple):
    f1: torch.Tensor  # (B,) int32 best merged-bin vote count (0 = no anchors)
    f2: torch.Tensor  # (B,) int32 runner-up votes outside the best locus
    best_key: torch.Tensor  # (B,) int32 packed (strand, diag bin)
    rep_diag: torch.Tensor  # (B,) int32 representative unquantized diagonal
    rep_read_pos: torch.Tensor  # (B,) int32
    rep_ref_pos: torch.Tensor  # (B,) int32
    rc: torch.Tensor  # (B,) bool reverse-complement mapping
    rep2_ref_pos: torch.Tensor  # (B,) int32 runner-up locus anchor


def _pair_votes(skeys: torch.Tensor, max_run: int) -> torch.Tensor:
    """Merged-pair votes on row-sorted keys (B, A): merged[i] = length,
    capped at min(max_run, A), of the stretch starting at i whose keys
    are in {skeys[i], skeys[i]+1}.

    The reference builds it from max_run-1 shifted prefix-AND passes.
    On a sorted row the stretch is exactly [i, upper_bound(skeys[i]+1)),
    so one batched binary search gives the same counts."""
    A = skeys.shape[-1]
    end = torch.searchsorted(skeys, skeys + 1, right=True)
    i = torch.arange(A, device=skeys.device)
    return torch.clamp(end - i, max=min(max_run, A)).to(torch.int32)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    return first_argmin(-x.to(torch.int64))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, i[:, None])[:, 0]


def chain_votes(key, diag, read_pos, ref_pos, max_run: int = 64) -> ChainResult:
    """Vote over anchor keys; all inputs (B, A) int32 from lookup_anchors."""
    skeys = torch.sort(key, dim=-1).values
    valid = skeys != INVALID_KEY
    merged = torch.where(valid, _pair_votes(skeys, max_run), 0)

    best_i = _first_argmax(merged)
    f1 = _take(merged, best_i)
    best_key = _take(skeys, best_i)

    far = valid & ((skeys - best_key[:, None]).abs() > 1)
    f2m = torch.where(far, merged, 0)
    f2_i = _first_argmax(f2m)
    f2 = _take(f2m, f2_i)
    second_key = _take(skeys, f2_i)

    big = 1 << 30

    def rep_of(k):
        in_locus = (key == k[:, None]) | (key == k[:, None] + 1)
        i = first_argmin(torch.where(in_locus, read_pos, big))
        return _take(diag, i), _take(read_pos, i), _take(ref_pos, i)

    rep_diag, rep_read_pos, rep_ref_pos = rep_of(best_key)
    _, _, rep2_ref_pos = rep_of(second_key)
    rc = (best_key >> 24) > 0
    return ChainResult(
        f1=f1, f2=f2, best_key=best_key, rep_diag=rep_diag,
        rep_read_pos=rep_read_pos, rep_ref_pos=rep_ref_pos, rc=rc,
        rep2_ref_pos=rep2_ref_pos,
    )


def mapq_from_votes(f1, f2, scale: float = 40.0, cap: float = 60.0,
                    anchor_bases: float = 15.0) -> torch.Tensor:
    """mapq = 40·(1 - f2/f1)·min(1, f1/10)·ln(15·f1), clamped to
    [0, cap], in float32 (reference ``mapq_from_votes``)."""
    f1f = f1.to(torch.float32)
    f2f = f2.to(torch.float32)
    safe_f1 = torch.clamp(f1f, min=1.0)
    q = (
        scale
        * (1.0 - f2f / safe_f1)
        * torch.clamp(f1f / 10.0, max=1.0)
        * torch.log(safe_f1 * anchor_bases)
    )
    q = torch.where(f1 > 0, q, 0.0)
    return torch.clamp(q, 0.0, cap)

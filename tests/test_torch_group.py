"""The batched step over a stacked size-class group
(``pipeline.classify_group``: one lookup, one chain, one rescue tier
over the pool of S·B (shard, read) rows, one SW call) against a loop of
one-shard steps (``classify_group`` on a stack of one) on slices of the
same stack, field by field for every ShardHit field.

Each shard holds one copy of a base genome (1% substitutions, rotated,
shortened by 97 bases a shard, so the stack pads the shorter ones), so
every read has a locus in every shard.  The read error sets how many
(shard, read) rows fail the vote gate, and with it the pool's tier.
Each batch also carries reads at the first and last bases of the first
and last shard of the stack, forward and reverse complement, whose
reference windows the per-shard clamp pulls inside their shard before
the ``s·T`` offset into the flattened stack."""

import numpy as np
import pytest
import torch

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.ops import extend as ex
from monica_tpu_torch.ops import lookup as lk

torch.set_num_threads(1)

G, N_SHARDS, B, L, END = 6000, 8, 48, 512, 300


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, G).astype(np.uint8)
    seqs = []
    for s in range(N_SHARDS):
        g = base.copy()
        m = rng.random(G) < 0.01
        g[m] = (g[m] + rng.integers(1, 4, m.sum())) % 4
        seqs.append(np.roll(g, -int(rng.integers(0, G)))[: G - 97 * s])
    built = build_index_from_arrays(seqs, n_shards=N_SHARDS, device="cpu")
    # one genome a shard, shard s holding seqs[s]
    assert [int(sh.seq_accession_id[0]) for sh in built.shards] == list(range(N_SHARDS))
    tag_bits = lk.tag_bits_for(max(len(sh.ref_codes) for sh in built.shards))
    return dict(base=base, seqs=seqs, shards=built.shards, tag_bits=tag_bits)


def _batch(world, S, err, seed):
    """B reads of 250-512 bp from the base genome at ``err``, the first
    eight replaced by reads of the first and last END bases of shards 0
    and S-1."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    ends = [(world["seqs"][s], at, rc) for s in (0, S - 1) for at in ("first", "last")
            for rc in (False, True)]
    for i in range(B):
        if i < len(ends):
            g, at, rc = ends[i]
            g = g[:END] if at == "first" else g[-END:]
            r = ev.simulate_read_codes(rng, g, END, err / 2, err / 4, err / 4, rc)
        else:
            n = int(rng.integers(250, L + 1))
            r = ev.simulate_read_codes(rng, world["base"], n, err / 2, err / 4, err / 4,
                                       bool(i & 1))
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return torch.from_numpy(codes), torch.from_numpy(lengths)


# (extend_mode, read error, the pool's tier as a divisor of S·B)
CASES = [("rescue", 0.11, 8), ("rescue", 0.14, 2), ("rescue", 0.20, 1), ("full", 0.14, 1)]


@pytest.mark.parametrize("mode,err,tier", CASES)
@pytest.mark.parametrize("S", [1, 3, 8])
def test_group_step_equals_one_shard_steps(world, monkeypatch, S, mode, err, tier):
    group = pl.stack_device_shards(world["shards"][:S], "cpu", world["tag_bits"])
    params = pl.ClassifyParams(tag_bits=world["tag_bits"], extend_mode=mode)
    codes, lengths = _batch(world, S, err, seed=100 * S + int(100 * err))
    rows = []
    real = ex.extend_hits

    def spy(ref_codes, codes, *a, **kw):
        rows.append(codes.shape[0])
        return real(ref_codes, codes, *a, **kw)

    monkeypatch.setattr(ex, "extend_hits", spy)
    got = pl.classify_group(group, codes, lengths, params)
    # one SW call a group, on the pool's tier (full: every row)
    N = S * B
    assert rows == [int(N * params.rescue_frac) if tier == 8 else N // tier]
    want = [pl.classify_group(pl.DeviceIndexShard(*(t[s : s + 1] for t in group)),
                              codes, lengths, params) for s in range(S)]
    for f in pl.ShardHit._fields:
        a, b = getattr(got, f), torch.cat([getattr(w, f) for w in want])
        assert a.shape == (S, B) and a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    if tier < 8:  # the SW's answers are used in every shard, the end reads' too
        vote_passed = (got.mapq >= params.mapping_quality) & (got.votes >= params.min_votes)
        by_sw = got.passed & ~vote_passed if mode == "rescue" else got.passed
        assert by_sw.any(dim=1).all()
        assert by_sw[:, :8].any()


@pytest.mark.parametrize("mode", ["rescue", "full"])
def test_group_step_in_chunks_equals_one_pass(world, monkeypatch, mode):
    """A stack too large for one lookup (3 shards a chunk) or one SW call
    (40 rows a call) gives the answers of one pass."""
    S = N_SHARDS
    group = pl.stack_device_shards(world["shards"], "cpu", world["tag_bits"])
    params = pl.ClassifyParams(tag_bits=world["tag_bits"], extend_mode=mode)
    codes, lengths = _batch(world, S, 0.14, seed=7)
    whole = pl.classify_group(group, codes, lengths, params)
    rows = []
    real = ex.extend_hits

    def spy(ref_codes, codes, *a, **kw):
        rows.append(codes.shape[0])
        return real(ref_codes, codes, *a, **kw)

    monkeypatch.setattr(ex, "extend_hits", spy)
    monkeypatch.setattr(pl, "LOOKUP_ENTRIES", 3 * B * params.n_slots * lk.ROW_SLOTS)
    monkeypatch.setattr(pl, "SW_WINDOW_BASES", 40 * (L + params.band))
    chunked = pl.classify_group(group, codes, lengths, params)
    n = S * B if mode == "full" else S * B // 2
    assert rows == [40] * (n // 40) + [n % 40]
    for f in pl.ShardHit._fields:
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f

"""The port's multi-shard step against the JAX package on CPU: the
cross-shard merge bit-equal on identical ShardHit stacks, the stacked
size-class groups bit-equal to the JAX arrays, and classify_batch_grouped
on the very same stacked index.

Tolerances of the grouped step (those of tests/test_torch_pipeline.py):
status, acc_id and counts bit-equal; mlen within 1 (the vote estimate,
float log/exp ulps before the int truncation); mapq and inv_identity
within rtol 1e-5, atol 1e-6.  No read may sit within 1e-4 of the mapq
gate, so the status comparison has no exemptions.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ref_ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu_torch import convert
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.evaluation import SHARD_HIT_DTYPES, random_shard_hits
from monica_tpu_torch.stats.abundance import AbundanceState, normalize
from tests.test_reference_golden import REF_ALIGNER, _load_reference_functions

torch.set_num_threads(1)


def _both(fields: dict):
    """One ShardHit stack as the JAX package's and as the port's."""
    arrs = {f: np.asarray(fields[f], SHARD_HIT_DTYPES[f]) for f in ref_pl.ShardHit._fields}
    return (ref_pl.ShardHit(**{f: jnp.asarray(a) for f, a in arrs.items()}),
            pl.ShardHit(**{f: torch.from_numpy(a.copy()) for f, a in arrs.items()}))


# merge_hits as the JAX package runs it: inside jit, where XLA contracts
# the cost band's multiply-add into one FMA (called eagerly, it rounds
# twice and differs on the band edge)
ref_merge = jax.jit(ref_pl.merge_hits, static_argnums=(1, 2))


@pytest.mark.parametrize("bands", [(0.10, 1.0), (0.0, 0.0), (0.10, 0.0), (0.0, 2.0)])
@pytest.mark.parametrize("S", [2, 3, 4, 5, 6])
def test_merge_hits_bit_equal(S, bands):
    tol, sd = bands
    rng = np.random.default_rng(100 * S + int(10 * tol + sd))
    ref_hits, hits = _both(random_shard_hits(rng, S, 4000, tol, sd))
    want = ref_merge(ref_hits, tol, sd)
    got = pl.merge_hits(hits, tol, sd)
    for f in ref_pl.ReadResult._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    st = got.status.numpy()
    assert (st == pl.AMBIGUOUS).sum() > 100 and (st == pl.MAPPED).sum() > 100


def test_merge_takes_the_first_of_exactly_tied_shards():
    """Equal merge_cost on the same accession: the first shard wins, and
    its own fields are reported."""
    S, B = 4, 3
    f = dict(acc_id=np.full((S, B), 2), inv_identity=np.arange(S * B).reshape(S, B) / 100,
             merge_cost=np.full((S, B), 0.05), mlen=np.arange(S * B).reshape(S, B) + 100,
             mapq=np.full((S, B), 60.0), votes=np.full((S, B), 30), passed=np.ones((S, B)),
             rc=np.zeros((S, B)), ref_pos=np.zeros((S, B)), tied=np.zeros((S, B)))
    f["passed"][0, 1] = False  # read 1: shard 1 is the first passing one
    ref_hits, hits = _both(f)
    got = pl.merge_hits(hits)
    assert got.status.tolist() == [pl.MAPPED] * 3
    assert got.mlen.tolist() == [100, 104, 102]
    np.testing.assert_array_equal(np.asarray(ref_merge(ref_hits, 0.1, 1.0).mlen), got.mlen.numpy())


@pytest.fixture(scope="module")
def skewed():
    """Four shards of a skewed split over two size classes: three of
    about 30 kb (2^15 class) and one of 60 kb (2^16 class).  Genome 3
    repeats a 3 kb block of genome 0, which lies in another shard."""
    rng = np.random.default_rng(41)
    seqs = [rng.integers(0, 4, n).astype(np.uint8)
            for n in (60_000, 30_000, 30_000, 15_000, 15_000)]
    seqs[3][5_000:8_000] = seqs[0][30_000:33_000]
    built = ref_build(seqs, max_shard_bytes=40_000)
    sizes = sorted(len(s.ref_codes) for s in built.shards)
    assert len(built.shards) == 4 and len({ref_pl._size_class(n) for n in sizes}) == 2
    groups, tag_bits = ref_pl.stack_device_shard_groups(built.shards)
    return dict(seqs=seqs, built=built, groups=groups, tag_bits=tag_bits)


def test_stacked_groups_bit_equal(skewed):
    port_built = convert.built_from_reference(skewed["built"])
    groups, tag_bits = pl.stack_device_shard_groups(port_built.shards, "cpu")
    assert tag_bits == skewed["tag_bits"]
    assert len(groups) == len(skewed["groups"]) == 2
    for g, rg in zip(groups, skewed["groups"]):
        np.testing.assert_array_equal(g.mz_rows.numpy().view(np.uint32), np.asarray(rg.mz_rows))
        np.testing.assert_array_equal(g.pos_acc.numpy(), np.asarray(rg.pos_acc).astype(np.int32))
        np.testing.assert_array_equal(g.ref_codes.numpy(), np.asarray(rg.ref_codes))
    assert [g.mz_rows.shape[0] for g in groups] == [3, 1]
    want = sum(np.asarray(a).nbytes for rg in skewed["groups"] for a in rg)
    pos_acc_widening = sum(np.asarray(rg.pos_acc).nbytes for rg in skewed["groups"])
    assert pl.stacked_nbytes(groups) == want + pos_acc_widening
    # the conversion of the JAX arrays gives the very same tensors
    for g, cg in zip(groups, convert.groups_from_reference(skewed["groups"], "cpu")):
        for a, b in zip(g, cg):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _reads(seqs, seed, B, L, error):
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(300, L + 1))
        if i < 4:  # the block shared across shards: an exact cross-shard tie
            r = seqs[0][30_000 : 30_000 + min(n, 3000)].copy()
        elif i < 7:
            r = rng.integers(0, 4, n).astype(np.uint8)
        else:
            r = ref_ev.simulate_read_codes(rng, seqs[i % len(seqs)], n, *error, bool(i & 1))
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return codes, lengths


@pytest.mark.parametrize("extend_mode,count_mode", [
    ("rescue", pl.MODE_QUERY_LENGTH), ("rescue", pl.MODE_BASIC), ("full", pl.MODE_MATCHING)])
def test_classify_batch_grouped_matches_reference(skewed, extend_mode, count_mode):
    n_acc = len(skewed["seqs"])
    codes, lengths = _reads(skewed["seqs"], 5, 48, 1024, (0.06, 0.03, 0.03))
    ref_params = ref_pl.params_for_bucket(ref_pl.ClassifyParams(
        tag_bits=skewed["tag_bits"], extend_impl="jnp", extend_mode=extend_mode), 1024)
    want, want_c = ref_pl.classify_batch_grouped(
        skewed["groups"], jnp.asarray(codes), jnp.asarray(lengths), ref_params, n_acc, count_mode)
    params = convert.params_from_reference(ref_params)
    groups = convert.groups_from_reference(skewed["groups"], "cpu")
    got, got_c = pl.classify_batch_grouped(groups, torch.from_numpy(codes),
                                           torch.from_numpy(lengths), params, n_acc, count_mode)
    mapq = np.asarray(want.mapq)
    assert not (np.abs(mapq - 60.0) < 1e-4).any() or (mapq[np.abs(mapq - 60) < 1e-4] == 60).all()
    w = {f: np.asarray(getattr(want, f)) for f in ref_pl.ReadResult._fields}
    g = {f: getattr(got, f).numpy() for f in pl.ReadResult._fields}
    for f in ("status", "acc_id", "rc"):
        np.testing.assert_array_equal(w[f], g[f], err_msg=f)
    np.testing.assert_allclose(g["mapq"], w["mapq"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g["inv_identity"], w["inv_identity"], rtol=1e-5, atol=1e-6)
    assert (np.abs(w["mlen"].astype(np.int64) - g["mlen"]) <= 1).all()
    if count_mode == pl.MODE_MATCHING:  # SW mlen on every read: exact
        np.testing.assert_array_equal(w["mlen"], g["mlen"])
    np.testing.assert_array_equal(np.asarray(want_c), got_c.numpy())
    st = g["status"]
    assert (st == pl.MAPPED).sum() > 30
    assert (st[:4] == pl.AMBIGUOUS).all() and (st == pl.UNMAPPED).sum() >= 1


def test_grouped_packed_entry_and_concat():
    """The 2-bit packed grouped entry against the JAX package's, on a
    three-shard index of one size class, and the whole-sample concat."""
    from monica_tpu_torch.io.encode import pack_codes_2bit

    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(3)]
    ref_built = ref_build(seqs, n_shards=3)
    ref_groups, tag_bits = ref_pl.stack_device_shard_groups(ref_built.shards)
    groups = convert.groups_from_reference(ref_groups, "cpu")
    codes, lengths = _reads(seqs, 9, 16, 512, (0.03, 0.01, 0.01))
    packed = pack_codes_2bit(codes)
    ref_params = ref_pl.ClassifyParams(tag_bits=tag_bits, extend_impl="jnp")
    want = ref_pl.classify_batch_grouped_packed(ref_groups, jnp.asarray(packed),
                                                jnp.asarray(lengths), 512, ref_params, 3)
    got = pl.classify_batch_grouped_packed(groups, torch.from_numpy(packed),
                                           torch.from_numpy(lengths), 512,
                                           convert.params_from_reference(ref_params), 3)
    for f in ("status", "acc_id"):
        np.testing.assert_array_equal(np.asarray(getattr(want[0], f)), getattr(got[0], f).numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert (got[0].status == pl.MAPPED).sum() > 8
    packs = [pl.pack_results(*got), pl.pack_results(got[0], got[1] * 2)]
    flat = pl.concat_packed(packs)
    ref = ref_pl.concat_packed(tuple(jnp.asarray(p.numpy()) for p in packs))
    np.testing.assert_array_equal(np.asarray(ref), flat.numpy())


# -- the reference's own best_hit / normalizer as oracles -------------------

@pytest.fixture
def reference_tree():
    if not REF_ALIGNER.exists():
        pytest.skip("reference tree not present")


def test_best_hit_oracle_against_port_merge(reference_tree):
    """The reference picks min NM/mlen, an exact tie at the minimum ->
    ambiguous; merge_hits with both bands off makes the same call."""
    (ref_best_hit,) = _load_reference_functions("best_hit")
    rng = np.random.default_rng(31)
    n_amb = 0
    for trial in range(300):
        S = int(rng.integers(2, 6))
        mlen = rng.integers(200, 1000, S)
        nm = rng.integers(0, 200, S)
        if trial % 3 == 0:
            nm[1], mlen[1] = nm[0], mlen[0]
        golden = ref_best_hit([(f"ctg{j}", int(nm[j]), int(mlen[j])) for j in range(S)])
        cost = nm.astype(np.float64) / mlen.astype(np.float64)
        col = lambda v: v[:, None]  # noqa: E731
        _, hits = _both(dict(
            acc_id=col(np.arange(S)), inv_identity=col(cost), merge_cost=col(cost),
            mlen=col(mlen), mapq=col(np.full(S, 60.0)), votes=col(np.full(S, 10)),
            passed=col(np.ones(S)), rc=col(np.zeros(S)), ref_pos=col(np.zeros(S)),
            tied=col(np.zeros(S))))
        res = pl.merge_hits(hits, tie_rel_tol=0.0, vote_tie_sd=0.0)
        status, acc = int(res.status[0]), int(res.acc_id[0])
        if golden == 0:
            assert status == pl.AMBIGUOUS
            n_amb += 1
        else:
            assert status == pl.MAPPED
            assert abs(cost[int(golden[0][3:])] - cost[acc]) < 1e-9
    assert n_amb > 30


def test_normalizer_oracle_against_port(reference_tree):
    (ref_normalizer,) = _load_reference_functions("normalizer")
    rng = np.random.default_rng(32)
    n_acc = 7
    accessions = [f"ACC{i}" for i in range(n_acc)]
    tax_units = [f"Sp_{i % 3}" for i in range(n_acc)]
    glens = rng.integers(10_000, 5_000_000, n_acc)
    state = AbundanceState(n_acc)
    alignment: dict = {}
    for sample in ("s1", "s2"):
        counts = rng.integers(0, 500, n_acc)
        counts[rng.integers(0, n_acc)] = 0
        state.update(sample, counts.astype(np.int64))
        alignment[sample] = {}
        for i in np.flatnonzero(counts):
            alignment[sample].setdefault(tax_units[i], Counter())[accessions[i]] = int(counts[i])
    golden = ref_normalizer(alignment, genomes_length=dict(zip(accessions, map(int, glens))))
    ours = normalize(state, glens.astype(np.int64))
    for sample in ("s1", "s2"):
        for i in range(n_acc):
            g = golden[sample].get(tax_units[i], {}).get(accessions[i])
            o = ours[sample][i]
            assert o == 0.0 if g is None else abs(g - o) < 1e-12 * max(abs(g), 1)

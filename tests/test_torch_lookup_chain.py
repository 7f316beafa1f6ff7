"""Seed lookup, chain voting and mapq in the PyTorch port against the
JAX reference on a small index: integers bit-equal, mapq within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu.ops import chain as ref_ch
from monica_tpu.ops import lookup as ref_lk
from monica_tpu_torch.ops import chain as ch
from monica_tpu_torch.ops import lookup as lk

torch.set_num_threads(1)

# the reference functions are traced once per static config (eager jnp
# dispatch of the vote passes is slow)
ref_pair_votes = jax.jit(ref_ch._pair_votes, static_argnums=1)
ref_chain_votes = jax.jit(ref_ch.chain_votes, static_argnames="max_run")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, 40_000).astype(np.uint8) for _ in range(3)]
    seqs[2][5000:9000] = seqs[0][5000:9000]  # a shared block -> runner-up loci
    built = ref_build(seqs)
    sh = built.shards[0]
    tag_bits = ref_lk.tag_bits_for(len(sh.ref_codes))
    table = ref_lk.build_hash_rows(sh.mz_hash, sh.mz_pos, sh.mz_strand, tag_bits)
    B, L = 24, 1024
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(200, L))
        r = ev.simulate_read_codes(rng, seqs[i % 3], n, 0.05, 0.03, 0.03, bool(i & 1))
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    codes[-1] = rng.integers(0, 4, L)  # an unrelated read
    params = ref_pl.params_for_bucket(ref_pl.ClassifyParams(tag_bits=tag_bits), L)
    sk = [np.asarray(x) for x in ref_pl.sketch_batch(jnp.asarray(codes), jnp.asarray(lengths), params)]
    return dict(table=table, tag_bits=tag_bits, L=L, sketch=sk, params=params)


def _port_sketch(sk):
    qh, qp, qs, qv = sk
    return tuple(torch.from_numpy(np.array(x)) for x in (qh.astype(np.int64), qp, qs, qv))


def _both_lookups(table, tag_bits, L, sk, aps):
    want = ref_lk.lookup_anchors(jnp.asarray(table), *map(jnp.asarray, sk),
                                 tag_bits=tag_bits, bucket_len=L, anchors_per_seed=aps)
    got = lk.lookup_anchors(torch.from_numpy(table.view(np.int32)), *_port_sketch(sk),
                            tag_bits=tag_bits, bucket_len=L, anchors_per_seed=aps)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("aps", [2, 4, 0])
def test_lookup_anchors_bit_equal(setup, aps):
    want, got = _both_lookups(setup["table"], setup["tag_bits"], setup["L"],
                              setup["sketch"], aps)
    for name, a, b in zip(("key", "diag", "read_pos", "ref_pos"), want, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (want[0] != ref_lk.INVALID_KEY).sum() > 100


def test_fixture_has_hits_with_top_bit_tags(setup):
    """The unsigned-sort trap needs real verified hits whose packed
    entry is >= 2^31; make sure the fixture holds them."""
    table, tb = setup["table"], setup["tag_bits"]
    qh, _, _, qv = setup["sketch"]
    rbits = int(np.log2(table.shape[0]))
    rows = table[(qh.astype(np.uint64) >> np.uint64(32 - rbits)).astype(np.int64)]
    tag = (qh & np.uint32((1 << tb) - 1))[..., None]
    hit = qv[..., None] & ((rows >> np.uint32(32 - tb)) == tag) & (rows != 0)
    assert (hit & (rows >= np.uint32(1 << 31))).sum() > 10


def test_compaction_keeps_top_bit_entries():
    """A row whose only verified hit has its tag's top bit set, beside
    empty slots: the compaction must keep it (a signed sort would not)."""
    tag_bits, rbits = 8, 3
    h = np.uint32((5 << 29) | 0xC3)  # row 5, tag 0xC3 (top tag bit set)
    entry = np.uint32((0xC3 << 24) | (1234 << 1) | 1)
    table = np.zeros((1 << rbits, lk.ROW_SLOTS), np.uint32)
    table[5, 3] = entry
    table[5, 0] = np.uint32((0x11 << 24) | (77 << 1))  # other tag: not a hit
    sk = (np.array([[h, h]], np.uint32), np.array([[3, 9]], np.int32),
          np.array([[False, True]]), np.array([[True, False]]))
    want, got = _both_lookups(table, tag_bits, 64, sk, 2)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert got[3][0, 0] == 1234 and got[0][0, 0] != lk.INVALID_KEY


def test_pair_votes_match_reference():
    rng = np.random.default_rng(2)
    keys = np.sort(rng.integers(0, 12, (16, 128)).astype(np.int32), axis=-1)
    keys[:3, -20:] = ref_lk.INVALID_KEY
    for max_run in (1, 5, 64, 300):
        want = np.asarray(ref_pair_votes(jnp.asarray(keys), max_run))
        got = ch._pair_votes(torch.from_numpy(keys), max_run).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f"max_run={max_run}")


@pytest.mark.parametrize("aps", [2, 0])
def test_chain_votes_and_mapq(setup, aps):
    want_a, got_a = _both_lookups(setup["table"], setup["tag_bits"], setup["L"],
                                  setup["sketch"], aps)
    max_run = min(128, setup["params"].n_slots)
    want = ref_chain_votes(*map(jnp.asarray, want_a), max_run=max_run)
    got = ch.chain_votes(*map(torch.from_numpy, got_a), max_run=max_run)
    for name in ch.ChainResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(), err_msg=name)
    assert np.asarray(want.f2).max() > 0  # the shared block gives runner-ups
    mq_ref = np.asarray(ref_ch.mapq_from_votes(want.f1, want.f2))
    mq = ch.mapq_from_votes(got.f1, got.f2).numpy()
    np.testing.assert_allclose(mq, mq_ref, rtol=0, atol=1e-5)


def test_chain_ties_take_first_occurrence():
    # two loci with equal votes: argmax must pick the first (lower key)
    key = np.array([[40, 40, 10, 10, ref_lk.INVALID_KEY, 70]], np.int32)
    diag = np.arange(6, dtype=np.int32)[None] * 100
    rp = np.array([[5, 3, 9, 2, 0, 1]], np.int32)
    fp = diag + 7
    want = ref_chain_votes(*map(jnp.asarray, (key, diag, rp, fp)))
    got = ch.chain_votes(*map(torch.from_numpy, (key, diag, rp, fp)))
    for name in ch.ChainResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(), err_msg=name)


def test_host_table_helpers_match_reference(setup):
    rng = np.random.default_rng(5)
    h = np.sort(rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32))
    pos = rng.integers(1, 1 << 16, 5000).astype(np.int32)
    st = rng.integers(0, 2, 5000).astype(np.uint8)
    assert lk.tag_bits_for(70_000) == ref_lk.tag_bits_for(70_000)
    assert lk.row_bits_for(5000) == ref_lk.row_bits_for(5000)
    np.testing.assert_array_equal(lk.pack_entries(h, pos, st, 12),
                                  ref_lk.pack_entries(h, pos, st, 12))
    np.testing.assert_array_equal(lk.build_hash_rows(h, pos, st, 12),
                                  ref_lk.build_hash_rows(h, pos, st, 12))

"""Single-shard classification in the PyTorch port (CPU, plain kernels):
the one step, ``classify_batch_grouped``, on a converted one-shard index
(one group of one) against the JAX reference's ``classify_batch``.

Tolerances: status, acc_id and counts bit-equal, and mlen wherever it
comes from banded SW.  Where mlen comes from the float vote estimate it
may differ by 1 (XLA's CPU log/exp and torch's differ by ulps before the
float->int truncation), and so may a MODE_MATCHING count per such read.
mapq and inv_identity within rtol 1e-5, atol 1e-6.  A status may differ
only where the failing side's mapq lies within 1e-4 of the 60 gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.align import runtime as ref_rt
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu_torch import convert
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.ops import extend as ex

torch.set_num_threads(1)

N_ACC = 5
SHARED = slice(20_000, 24_000)  # a block genomes 0 and 1 share


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(21)
    seqs = [rng.integers(0, 4, 50_000).astype(np.uint8) for _ in range(N_ACC)]
    seqs[1][SHARED] = seqs[0][SHARED]
    built = ref_build(seqs)
    ref_dev, tag_bits = ref_pl.device_shard(built.shards[0])
    dev = convert.groups_from_reference(
        [pl.DeviceIndexShard(*(np.asarray(a)[None] for a in ref_dev))], "cpu")
    return dict(seqs=seqs, built=built, ref_dev=ref_dev, dev=dev, tag_bits=tag_bits)


def _batch(seqs, seed, B, L, error, min_len=300, n_shared=4, n_random=3):
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(min_len, L + 1))
        if i < n_shared:  # fully inside the shared block: a tie
            r = seqs[0][SHARED][: min(n, 3000)].copy()
        elif i < n_shared + n_random:  # unrelated sequence
            r = rng.integers(0, 4, n).astype(np.uint8)
        else:
            r = ev.simulate_read_codes(rng, seqs[i % N_ACC], n, *error, bool(i & 1))
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return codes, lengths


def _run_both(index, codes, lengths, extend_mode, count_mode):
    L = codes.shape[1]
    ref_params = ref_pl.params_for_bucket(
        ref_pl.ClassifyParams(tag_bits=index["tag_bits"], extend_impl="jnp",
                              extend_mode=extend_mode), L)
    want, want_c = ref_pl.classify_batch(index["ref_dev"], jnp.asarray(codes),
                                         jnp.asarray(lengths), ref_params, N_ACC, count_mode)
    params = convert.params_from_reference(ref_params)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lengths)
    got, got_c = pl.classify_batch_grouped(index["dev"], tc, tl, params, N_ACC, count_mode)
    hit = pl.classify_group(index["dev"][0], tc, tl, params)
    vote_pass = ((hit.mapq >= params.mapping_quality) & (hit.votes >= params.min_votes))[0].numpy()
    want = {f: np.asarray(getattr(want, f)) for f in ref_pl.ReadResult._fields}
    got = {f: getattr(got, f).numpy() for f in pl.ReadResult._fields}
    return want, np.asarray(want_c), got, got_c.numpy(), vote_pass


def _contrib(res, lengths, count_mode, mask):
    """Per-accession counts of the reads in ``mask`` by one side's result."""
    value = {pl.MODE_BASIC: np.ones_like(lengths), pl.MODE_QUERY_LENGTH: lengths,
             pl.MODE_MATCHING: res["mlen"]}[count_mode]
    m = mask & (res["status"] == pl.MAPPED)
    return np.bincount(res["acc_id"][m], weights=value[m], minlength=N_ACC).astype(np.int64)


def _check(want, want_c, got, got_c, lengths, extend_mode, count_mode, vote_pass):
    diff = want["status"] != got["status"]
    exempt = diff & (np.minimum(want["mapq"], got["mapq"]) >= 60.0 - 1e-4)
    assert not (diff & ~exempt).any(), np.flatnonzero(diff & ~exempt)
    keep = ~exempt
    np.testing.assert_array_equal(want["acc_id"][keep], got["acc_id"][keep])
    np.testing.assert_array_equal(want["rc"], got["rc"])
    np.testing.assert_allclose(got["mapq"], want["mapq"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["inv_identity"], want["inv_identity"], rtol=1e-5, atol=1e-6)
    sw_mlen = np.ones_like(keep) if extend_mode == "full" else ~vote_pass
    dm = np.abs(want["mlen"].astype(np.int64) - got["mlen"])
    assert (dm[keep & sw_mlen] == 0).all()
    assert (dm[keep] <= 1).all()
    # counts: equal once the exempt reads' contributions are taken out
    cw = want_c - _contrib(want, lengths, count_mode, exempt)
    cg = got_c - _contrib(got, lengths, count_mode, exempt)
    if count_mode == pl.MODE_MATCHING and extend_mode == "rescue":
        loose = _contrib(want, np.ones_like(lengths), pl.MODE_BASIC, keep & ~sw_mlen)
        assert (np.abs(cw - cg) <= loose).all()
    else:
        np.testing.assert_array_equal(cw, cg)
    return exempt.sum()


@pytest.mark.parametrize("extend_mode", ["rescue", "full"])
@pytest.mark.parametrize("count_mode", [pl.MODE_BASIC, pl.MODE_QUERY_LENGTH, pl.MODE_MATCHING])
def test_classify_batch_matches_reference(index, extend_mode, count_mode):
    codes, lengths = _batch(index["seqs"], 1, 48, 1024, (0.05, 0.03, 0.03))
    want, want_c, got, got_c, vp = _run_both(index, codes, lengths, extend_mode, count_mode)
    assert _check(want, want_c, got, got_c, lengths, extend_mode, count_mode, vp) == 0
    st = got["status"]
    assert (st == pl.MAPPED).sum() > 30
    assert (st == pl.AMBIGUOUS).sum() >= 1 and (st == pl.UNMAPPED).sum() >= 1


def test_short_bucket_winnow_path(index):
    """The 512 bucket keeps 128 slots: sketching takes the winnow path."""
    codes, lengths = _batch(index["seqs"], 2, 32, 512, (0.06, 0.03, 0.03), min_len=200)
    want, want_c, got, got_c, vp = _run_both(index, codes, lengths, "rescue", pl.MODE_BASIC)
    assert _check(want, want_c, got, got_c, lengths, "rescue", pl.MODE_BASIC, vp) == 0


def test_rescue_tier_escalation(index, monkeypatch):
    """A high-error batch has more rescue candidates than B/8, so the
    rescue runs in the B/2 or B tier."""
    B = 64
    codes, lengths = _batch(index["seqs"], 3, B, 1024, (0.10, 0.04, 0.04), n_shared=0)
    sizes = []
    real = ex.extend_hits

    def spy(ref_codes, codes, *a, **kw):
        sizes.append(codes.shape[0])
        return real(ref_codes, codes, *a, **kw)

    monkeypatch.setattr(ex, "extend_hits", spy)
    want, want_c, got, got_c, vp = _run_both(index, codes, lengths, "rescue", pl.MODE_QUERY_LENGTH)
    assert _check(want, want_c, got, got_c, lengths, "rescue", pl.MODE_QUERY_LENGTH, vp) == 0
    assert sizes and max(sizes) > B // 8, sizes
    assert ((got["status"] == pl.MAPPED) & ~vp).sum() > B // 8  # rescued reads


@pytest.mark.parametrize("count_mode", ["query_length", "matching"])
def test_classifier_classify_and_fetch(index, count_mode):
    codes, lengths = _batch(index["seqs"], 4, 40, 1024, (0.05, 0.03, 0.03))
    ref_params = ref_pl.ClassifyParams(extend_impl="jnp")
    ref_clf = ref_rt.Classifier(index["built"], ref_params, count_mode=count_mode)
    want = ref_clf.fetch(*ref_clf.classify(codes, lengths))
    clf = rt.Classifier(convert.built_from_reference(index["built"]),
                        convert.params_from_reference(ref_params), count_mode, device="cpu")
    assert clf.params == convert.params_from_reference(ref_clf.params)
    got = clf.fetch(*clf.classify(codes, lengths))
    for name, a, b in zip(("status", "acc_id", "mlen", "counts"), want, got):
        assert a.dtype == b.dtype, name
        if name == "mlen" and count_mode == "query_length":
            # vote-estimate mlen on the vote-passed reads: within 1
            np.testing.assert_allclose(b, a, rtol=0, atol=1, err_msg=name)
        else:  # matching mode runs SW on every read: exact
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got[0] == pl.MAPPED).sum() > 25


def test_unpack_and_pack_results_match_reference():
    from monica_tpu_torch.io.encode import pack_codes_2bit

    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, (5, 37)).astype(np.uint8)
    packed = pack_codes_2bit(codes)
    got = pl.unpack_codes(torch.from_numpy(packed), 37).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_pl.unpack_codes(jnp.asarray(packed), 37)))
    res = pl.ReadResult(
        status=torch.tensor([1, 0, 2], dtype=torch.int32),
        acc_id=torch.tensor([4, -1, -1], dtype=torch.int32),
        inv_identity=torch.zeros(3), mlen=torch.tensor([900, 0, 0], dtype=torch.int32),
        mapq=torch.zeros(3), rc=torch.zeros(3, dtype=torch.bool))
    counts = torch.arange(7, dtype=torch.int32)
    ref_res = ref_pl.ReadResult(*(jnp.asarray(x.numpy()) for x in res))
    np.testing.assert_array_equal(
        pl.pack_results(res, counts).numpy(),
        np.asarray(ref_pl.pack_results(ref_res, jnp.asarray(counts.numpy()))))

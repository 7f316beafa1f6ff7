"""The port's device-side index build (sketch and 2-key sort, the
occurrence filter before the fetch, the dispatch and its overflow route)
and the device table fill (``lookup.fill_hash_rows``, through the
Classifier's stack) held bit-equal to the JAX package's device build and
to the host build, on the same seeded inputs.  The device functions run
here on CPU tensors; the same code runs on the card in
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from monica_tpu.index import build as ref_ib
from monica_tpu.ops import lookup as ref_lk
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.evaluation import simulate_read_codes
from monica_tpu_torch.index import build as ib
from monica_tpu_torch.index import minimizer as mz
from monica_tpu_torch.ops import lookup as lk

torch.set_num_threads(1)

K, W, FRAC = mz.K_DEFAULT, mz.W_DEFAULT, mz.FRAC_DEFAULT
CPU = torch.device("cpu")
SHARD_ARRAYS = ("ref_codes", "seq_starts", "seq_lengths", "seq_accession_id",
                "mz_hash", "mz_pos", "mz_strand", "pos_accession_id")


def _host_sorted(codes):
    h, pos, strand = ib.sketch_long_sequence(codes, K, W, frac=FRAC)
    order = np.argsort(h, kind="stable")
    return h[order], pos[order], strand[order]


def _fetched(mz):
    """Sorted (hash bit patterns, pos, strand) tensors as the host
    sketch's arrays: (uint32, int64, uint8)."""
    h, p, s = mz
    return h.numpy().view(np.uint32), p.numpy().astype(np.int64), s.numpy()


def _ref_filtered(h, pos, strand, occ_cap):
    """The JAX package's occurrence filter (``_jit_kept_count``) over
    sorted host arrays."""
    keep, _ = ref_ib._jit_kept_count(occ_cap)(h, ((pos << 1) | strand).astype(np.uint32), len(h))
    keep = np.asarray(keep)
    return h[keep], pos[keep], strand[keep]


def _device_route(monkeypatch):
    """Send CPU-device builds down the device route, as a CUDA device is."""
    monkeypatch.setattr(ib, "_on_device", lambda device: True)


@pytest.mark.parametrize("n", [ib._DEV_SEG // 2, ib._DEV_SEG + 12_345])
def test_device_sketch_sort_bit_identical(n):
    assert ib._DEV_SEG == ref_ib._DEV_SEG and ib._DEV_CAP_SHIFT == ref_ib._DEV_CAP_SHIFT
    codes = np.random.default_rng(21).integers(0, 4, n).astype(np.uint8)
    got = _fetched(ib._device_sketch_sort(codes, K, W, FRAC, CPU))
    ref = ref_ib._device_sketch_sort(codes, K, W, FRAC)
    host = _host_sorted(codes)
    assert ref is not None
    for a, b, c, name in zip(got, ref, host, ("hash", "pos", "strand")):
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)


def _fill(h, pos, strand, tag_bits, rbits=None):
    """lookup.fill_hash_rows on CPU tensors of host arrays, as uint32."""
    rbits = lk.row_bits_for(len(h)) if rbits is None else rbits
    table = lk.fill_hash_rows(torch.from_numpy(h.view(np.int32)),
                              torch.from_numpy(pos.astype(np.int32)),
                              torch.from_numpy(strand), tag_bits, rbits)
    assert table.dtype == torch.int32
    return table.numpy().view(np.uint32)


def test_device_hash_table_bit_identical():
    """The device route's table (sketch and sort on the device, the host
    occurrence filter, the device fill) equals the JAX device table and
    the JAX host pipeline (occurrence filter -> build_hash_rows), with
    n_kept equal."""
    codes = np.random.default_rng(23).integers(0, 4, (1 << 21) + 777).astype(np.uint8)
    tag_bits = lk.tag_bits_for(len(codes))
    hh, pp, ss = _fetched(ib._occ_filter(*ib._device_sketch_sort(codes, K, W, FRAC, CPU),
                                         occ_cap=ib.OCC_CAP))
    rh, rps, rtotal = ref_ib._device_sketch_sort_arrays(codes, K, W, FRAC)
    ref_table, ref_n_kept = ref_ib._device_hash_table(rh, rps, rtotal, tag_bits, ref_ib.OCC_CAP)
    assert len(hh) == ref_n_kept
    np.testing.assert_array_equal(_fill(hh, pp, ss, tag_bits), np.asarray(ref_table))
    host = _ref_filtered(*_host_sorted(codes), ib.OCC_CAP)
    for a, b in zip((hh, pp, ss), host):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        _fill(hh, pp, ss, tag_bits), ref_lk.build_hash_rows(hh, pp.astype(np.int32), ss, tag_bits))


def test_device_table_occ_cap_zero_disables_filter():
    codes = np.random.default_rng(31).integers(0, 4, 1 << 18).astype(np.uint8)
    # a repeat copied 12 times: its minimizers occur more than OCC_CAP times
    codes[: 12 * 500] = np.tile(codes[:500], 12)
    tag_bits = lk.tag_bits_for(len(codes))
    mz = ib._device_sketch_sort(codes, K, W, FRAC, CPU)
    hh, pp, ss = _fetched(ib._occ_filter(*mz, occ_cap=0))
    rh, rps, rtotal = ref_ib._device_sketch_sort_arrays(codes, K, W, FRAC)
    ref_table, ref_n_kept = ref_ib._device_hash_table(rh, rps, rtotal, tag_bits, 0)
    assert len(hh) == ref_n_kept == rtotal
    np.testing.assert_array_equal(_fill(hh, pp, ss, tag_bits), np.asarray(ref_table))
    for x, y in zip((hh, pp, ss), _host_sorted(codes)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        _fill(hh, pp, ss, tag_bits), ref_lk.build_hash_rows(hh, pp.astype(np.int32), ss, tag_bits))
    # with the filter on, the repeat's minimizers go
    assert len(ib._occ_filter(*mz, occ_cap=ib.OCC_CAP)[0]) < rtotal


@pytest.mark.parametrize("occ_cap", [0, 1, 4, ib.OCC_CAP])
def test_occ_filter_equals_reference_kept_count(occ_cap):
    """The one occurrence filter, on hash-sorted tensors with equal-hash
    runs of 1-12 entries, keeps what the JAX package's ``_kept_count``
    keeps, other arrays alongside."""
    rng = np.random.default_rng(occ_cap)
    runs = rng.integers(1, 13, 400)
    h = np.repeat(np.sort(rng.choice(1 << 32, len(runs), replace=False)), runs).astype(np.uint32)
    ps = rng.integers(0, 1 << 27, len(h)).astype(np.uint32)
    got_h, got_ps = ib._occ_filter(torch.from_numpy(h.view(np.int32)),
                                   torch.from_numpy(ps.astype(np.int64)), occ_cap=occ_cap)
    keep, n_kept = ref_ib._jit_kept_count(occ_cap)(h, ps, len(h))
    keep = np.asarray(keep)
    assert len(got_h) == int(n_kept) and (occ_cap == 0 or int(n_kept) < len(h))
    np.testing.assert_array_equal(got_h.numpy().view(np.uint32), h[keep])
    np.testing.assert_array_equal(got_ps.numpy(), ps[keep].astype(np.int64))


def test_pad_beside_a_real_max_hash():
    """A real minimizer whose hash is 0xFFFFFFFF sorts before the pads and
    keeps its own run: the pads are cut off before the filter, so it
    cannot merge the real entry with them."""
    h = np.array([10, 20, 0xFFFFFFFF] + [0xFFFFFFFF] * 5, np.uint32)
    ps = np.array([2, 4, 6] + [0xFFFFFFFF] * 5, np.uint32)
    # the 2-key sort puts the real max-hash entry before the pads
    perm = np.random.default_rng(5).permutation(len(h))
    sh, sps = ib._sort2(torch.from_numpy(h[perm].astype(np.int64)),
                        torch.from_numpy(ps[perm].astype(np.int64)))
    np.testing.assert_array_equal(sh.numpy(), h.astype(np.int64))
    np.testing.assert_array_equal(sps.numpy(), ps.astype(np.int64))
    total = 3
    kh, kps = ib._occ_filter(sh[:total], sps[:total], occ_cap=4)
    ref_keep, ref_n_kept = ref_ib._jit_kept_count(4)(h, ps, total)
    assert len(kh) == int(ref_n_kept) == 3
    np.testing.assert_array_equal(kh.numpy(), h[np.asarray(ref_keep)])
    kps = kps.numpy()
    table = _fill(kh.numpy().astype(np.uint32), kps >> 1, (kps & 1).astype(np.uint8), 8, 2)
    np.testing.assert_array_equal(table, np.asarray(ref_ib._jit_table_fill(8, 2)(h, ps, ref_keep)))
    assert table[3, 0] == (0xFF << 24) | 6


def test_homopolymer_overflow_route_is_counted_and_equals_host(monkeypatch):
    """A homopolymer overflows a segment's compaction capacity: the device
    sketch returns None, as the reference's does, the route is counted,
    and the build goes on on the host with the same arrays."""
    codes = np.zeros(1 << 22, np.uint8)
    ib.reset_build_routes()
    assert ib._device_sketch_sort(codes, K, W, FRAC, CPU) is None
    assert ref_ib._device_sketch_sort(codes, K, W, FRAC) is None
    assert ib.BUILD_ROUTES["overflow"] == 1

    rng = np.random.default_rng(7)
    seqs = [np.concatenate([np.zeros(1 << 21, np.uint8),
                            rng.integers(0, 4, 50_000).astype(np.uint8)])]
    host = ib.build_index_from_arrays(seqs, device="cpu")
    _device_route(monkeypatch)
    ib.reset_build_routes()
    routed = ib.build_index_from_arrays(seqs, device="cpu")
    assert ib.BUILD_ROUTES == {"device_sketch_sort": 0, "overflow": 1}
    for f in SHARD_ARRAYS:
        np.testing.assert_array_equal(getattr(routed.shards[0], f), getattr(host.shards[0], f))


def test_one_shard_device_build_equals_host_and_reference(monkeypatch):
    """The one-shard build on the device route gives the host build's
    arrays, and the Classifier's (1, R, 8) stack of it equals the JAX
    device build's table."""
    rng = np.random.default_rng(22)
    seqs = [rng.integers(0, 4, 1 << 20).astype(np.uint8) for _ in range(2)]
    host = ib.build_index_from_arrays(seqs, device="cpu")
    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "1")
    ref = ref_ib.build_index_from_arrays(seqs)
    _device_route(monkeypatch)
    ib.reset_build_routes()
    dev = ib.build_index_from_arrays(seqs, device="cpu")
    assert ib.BUILD_ROUTES == {"device_sketch_sort": 1, "overflow": 0}
    sh = host.shards[0]
    for f in SHARD_ARRAYS:
        a, b = getattr(dev.shards[0], f), getattr(sh, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    (group,), tag_bits = pl.stack_device_shard_groups(dev.shards, CPU)
    ref_table, ref_tag_bits = ref.device[0]
    assert tag_bits == ref_tag_bits and group.mz_rows.shape[0] == 1
    np.testing.assert_array_equal(group.mz_rows[0].numpy().view(np.uint32), np.asarray(ref_table))
    np.testing.assert_array_equal(
        group.mz_rows[0].numpy().view(np.uint32),
        ref_lk.build_hash_rows(sh.mz_hash, sh.mz_pos, sh.mz_strand, tag_bits))


@pytest.mark.parametrize("S", [1, 3])
def test_stacked_fill_equals_reference_rows(S):
    """Each slice of a device-filled stack, at the stack's row width and
    the whole index's tag width (both wider than a shard's own), is
    bit-equal to the JAX build_hash_rows of that shard at those widths."""
    rng = np.random.default_rng(26 + S)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (90_000, 40_000, 20_000)[:S]]
    shards = ib.build_index_from_arrays(seqs, n_shards=S, device="cpu").shards
    big = ib.build_index_from_arrays([rng.integers(0, 4, 400_000).astype(np.uint8)],
                                     device="cpu").shards[0]
    tag_bits = lk.tag_bits_for(len(big.ref_codes))
    group = pl.stack_device_shards(shards, CPU, tag_bits, dims_of=shards + [big])
    rbits = lk.row_bits_for(big.n_minimizers)
    assert group.mz_rows.shape == (S, 1 << rbits, lk.ROW_SLOTS)
    for s, sh in enumerate(shards):
        assert rbits > lk.row_bits_for(sh.n_minimizers)
        assert tag_bits < lk.tag_bits_for(len(sh.ref_codes))
        np.testing.assert_array_equal(
            group.mz_rows[s].numpy().view(np.uint32),
            ref_lk.build_hash_rows(sh.mz_hash, sh.mz_pos, sh.mz_strand, tag_bits, rbits))


def test_multi_shard_device_sketch_equals_host(monkeypatch):
    """A multi-shard build sketches and sorts shards of at least 2^21
    bases on the device and keeps the rest of the build on the host."""
    rng = np.random.default_rng(25)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (1 << 21, 1 << 21, 60_000)]
    host = ib.build_index_from_arrays(seqs, n_shards=3, device="cpu")
    _device_route(monkeypatch)
    ib.reset_build_routes()
    dev = ib.build_index_from_arrays(seqs, n_shards=3, device="cpu")
    assert ib.BUILD_ROUTES == {"device_sketch_sort": 2, "overflow": 0}
    assert len(dev.shards) == 3
    for a, b in zip(dev.shards, host.shards):
        for f in SHARD_ARRAYS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_classifier_on_device_build_matches_host_build(monkeypatch):
    """Classification through a device-built index equals classification
    through the host build, on equal stacked tensors."""
    rng = np.random.default_rng(24)
    seqs = [rng.integers(0, 4, 1 << 20).astype(np.uint8) for _ in range(2)]
    host_built = ib.build_index_from_arrays(seqs, device="cpu")
    _device_route(monkeypatch)
    dev_built = ib.build_index_from_arrays(seqs, device="cpu")
    n, L = 96, 800
    codes = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        r = simulate_read_codes(rng, seqs[i % 2], L, 0.03, 0.02, 0.02, bool(i % 4 == 0))
        codes[i, : len(r)] = r
        lens[i] = len(r)
    outs, indexes = [], []
    for built in (dev_built, host_built):
        clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="basic", device="cpu")
        outs.append(clf.fetch(*clf.classify(codes, lens)))
        indexes.append(clf.index)
    for g, h in zip(*indexes):
        assert all(torch.equal(a, b) for a, b in zip(g, h))
    assert (outs[0][0] == pl.MAPPED).mean() > 0.9
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_cuda_build_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    seqs = [np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)]
    with pytest.raises(RuntimeError, match="cuda"):
        ib.build_index_from_arrays(seqs, device="cuda")

"""The port's device-side index build (sketch and 2-key sort, occurrence
filter and table fill, LazyDeviceShard, the dispatch and its overflow
route) held bit-equal to the JAX package's device build and to the host
build, on the same seeded inputs.  The device functions run here on CPU
tensors; the same code runs on the card in ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from monica_tpu.index import build as ref_ib
from monica_tpu.ops import lookup as ref_lk
from monica_tpu_torch._u32 import u32
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


def _occ_filtered(codes, occ_cap):
    h, p, s = _host_sorted(codes)
    return ib._host_occ_filter(h, p, s, occ_cap=occ_cap)


def _device_route(monkeypatch):
    """Send CPU-device builds down the device route, as a CUDA device is."""
    monkeypatch.setattr(ib, "_on_device", lambda device: True)


@pytest.mark.parametrize("n", [ib._DEV_SEG // 2, ib._DEV_SEG + 12_345])
def test_device_sketch_sort_bit_identical(n):
    assert ib._DEV_SEG == ref_ib._DEV_SEG and ib._DEV_CAP_SHIFT == ref_ib._DEV_CAP_SHIFT
    codes = np.random.default_rng(21).integers(0, 4, n).astype(np.uint8)
    got = ib._device_sketch_sort(codes, K, W, FRAC, CPU)
    ref = ref_ib._device_sketch_sort(codes, K, W, FRAC)
    host = _host_sorted(codes)
    assert got is not None and ref is not None
    for a, b, c, name in zip(got, ref, host, ("hash", "pos", "strand")):
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)


def test_device_hash_table_bit_identical():
    """The table on the device equals the JAX device table and the host
    pipeline (occurrence filter -> build_hash_rows), with n_kept equal;
    the sorted arrays equal the JAX ones, pads included."""
    codes = np.random.default_rng(23).integers(0, 4, (1 << 21) + 777).astype(np.uint8)
    tag_bits = lk.tag_bits_for(len(codes))
    h, ps, total = ib._device_sketch_sort_arrays(codes, K, W, FRAC, CPU)
    rh, rps, rtotal = ref_ib._device_sketch_sort_arrays(codes, K, W, FRAC)
    assert total == rtotal
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh).astype(np.int64))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rps).astype(np.int64))
    table, n_kept = ib._device_hash_table(h, ps, total, tag_bits, ib.OCC_CAP)
    ref_table, ref_n_kept = ref_ib._device_hash_table(rh, rps, rtotal, tag_bits, ref_ib.OCC_CAP)
    assert n_kept == ref_n_kept
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy().view(np.uint32), np.asarray(ref_table))
    hh, pp, ss = _occ_filtered(codes, ib.OCC_CAP)
    assert n_kept == len(hh)
    np.testing.assert_array_equal(
        table.numpy().view(np.uint32), lk.build_hash_rows(hh, pp.astype(np.int32), ss, tag_bits))


def test_device_table_occ_cap_zero_disables_filter():
    codes = np.random.default_rng(31).integers(0, 4, 1 << 18).astype(np.uint8)
    # a repeat copied 12 times: its minimizers occur more than OCC_CAP times
    codes[: 12 * 500] = np.tile(codes[:500], 12)
    tag_bits = lk.tag_bits_for(len(codes))
    h, ps, total = ib._device_sketch_sort_arrays(codes, K, W, FRAC, CPU)
    rh, rps, rtotal = ref_ib._device_sketch_sort_arrays(codes, K, W, FRAC)
    table, n_kept = ib._device_hash_table(h, ps, total, tag_bits, 0)
    ref_table, ref_n_kept = ref_ib._device_hash_table(rh, rps, rtotal, tag_bits, 0)
    assert n_kept == ref_n_kept == total
    np.testing.assert_array_equal(table.numpy().view(np.uint32), np.asarray(ref_table))
    hh, pp, ss = _host_sorted(codes)
    np.testing.assert_array_equal(
        table.numpy().view(np.uint32), lk.build_hash_rows(hh, pp.astype(np.int32), ss, tag_bits))
    # with the filter on, the repeat's minimizers go
    _, capped = ib._device_hash_table(h, ps, total, tag_bits, ib.OCC_CAP)
    assert capped < total


def test_pad_beside_a_real_max_hash():
    """A real minimizer whose hash is 0xFFFFFFFF sorts before the pads and
    keeps its own run: the filter must not merge it with them."""
    h = np.array([10, 20, 0xFFFFFFFF] + [0xFFFFFFFF] * 5, np.uint32)
    ps = np.array([2, 4, 6] + [0xFFFFFFFF] * 5, np.uint32)
    # the 2-key sort puts the real max-hash entry before the pads
    perm = np.random.default_rng(5).permutation(len(h))
    sh, sps = ib._sort2(torch.from_numpy(h[perm].astype(np.int64)),
                        torch.from_numpy(ps[perm].astype(np.int64)))
    np.testing.assert_array_equal(sh.numpy(), h.astype(np.int64))
    np.testing.assert_array_equal(sps.numpy(), ps.astype(np.int64))
    keep, n_kept = ib._kept_count(sh, sps, 3, 4)
    ref_keep, ref_n_kept = ref_ib._jit_kept_count(4)(h, ps, 3)
    assert int(n_kept) == int(ref_n_kept) == 3
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    table = ib._table_fill(sh, sps, keep, 8, 2)
    ref_table = ref_ib._jit_table_fill(8, 2)(h, ps, ref_keep)
    np.testing.assert_array_equal(table.numpy().view(np.uint32), np.asarray(ref_table))
    assert table.numpy().view(np.uint32)[3, 0] == (0xFF << 24) | 6


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
    assert ib.BUILD_ROUTES == {"device_table": 0, "device_sketch_sort": 0, "overflow": 1}
    assert routed.device is None
    for f in SHARD_ARRAYS:
        np.testing.assert_array_equal(getattr(routed.shards[0], f), getattr(host.shards[0], f))


def test_one_shard_device_build_equals_host_and_reference(monkeypatch):
    """The whole one-shard device build: the table equals the JAX device
    build's, and LazyDeviceShard fetches the host build's arrays."""
    rng = np.random.default_rng(22)
    seqs = [rng.integers(0, 4, 1 << 20).astype(np.uint8) for _ in range(2)]
    host = ib.build_index_from_arrays(seqs, device="cpu")
    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "1")
    ref = ref_ib.build_index_from_arrays(seqs)
    _device_route(monkeypatch)
    ib.reset_build_routes()
    dev = ib.build_index_from_arrays(seqs, device="cpu")
    assert ib.BUILD_ROUTES == {"device_table": 1, "device_sketch_sort": 1, "overflow": 0}
    assert isinstance(dev.shards[0], ib.LazyDeviceShard) and host.device is None
    (table, tag_bits), (ref_table, ref_tag_bits) = dev.device[0], ref.device[0]
    assert tag_bits == ref_tag_bits
    np.testing.assert_array_equal(table.numpy().view(np.uint32), np.asarray(ref_table))
    sh = host.shards[0]
    np.testing.assert_array_equal(
        table.numpy().view(np.uint32),
        ref_lk.build_hash_rows(sh.mz_hash, sh.mz_pos, sh.mz_strand, tag_bits))
    for f in SHARD_ARRAYS:
        a, b = getattr(dev.shards[0], f), getattr(sh, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dev.shards[0].n_minimizers == sh.n_minimizers


def test_lazy_device_shard_keeps_only_real_entries_until_fetched(monkeypatch):
    """LazyDeviceShard holds the real sorted entries as int32 bit
    patterns, which refill the same table, and drops them once fetched."""
    rng = np.random.default_rng(23)
    seqs = [rng.integers(0, 4, 300_000).astype(np.uint8) for _ in range(2)]
    host = ib.build_index_from_arrays(seqs, device="cpu").shards[0]
    _device_route(monkeypatch)
    dev = ib.build_index_from_arrays(seqs, device="cpu")
    ds, (table, tag_bits) = dev.shards[0], dev.device[0]
    assert ds._h_dev.dtype == ds._ps_dev.dtype == torch.int32
    assert len(ds._h_dev) == len(ds._ps_dev) == ds._total
    again, n_kept = ib._device_hash_table(u32(ds._h_dev), ds._ps_dev.long(), ds._total,
                                          tag_bits, dev.meta.occ_cap)
    assert torch.equal(again, table) and n_kept == host.n_minimizers
    np.testing.assert_array_equal(ds.mz_hash, host.mz_hash)
    assert ds._h_dev is None and ds._ps_dev is None
    np.testing.assert_array_equal(ds.mz_pos, host.mz_pos)


def test_multi_shard_device_sketch_equals_host(monkeypatch):
    """A multi-shard build sketches and sorts shards of at least 2^21
    bases on the device and keeps the rest of the build on the host."""
    rng = np.random.default_rng(25)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (1 << 21, 1 << 21, 60_000)]
    host = ib.build_index_from_arrays(seqs, n_shards=3, device="cpu")
    _device_route(monkeypatch)
    ib.reset_build_routes()
    dev = ib.build_index_from_arrays(seqs, n_shards=3, device="cpu")
    assert ib.BUILD_ROUTES == {"device_table": 0, "device_sketch_sort": 2, "overflow": 0}
    assert dev.device is None and len(dev.shards) == 3
    for a, b in zip(dev.shards, host.shards):
        for f in SHARD_ARRAYS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_classifier_on_device_build_matches_host_build(monkeypatch):
    """Classification through a device-built index (the Classifier takes
    its table as it is) equals classification through the host build."""
    rng = np.random.default_rng(24)
    seqs = [rng.integers(0, 4, 1 << 20).astype(np.uint8) for _ in range(2)]
    host_built = ib.build_index_from_arrays(seqs, device="cpu")
    _device_route(monkeypatch)
    dev_built = ib.build_index_from_arrays(seqs, device="cpu")
    assert dev_built.device is not None
    n, L = 96, 800
    codes = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        r = simulate_read_codes(rng, seqs[i % 2], L, 0.03, 0.02, 0.02, bool(i % 4 == 0))
        codes[i, : len(r)] = r
        lens[i] = len(r)
    outs = []
    for built in (dev_built, host_built):
        clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="basic", device="cpu")
        outs.append(clf.fetch(*clf.classify(codes, lens)))
        if built is dev_built:
            assert clf.index.mz_rows.data_ptr() == dev_built.device[0][0].data_ptr()
    assert (outs[0][0] == pl.MAPPED).mean() > 0.9
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_cuda_build_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    seqs = [np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)]
    with pytest.raises(RuntimeError, match="cuda"):
        ib.build_index_from_arrays(seqs, device="cuda")

"""The port's host index build is bit-equal to the reference host build,
and its stacked device tables equal the reference's device_shard arrays."""

import numpy as np
import pytest
import torch

from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index import build as ref_build
from monica_tpu_torch import convert
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index import build
from tests.fixtures import make_fasta_gz, random_genome

torch.set_num_threads(1)

SHARD_ARRAYS = ("ref_codes", "seq_starts", "seq_lengths", "seq_accession_id",
                "mz_hash", "mz_pos", "mz_strand", "pos_accession_id")


def _genomes(seed=0, n=5, length=50_000):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, length).astype(np.uint8) for _ in range(n)]
    seqs[1][1000:1200] = 4  # an N run
    seqs[-1][:3000] = np.tile(seqs[-1][:300], 10)  # a tandem repeat (occ cap)
    return seqs


def _assert_same_index(want, got):
    for f in ("tax_units", "accessions", "k", "w", "frac", "occ_cap"):
        assert getattr(want.meta, f) == getattr(got.meta, f), f
    np.testing.assert_array_equal(want.meta.genome_lengths, got.meta.genome_lengths)
    assert len(want.shards) == len(got.shards)
    for sw, sg in zip(want.shards, got.shards):
        for f in SHARD_ARRAYS:
            a, b = getattr(sw, f), getattr(sg, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kw", [dict(), dict(n_shards=2), dict(max_shard_bytes=120_000),
                                dict(frac=0.5), dict(occ_cap=0)])
def test_build_index_from_arrays_bit_equal(kw):
    seqs = _genomes()
    want = ref_build.build_index_from_arrays(seqs, **kw)
    got = build.build_index_from_arrays(seqs, **kw, device="cpu")
    _assert_same_index(want, got)
    assert got.shards[0].n_minimizers > 1000


def test_build_index_from_fasta_bit_equal(tmp_path):
    rng = np.random.default_rng(3)
    genomes = []
    for i in range(3):
        recs = [(f"ctg{i}_{j}", random_genome(rng, 8000 + 3000 * j)) for j in range(2)]
        path = tmp_path / f"g{i}.fna.gz"
        make_fasta_gz(path, recs)
        genomes.append((str(path), [f"Sp_{i}", f"ACC{i:03d}.1"]))
    _assert_same_index(ref_build.build_index(genomes), build.build_index(genomes, device="cpu"))


def test_segmenting_and_assignment_match(monkeypatch):
    recs = [[np.zeros(10, np.uint8), np.ones(25, np.uint8)], [np.zeros(7, np.uint8)]]
    for mod in (ref_build, build):
        monkeypatch.setattr(mod, "SEG_LEN", 8)
    a, b = ref_build._segment_records(recs), build._segment_records(recs)
    assert [(g, len(r)) for g, r in a] == [(g, len(r)) for g, r in b]
    sizes = [5, 40, 7, 33, 12, 2]
    for n in (1, 2, 3):
        assert build.split_genomes(sizes, n_shards=n) == ref_build.split_genomes(sizes, n_shards=n)
    assert build.split_genomes(sizes, max_shard_bytes=30) == ref_build.split_genomes(
        sizes, max_shard_bytes=30)
    assert build._assign_units(sizes, 2, None) == ref_build._assign_units(sizes, 2, None)


def test_device_shard_matches_reference_and_convert():
    """A one-shard index stacks as one group of one whose arrays equal
    the reference's device_shard arrays, and convert's group of them."""
    seqs = _genomes(seed=1, n=3, length=20_000)
    ref_built = ref_build.build_index_from_arrays(seqs)
    ref_dev, ref_tb = ref_pl.device_shard(ref_built.shards[0])
    port_built = convert.built_from_reference(ref_built)
    _assert_same_index(ref_built, port_built)
    (dev,), tb = pl.stack_device_shard_groups(port_built.shards, "cpu")
    assert tb == ref_tb
    (conv,) = convert.groups_from_reference(
        [pl.DeviceIndexShard(*(np.asarray(a)[None] for a in ref_dev))], "cpu")
    for name in pl.DeviceIndexShard._fields:
        np.testing.assert_array_equal(getattr(dev, name).numpy(), getattr(conv, name).numpy())
    np.testing.assert_array_equal(dev.mz_rows[0].numpy().view(np.uint32),
                                  np.asarray(ref_dev.mz_rows))
    np.testing.assert_array_equal(dev.pos_acc[0].numpy(),
                                  np.asarray(ref_dev.pos_acc).astype(np.int32))
    assert dev.pos_acc.dtype == torch.int32 and dev.mz_rows.dtype == torch.int32


def test_params_from_reference():
    for ref_impl, impl in (("pallas", "cuda"), ("jnp", "torch"), ("auto", "auto")):
        ref = ref_pl.ClassifyParams(extend_impl=ref_impl, band=128, tag_bits=11)
        got = convert.params_from_reference(ref)
        assert got.extend_impl == impl
        assert got._replace(extend_impl=ref_impl) == pl.ClassifyParams(**ref._asdict())
    assert pl.ClassifyParams._fields == ref_pl.ClassifyParams._fields
    defaults = pl.ClassifyParams()._asdict()
    ref_defaults = ref_pl.ClassifyParams()._asdict()
    for k, v in ref_defaults.items():
        assert defaults[k] == v, k


def test_threaded_shard_build_equals_serial():
    """A multi-shard build runs a thread per shard; every shard equals
    the one a serial _build_shard call makes, in assignment order."""
    seqs = _genomes(seed=4, n=6, length=20_000)
    got = build.build_index_from_arrays(seqs, n_shards=4, device="cpu")
    units = build._segment_records([[s] for s in seqs])
    assignment = build._assign_units([len(u[1]) for u in units], 4, None)
    assert len(assignment) == len(got.shards) == 4
    for members, shard in zip(assignment, got.shards):
        want = build._build_shard(members, units, 15, 10, 32, 1.0, build.OCC_CAP, None)
        for f in SHARD_ARRAYS:
            np.testing.assert_array_equal(getattr(shard, f), getattr(want, f), err_msg=f)
    _assert_same_index(ref_build.build_index_from_arrays(seqs, n_shards=4), got)

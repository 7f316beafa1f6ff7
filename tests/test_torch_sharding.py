"""The port's device mesh against the JAX package's (CPU): the mesh
stacking rank by rank, the mesh step on ``cpu`` x (d·i) against
``make_sharded_classifier`` on conftest's 8 CPU devices, a (1, 3) mesh
against the single-device ``Classifier``, ``resolve_mesh``'s divisor
policy, ``shard_reads`` and the lockstep schedule's slot overflow in
one process (mirrors ``tests/test_sharding.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu.io import encode as ref_enc
from monica_tpu.parallel import dist as ref_dist
from monica_tpu.parallel import mesh as ref_pm
from monica_tpu_torch import convert
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.parallel import dist
from monica_tpu_torch.parallel import mesh as pm
from monica_tpu_torch.stats.abundance import AbundanceState
from tests.fixtures import make_fastq, random_genome, sample_reads

torch.set_num_threads(1)

CPU = torch.device("cpu")
# mapq and identity: float32 values computed by the same formulas in the
# same order on both sides; held to 1e-6 relative.  mlen is exact where
# banded SW gives it (matching mode); the float vote estimate of a
# vote-passed read may land 1 off, as in tests/test_torch_pipeline.py
FLOAT_RTOL = 1e-6


def _codes(seqs):
    return [np.frombuffer(s.encode(), np.uint8) for s in seqs]


@pytest.fixture(scope="module")
def world():
    """Five 20 kb genomes in five shards (more shards than index ranks),
    reads at two error levels so the rescue runs, and padding rows."""
    rng = np.random.default_rng(77)
    genomes = [random_genome(rng, 20_000) for _ in range(5)]
    arrays = [ref_enc.encode_seq(g) for g in genomes]
    ref_built = ref_build(arrays, n_shards=5)
    assert len(ref_built.shards) == 5
    reads, labels = sample_reads(rng, genomes, 40, read_len=700, error=(0.03, 0.02, 0.02))
    hard, hard_labels = sample_reads(rng, genomes, 24, read_len=700, error=(0.12, 0.05, 0.05))
    return dict(genomes=genomes, ref_built=ref_built,
                built=convert.built_from_reference(ref_built),
                reads=reads + hard, labels=labels + hard_labels)


def _sizes(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return ref_build([rng.integers(0, 4, n).astype(np.uint8) for n in sizes], n_shards=len(sizes))


@pytest.mark.parametrize("sizes,n_index", [
    ((20_000,) * 5, 2),  # more shards than ranks, one size class
    ((600_000, 40_000, 40_000, 40_000, 40_000), 2),  # skewed: two classes, inert padding
    ((40_000, 300_000, 40_000, 600_000, 20_000, 40_000), 4),  # three classes, 4 ranks
])
def test_stack_mesh_shard_groups_rank_by_rank(sizes, n_index):
    ref_built = _sizes(sizes)
    assert len(ref_built.shards) == len(sizes)
    ref_groups, ref_tb = ref_pl.stack_mesh_shard_groups(ref_built.shards, n_index)
    built = convert.built_from_reference(ref_built)
    groups, tb = pl.stack_mesh_shard_groups(built.shards, n_index, [CPU] * n_index)
    assert tb == ref_tb and len(groups) == len(ref_groups)
    n_empty = 0
    for g, rg in zip(groups, ref_groups):
        assert len(g) == n_index
        s_c = np.asarray(rg.mz_rows).shape[0] // n_index
        for r, stack in enumerate(g):
            sl = slice(r * s_c, (r + 1) * s_c)
            assert np.array_equal(stack.mz_rows.numpy().view(np.uint32),
                                  np.asarray(rg.mz_rows)[sl])
            assert np.array_equal(stack.pos_acc.numpy(), np.asarray(rg.pos_acc)[sl])
            assert np.array_equal(stack.ref_codes.numpy(), np.asarray(rg.ref_codes)[sl])
            n_empty += int((stack.mz_rows.reshape(s_c, -1) == 0).all(dim=1).sum())
    if len(sizes) % n_index or len(set(map(pl._size_class, sizes))) > 1:
        assert n_empty > 0  # the inert padding shards are there
    # a rank held by another process is skipped
    skipped, _ = pl.stack_mesh_shard_groups(built.shards, n_index, [None] + [CPU] * (n_index - 1))
    assert all(g[0] is None and g[1] is not None for g in skipped)


def _ref_mesh_run(world, n_data, n_index, params, codes, lengths, count_mode):
    mesh = ref_pm.make_mesh(n_data=n_data, n_index=n_index,
                            devices=jax.devices()[: n_data * n_index])
    groups, tb = ref_pl.stack_mesh_shard_groups(world["ref_built"].shards, n_index)
    params = params._replace(tag_bits=tb)
    with mesh:
        index = tuple(ref_pm.shard_index(mesh, g) for g in groups)
        step = ref_dist.make_sharded_classifier(mesh, params, world["ref_built"].meta.n_accessions,
                                                count_mode, index_tree=index)
        dcodes, dlens = ref_pm.shard_reads(mesh, jnp.asarray(codes), jnp.asarray(lengths))
        res, counts = step(index, dcodes, dlens)
    return {f: np.asarray(getattr(res, f)) for f in ref_pl.ReadResult._fields}, np.asarray(counts)


def _port_mesh_run(world, mesh, params, codes, lengths, count_mode):
    index, tb = pm.shard_index(mesh, world["built"].shards)
    step = dist.make_sharded_classifier(mesh, params._replace(tag_bits=tb),
                                        world["built"].meta.n_accessions, count_mode, index)
    res, counts = step(pm.shard_reads(mesh, codes, lengths))
    rows = sorted(res)
    out = {f: np.concatenate([getattr(res[d], f).numpy() for d in rows])
           for f in pl.ReadResult._fields}
    return out, np.stack([counts[d].numpy() for d in rows])


@pytest.mark.parametrize("n_data,n_index,count_mode", [
    (1, 2, pl.MODE_QUERY_LENGTH), (2, 2, pl.MODE_QUERY_LENGTH), (2, 3, pl.MODE_QUERY_LENGTH),
    (4, 2, pl.MODE_QUERY_LENGTH), (2, 3, pl.MODE_MATCHING)])
def test_mesh_step_matches_jax(world, n_data, n_index, count_mode):
    """status, acc_id, rc and the counts bit-equal; mlen as FLOAT_RTOL's
    note says; mapq and identity within FLOAT_RTOL.  The gather order is
    rank-major (each rank's shards in size-class order, inert padding in
    place), as the JAX step's.  The JAX step gets the codes that the
    port's 2-bit wire carries (PAD past a read's end becomes 0): the JAX
    mesh path uploads raw codes where its single-device path packs them
    (ROADMAP.md section 3)."""
    (b,) = ref_enc.bucketize_reads(world["reads"])
    b = ref_enc.pad_rows(b, 8)
    b = ref_enc.ReadBatch(np.where(b.codes < 4, b.codes, 0).astype(np.uint8), b.lengths, b.idx)
    ref_params = ref_pl.ClassifyParams(n_slots=64, extend_impl="jnp",
                                       extend_mode="full" if count_mode == pl.MODE_MATCHING
                                       else "rescue")
    ref, ref_counts = _ref_mesh_run(world, n_data, n_index, ref_params, b.codes, b.lengths,
                                    count_mode)
    mesh = pm.make_mesh(n_data, n_index, devices=[CPU] * (n_data * n_index))
    assert mesh.shape == {"data": n_data, "index": n_index} and mesh.local_rows() == list(
        range(n_data))
    port, counts = _port_mesh_run(world, mesh, convert.params_from_reference(ref_params),
                                  b.codes, b.lengths, count_mode)
    for f in ("status", "acc_id", "rc"):
        assert np.array_equal(port[f], ref[f]), f
    dm = np.abs(port["mlen"].astype(np.int64) - ref["mlen"])
    assert dm.max() <= (0 if count_mode == pl.MODE_MATCHING else 1)
    for f in ("mapq", "inv_identity"):
        np.testing.assert_allclose(port[f], ref[f], rtol=FLOAT_RTOL, atol=0)
    assert counts.shape == ref_counts.shape and np.array_equal(counts, ref_counts)
    real = b.idx >= 0
    mapped = port["status"][real] == pl.MAPPED
    assert mapped.mean() > 0.7
    assert (port["acc_id"][real][mapped] == np.asarray(world["labels"])[b.idx[real]][mapped]).all()


def test_mesh_1x3_equals_single_device_classifier(world, tmp_path):
    """A (1, 3) mesh (two shards a rank and one inert shard) against the
    single-device Classifier: status, acc_id, mlen and counts of fetch,
    and run_once's routed FASTQs and accumulator byte for byte."""
    params = pl.ClassifyParams(n_slots=64)
    mesh = pm.make_mesh(1, 3, devices=[CPU] * 3)
    mclf = rt.Classifier(world["built"], params, count_mode="basic", mesh=mesh)
    sclf = rt.Classifier(world["built"], params, count_mode="basic", device=CPU)
    assert mclf.batch_row_multiple() == 1 and mclf.params == sclf.params
    assert [len(mclf.index[(0, i)]) for i in range(3)] == [1, 1, 1]
    assert [mclf.index[(0, i)][0].mz_rows.shape[0] for i in range(3)] == [2, 2, 2]
    for b in enc.bucketize_reads(world["reads"]):
        got = mclf.fetch(*mclf.classify(b.codes, b.lengths))
        want = sclf.fetch(*sclf.classify(b.codes, b.lengths))
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    outs = {}
    for name, c in (("single", sclf), ("mesh", mclf)):
        q, out = tmp_path / f"q_{name}", tmp_path / f"o_{name}"
        q.mkdir()
        make_fastq(q / "s1.fastq", world["reads"][:30])
        make_fastq(q / "s2.fastq", world["reads"][30:])
        reports = rt.run_once(c, q, out)
        state = AbundanceState.load(out, c.meta.n_accessions)
        outs[name] = (sorted((r.sample, r.n_mapped, r.n_ambiguous) for r in reports),
                      {k: v.copy() for k, v in state.samples.items()},
                      {p.name: p.read_bytes() for p in sorted((q / "mapped").glob("*.fastq"))})
    assert outs["single"][0] == outs["mesh"][0]
    assert outs["single"][1].keys() == outs["mesh"][1].keys()
    assert all(np.array_equal(outs["single"][1][k], outs["mesh"][1][k]) for k in outs["single"][1])
    assert outs["single"][2] == outs["mesh"][2] and sum(r[1] for r in outs["mesh"][0]) >= 50


def test_mesh_classifier_pads_rows_and_sums_counts(world):
    """A (4, 2) mesh: the runtime pads batches to 4 rows a multiple; the
    fetch sums the data rows' counts and returns rows in batch order."""
    params = pl.ClassifyParams(n_slots=64)
    mesh = pm.make_mesh(4, 2, devices=[CPU] * 8)
    mclf = rt.Classifier(world["built"], params, count_mode="basic", mesh=mesh)
    sclf = rt.Classifier(world["built"], params, count_mode="basic", device=CPU)
    assert mclf.batch_row_multiple() == 4
    (b,) = enc.bucketize_reads(world["reads"][:30])
    b = enc.pad_rows(b, mclf.batch_row_multiple())
    got = mclf.fetch(*mclf.classify(b.codes, b.lengths))
    want = sclf.fetch(*sclf.classify(b.codes, b.lengths))
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    assert got[3].sum() == (got[0] == pl.MAPPED).sum() > 20
    with pytest.raises(ValueError, match="data rows"):
        mclf.classify(b.codes[:30], b.lengths[:30])


def test_resolve_mesh_divisor_policy(monkeypatch):
    """Auto mode picks the largest device-count divisor <= n_shards;
    an explicit n_data clamps the index axis to fit (8 cards)."""
    from monica_tpu_torch.orchestrate import resolve_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for n_data, n_shards, shape in ((-1, 5, (2, 4)), (-1, 3, (4, 2)), (-1, 16, (1, 8)),
                                    (4, 5, (4, 2))):
        mesh = resolve_mesh(n_data, n_shards, "cuda")
        assert (mesh.shape["data"], mesh.shape["index"]) == shape
        assert len({d for row in mesh.devices for d in row}) == shape[0] * shape[1]
    assert resolve_mesh(1, 5, "cuda") is None


def test_shard_reads_single_process():
    """shard_reads splits a batch into one block per data row, 2-bit
    packed, once per distinct device of the row; a batch that does not
    split into the rows is refused."""
    mesh = pm.make_mesh(4, 2, devices=[CPU] * 8)
    codes = np.random.default_rng(0).integers(0, 5, (8, 13)).astype(np.uint8)
    lengths = np.arange(8, dtype=np.int32) + 6
    reads = pm.shard_reads(mesh, codes, lengths)
    assert reads.read_len == 13 and sorted(reads.blocks) == [0, 1, 2, 3]
    assert all(list(v) == [CPU] for v in reads.blocks.values())
    back = np.concatenate([pl.unpack_codes(reads.blocks[d][CPU][0], 13).numpy() for d in range(4)])
    assert np.array_equal(back, np.where(codes < 4, codes, 0))
    assert np.array_equal(np.concatenate([reads.blocks[d][CPU][1].numpy() for d in range(4)]),
                          lengths)
    with pytest.raises(ValueError, match="data rows"):
        pm.shard_reads(mesh, codes[:7], lengths[:7])


def test_sync_batch_schedule_slot_overflow():
    """A sample needing more than the plan's slots fails with a clear
    message instead of silently truncating; under the limit, one
    process's schedule is its own batches, bucket by bucket."""
    batches = [enc.ReadBatch(np.zeros((4, 512), np.uint8), np.zeros(4, np.int32),
                             np.zeros(4, np.int32)) for _ in range(rt._MAX_SCHED_SLOTS + 1)]
    with pytest.raises(ValueError, match="max_batch"):
        rt._sync_batch_schedule(batches)
    mixed = [enc.ReadBatch(np.zeros((n, L), np.uint8), np.zeros(n, np.int32),
                           np.arange(n, dtype=np.int32)) for n, L in ((3, 1024), (5, 512), (2, 512))]
    out = rt._sync_batch_schedule(mixed)
    assert [(b.bucket_len, len(b)) for b in out] == [(512, 5), (512, 2), (1024, 3)]

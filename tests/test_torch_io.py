"""The port's host I/O, encoding and read generators give the same
output as the JAX package's (same inputs, same generator seeds)."""

import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ref_ev
from monica_tpu.index import minimizer as ref_mz
from monica_tpu.io import encode as ref_enc
from monica_tpu.io import seq as ref_seq
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.index import build
from monica_tpu_torch.index import minimizer as mz
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.io import seq as seqio
from tests.fixtures import make_fasta_gz, random_genome

torch.set_num_threads(1)


def test_encode_seq_matches_reference():
    s = "ACGTacgtNnRYKM-*" * 5
    np.testing.assert_array_equal(enc.encode_seq(s), ref_enc.encode_seq(s))
    np.testing.assert_array_equal(enc.encode_seq(s.encode()), ref_enc.encode_seq(s.encode()))
    assert enc.N_CODE == ref_enc.N_CODE and enc.PAD_CODE == ref_enc.PAD_CODE


@pytest.mark.parametrize("L", [1, 37, 1024])
def test_pack_codes_2bit_matches_reference(L):
    codes = np.random.default_rng(L).integers(0, 5, (6, L)).astype(np.uint8)
    got, want = enc.pack_codes_2bit(codes), ref_enc.pack_codes_2bit(codes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("guard", [0, 32])
def test_packed_seqs_builder_matches_reference(guard):
    rng = np.random.default_rng(guard)
    recs = [(rng.integers(0, 4, n).astype(np.uint8), i % 2) for i, n in enumerate((5, 90, 17))]
    got, want = enc.PackedSeqsBuilder(guard), ref_enc.PackedSeqsBuilder(guard)
    for r, aid in recs:
        got.add(r, aid)
        want.add(r, aid)
    got, want = got.build(), want.build()
    for f in ("codes", "starts", "lengths", "seq_accession_id"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_read_fasta_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "g.fna.gz"
    make_fasta_gz(path, [("ctg1 desc words", random_genome(rng, 500)),
                         ("ctg2", random_genome(rng, 90))])
    got, want = list(seqio.read_fasta(path)), list(ref_seq.read_fasta(path))
    assert [(r.id, r.seq, r.desc) for r in got] == [(r.id, r.seq, r.desc) for r in want]


@pytest.mark.parametrize("frac", [1.0, 0.5, 1e-12, 0.999999999999])
def test_frac_threshold_matches_reference(frac):
    assert mz.frac_threshold(frac) == int(ref_mz.frac_threshold(frac))
    assert (mz.K_DEFAULT, mz.W_DEFAULT, mz.FRAC_DEFAULT) == (
        ref_mz.K_DEFAULT, ref_mz.W_DEFAULT, ref_mz.FRAC_DEFAULT)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_chunked_host_sketch_matches_reference(frac):
    """Chunks far smaller than the array: the overlap must reproduce the
    whole-array selection exactly."""
    codes = np.random.default_rng(4).integers(0, 4, 20_000).astype(np.uint8)
    codes[5000:5040] = 4
    h, pos, s = build.sketch_long_sequence(codes, 15, 10, chunk=999, frac=frac)
    wh, wpos, ws = ref_mz.sketch_sequence_np(codes, 15, 10, frac=frac)
    np.testing.assert_array_equal(h, wh)
    np.testing.assert_array_equal(pos, wpos)
    np.testing.assert_array_equal(s, ws.astype(np.uint8))


def test_zymo_community_matches_reference():
    got = ev.zymo_community(np.random.default_rng(3), scale=1e-3)
    want = ref_ev.zymo_community(np.random.default_rng(3), scale=1e-3)
    assert [len(g) for g in got] == [5000] * 8 + [12000] * 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hp_bias", [1.0, 3.0])
def test_simulate_read_codes_matches_reference(hp_bias):
    genome = np.random.default_rng(0).integers(0, 4, 20_000).astype(np.uint8)
    genome[100:110] = 2  # a homopolymer run
    rg, rw = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(12):
        args = (genome, 800, 0.1, 0.05, 0.05, bool(i & 1), hp_bias)
        np.testing.assert_array_equal(ev.simulate_read_codes(rg, *args),
                                      ref_ev.simulate_read_codes(rw, *args))


def test_bench_and_sim_batch_draws():
    seqs = ev.zymo_community(np.random.default_rng(3), scale=1e-3)
    codes, labels = ev.bench_reads(seqs, np.random.default_rng(1), 64, read_len=300, sub=0.05)
    assert codes.shape == (64, 300) and codes.max() < 4 and labels.max() < len(seqs)
    c, ln, lab = ev.sim_batch(seqs, np.random.default_rng(1), 8, 200, 400,
                              (0.05, 0.02, 0.02), 512)
    assert c.shape == (8, 512) and (ln >= 1).all() and (ln <= 400).all()
    for row, n in zip(c, ln):
        assert (row[n:] == 4).all() and (row[:n] < 4).all()
    assert lab.shape == (8,)

"""The port's host I/O, encoding and read generators give the same
output as the JAX package's (same inputs, same generator seeds)."""

import gzip
import io
from pathlib import Path

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


def test_decode_and_revcomp_match_reference():
    codes = np.random.default_rng(9).integers(0, 6, 50).astype(np.uint8)
    assert enc.decode_seq(codes) == ref_enc.decode_seq(codes)
    np.testing.assert_array_equal(enc.revcomp_codes(codes), ref_enc.revcomp_codes(codes))


@pytest.mark.parametrize("max_batch", [None, 3])
@pytest.mark.parametrize("buckets", [ref_enc.DEFAULT_BUCKETS, (512, 1024)])
def test_window_plan_and_bucketize_match_reference(buckets, max_batch):
    rng = np.random.default_rng(10)
    lengths = [1, 300, 512, 513, 1024, 1025, 1024 + 255, 1024 + 256, 4000, 70_000, 32_768]
    lengths += rng.integers(1, 3_000, 12).tolist()
    assert enc.window_plan(lengths, buckets, max_batch) == ref_enc.window_plan(
        lengths, buckets, max_batch)
    seqs = [random_genome(rng, n) for n in lengths[:-2]]
    seqs[3] = "ACGTNRY" * 73 + "acg"
    got, want = enc.bucketize_reads(seqs, buckets, max_batch), ref_enc.bucketize_reads(
        seqs, buckets, max_batch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.bucket_len == w.bucket_len and len(g) == len(w)
        for f in ("codes", "lengths", "idx"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert enc.bucket_for_length(40_000) == ref_enc.bucket_for_length(40_000) == 32768
    assert (enc.DEFAULT_BUCKETS, enc.MIN_TAIL) == (ref_enc.DEFAULT_BUCKETS, ref_enc.MIN_TAIL)


@pytest.mark.parametrize("kw", [dict(multiple=4), dict(multiple=1), dict(target=9)])
def test_pad_rows_matches_reference(kw):
    rng = np.random.default_rng(11)
    seqs = [random_genome(rng, int(n)) for n in rng.integers(100, 500, 5)]
    got = enc.pad_rows(enc.bucketize_reads(seqs)[0], **kw)
    want = ref_enc.pad_rows(ref_enc.bucketize_reads(seqs)[0], **kw)
    for f in ("codes", "lengths", "idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_read_write_fastq_and_list_samples_match_reference(tmp_path):
    rng = np.random.default_rng(12)
    body = "".join(f"@r{i} desc {i}\n{random_genome(rng, 50 + i)}\n+\n{'I' * (50 + i)}\n"
                   for i in range(5))
    (tmp_path / "a.fastq").write_text("\n" + body)
    (tmp_path / "b.fastq.gz").write_bytes(gzip.compress(body.encode()))
    (tmp_path / "empty.fastq").write_text("")
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "sub.fastq").mkdir()
    for name in ("a.fastq", "b.fastq.gz"):
        got = list(seqio.read_fastq(tmp_path / name))
        want = list(ref_seq.read_fastq(tmp_path / name))
        assert [(r.id, r.seq, r.qual, r.desc) for r in got] == [
            (r.id, r.seq, r.qual, r.desc) for r in want]
    for new_id in (None, "Tax_unit"):
        a, b = io.StringIO(), io.StringIO()
        for r, w in zip(seqio.read_fastq(tmp_path / "a.fastq"), ref_seq.read_fastq(tmp_path / "a.fastq")):
            seqio.write_fastq_record(a, r, new_id=new_id)
            ref_seq.write_fastq_record(b, w, new_id=new_id)
            seqio.write_fasta_record(a, r, new_id=new_id, width=7)
            ref_seq.write_fasta_record(b, w, new_id=new_id, width=7)
        assert a.getvalue() == b.getvalue()
    assert seqio.list_sample_files(tmp_path) == ref_seq.list_sample_files(tmp_path)
    assert [p.name for p in seqio.list_sample_files(tmp_path)] == ["a.fastq"]
    assert seqio.sample_name(tmp_path / "x.y.fastq") == ref_seq.sample_name("x.y.fastq") == "x"
    (tmp_path / "bad.fastq").write_text(">not fastq\nACGT\n")
    with pytest.raises(ValueError, match="malformed"):
        list(seqio.read_fastq(tmp_path / "bad.fastq"))


@pytest.fixture
def fastq_file(tmp_path):
    rng = np.random.default_rng(13)
    recs = [f"@read{i} len={50 + 7 * i}\t x\n{random_genome(rng, 50 + 7 * i)}\n+\n{'I' * (50 + 7 * i)}\n"
            for i in range(40)]
    recs[3] = recs[3].replace("\n", "\r\n")  # CRLF lines
    path = tmp_path / "s.fastq"
    path.write_text("\n".join(recs))  # blank lines between records
    return path


def test_native_parser_matches_reference(fastq_file):
    from monica_tpu.io import native as ref_native
    from monica_tpu_torch.io import native

    assert native.available() and ref_native.available()
    native.reset_counts()
    got, want = native.parse_fastq_file(fastq_file), ref_native.parse_fastq_file(fastq_file)
    assert native.PARSED == {"views": 1}
    assert len(got) == len(want) == 40
    for f in ("rec_off", "rec_len", "id_off", "id_len", "seq_off", "seq_len"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    sel = np.array([5, 0, 39, 3, 3])
    assert bytes(got.concat_records(sel)) == bytes(want.concat_records(sel))
    assert bytes(got.concat_records_with_id(sel, b"Sp_x")) == bytes(
        want.concat_records_with_id(sel, b"Sp_x"))
    assert got.record_bytes(2) == want.record_bytes(2)
    assert got.read_id(7) == want.read_id(7) == b"read7"
    rows = np.arange(40)
    a, b = np.full((40, 400), 4, np.uint8), np.full((40, 400), 4, np.uint8)
    got.encode_rows(rows, a)
    want.encode_rows(rows, b)
    np.testing.assert_array_equal(a, b)
    off, wl = rows % 30, np.full(40, 64)
    a, b = np.full((40, 64), 4, np.uint8), np.full((40, 64), 4, np.uint8)
    got.encode_rows(rows, a, offsets=off, window_lens=wl)
    want.encode_rows(rows, b, offsets=off, window_lens=wl)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="malformed"):
        native.parse_fastq_bytes(b"@r\nACGT\nnot a plus line\nIIII\n")


@pytest.mark.parametrize("chunk", [1 << 9, 1 << 12, 1 << 20])
def test_native_chunked_views_match_reference(fastq_file, chunk):
    from monica_tpu.io import native as ref_native
    from monica_tpu_torch.io import native

    def records(mod):
        return [bytes(v.concat_records(np.arange(len(v))))
                for v in mod.iter_fastq_file_views(fastq_file, chunk_bytes=chunk)]

    got = records(native)
    assert got == records(ref_native)
    whole = native.parse_fastq_file(fastq_file)
    assert b"".join(got) == bytes(whole.concat_records(np.arange(len(whole))))
    bad = fastq_file.with_name("bad.fastq")
    bad.write_text("@r0 x\nACGT\n+\nIIII\n" * 60 + "not a record\n" + "@r1\nA\n+\nI\n" * 60)
    with pytest.raises(ValueError, match="malformed"):
        list(native.iter_fastq_file_views(bad, chunk_bytes=1 << 9))


def test_native_library_builds_into_the_port_build_dir(monkeypatch, tmp_path):
    from monica_tpu_torch.io import native

    monkeypatch.setenv("MONICA_TORCH_BUILD_DIR", str(tmp_path / "b"))
    path = native.library_path()
    assert path.parent == tmp_path / "b" and path.name.startswith("libmonica_io_")
    assert native.SRC.parent == Path(native.__file__).parent
    assert native.SRC.read_bytes().split(b"#include <cstdint>")[1] == (
        Path(ref_seq.__file__).parent / "native" / "fastq.cpp").read_bytes().split(
        b"#include <cstdint>")[1]


def test_gut_community_and_nanopore_draws(tmp_path):
    rng, want = np.random.default_rng(3), np.random.default_rng(3)
    for g in ev.gut_community(rng):  # what bench.py --gut draws
        np.testing.assert_array_equal(g, want.integers(0, 4, 1_500_000).astype(np.uint8))
    lens = ev.nanopore_lengths(np.random.default_rng(1), 5000)
    assert lens.min() >= 300 and lens.max() <= 40_000 and (lens > 32_768).sum() > 50
    genomes = [np.random.default_rng(i).integers(0, 4, 50_000).astype(np.uint8) for i in range(3)]
    reads, labels = ev.nanopore_sample(genomes, np.random.default_rng(2), [300, 5000, 20_000],
                                       (0.05, 0.03, 0.03))
    assert len(reads) == 3 and labels.shape == (3,) and all(len(r) > 0 for r in reads)
    ev.write_fastq_sample(tmp_path / "s.fastq", reads)
    back = list(seqio.read_fastq(tmp_path / "s.fastq"))
    assert [r.id for r in back] == ["read0", "read1", "read2"]
    assert [r.seq for r in back] == [enc.decode_seq(r) for r in reads]

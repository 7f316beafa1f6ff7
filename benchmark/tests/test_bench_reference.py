"""The frozen reference against the port at CPU size: the index it
rebuilds, its SW, and every read's answer on both configurations' code
paths (one shard; grouped shards merged) in both count modes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import world
from benchmark.reference import classify as rcls
from benchmark.reference import index as ridx
from benchmark.reference import sw as rsw
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align.runtime import Classifier
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.ops import extend as ex

GENOMES = {"genomes": [{"count": 6, "length": 150_000}]}


def _traffic(tiny_bench, name):
    return json.loads((tiny_bench / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("shards", [1, 3])
def test_index_equals_the_ports(shards):
    g = world.draw_genomes(GENOMES, 11, "cpu")
    clf = Classifier(build_index_from_arrays(g, n_shards=shards, device="cpu"),
                     pl.ClassifyParams(), "query_length", device="cpu")
    ref = ridx.build(g, shards, 15, 10, 1.0, "cpu")
    assert ref.tag_bits == clf.params.tag_bits
    if shards == 1:
        prog = [clf.index]
    else:
        prog = [pl.DeviceIndexShard(gr.mz_rows[s], gr.pos_acc[s], gr.ref_codes[s])
                for gr in clf.index for s in range(gr.mz_rows.shape[0])]
    assert len(prog) == len(ref.shards)
    for p, r in zip(prog, ref.shards):
        assert torch.equal(p.mz_rows, r.table)
        assert torch.equal(p.pos_acc.long(), r.pos_acc)
        assert torch.equal(p.ref_codes, r.ref_codes)


@pytest.mark.parametrize("shards,mix", [(1, "r9_query"), (1, "r9_matching"),
                                        (3, "r9_query"), (3, "r9_matching")])
def test_answers_equal_the_ports(tiny_bench, shards, mix):
    traffic = _traffic(tiny_bench, mix)
    g = world.draw_genomes(GENOMES, 12, "cpu")
    pool = world.make_pool(g, world.genome_weights(GENOMES), traffic, 12)
    mode = traffic["count_mode"]
    clf = Classifier(build_index_from_arrays(g, n_shards=shards, device="cpu"),
                     pl.ClassifyParams(), mode, device="cpu")
    ref = ridx.build(g, shards, 15, 10, 1.0, "cpu")
    p = rcls.Params()
    expected = rcls.classify(ref, [(b.codes, b.lengths) for b in pool], p, mode == "matching",
                             "cpu")
    extended = 0
    for b, (es, ea, em) in zip(pool, expected):
        st, ac, ml, counts = clf.fetch(*clf.classify(b.codes, b.lengths))
        np.testing.assert_array_equal(st, es)
        np.testing.assert_array_equal(ac, ea)
        np.testing.assert_array_equal(ml, em)
        np.testing.assert_array_equal(
            counts, rcls.count_reads(st, ac, ml, b.lengths, len(g), mode))
        extended += sum(len(r) for r in rcls.candidates(ref, b.codes, b.lengths, p,
                                                        mode == "matching", "cpu"))
    if mode == "matching" or shards > 1:  # every read extended, or rescues on foreign shards
        assert extended > 0
    assert (np.concatenate([e[0] for e in expected]) == rcls.MAPPED).mean() > 0.9


@pytest.mark.parametrize("pair", [False, True])
def test_sw_equals_the_ports_plain_version(pair, monkeypatch):
    rng = np.random.default_rng(3)
    B, L, W = 9, 300, 64
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    win = np.concatenate([q, rng.integers(0, 4, (B, W)).astype(np.uint8)], 1)
    noise = rng.random(win.shape) < 0.1
    win[noise] = rng.integers(0, 4, int(noise.sum()))
    win = np.roll(win, 3, axis=1)
    lengths = np.array([0, 1, 17, 100, 299, 300, 250, 300, 64], np.int32)
    q = np.where(np.arange(L)[None, :] < lengths[:, None], q, 4).astype(np.uint8)
    if pair:
        monkeypatch.setattr(ex, "packed_mbits", lambda L, p: 0)
    s, m = ex.banded_sw_torch(torch.from_numpy(q), torch.from_numpy(win),
                              torch.from_numpy(lengths), ex.ExtendParams(band=W))
    rs, rm = rsw.banded_sw(q, win, lengths, W, 32768 if pair else L)
    np.testing.assert_array_equal(rs, s.numpy())
    np.testing.assert_array_equal(rm, m.numpy())


def test_int16_control_breaks_long_reads():
    """The control's 16-bit DP wraps where a read's score passes 2^15."""
    rng = np.random.default_rng(4)
    L, W = 20_000, 64
    q = rng.integers(0, 4, (2, L)).astype(np.uint8)
    win = np.concatenate([q, np.full((2, W), 4, np.uint8)], 1)
    win = np.roll(win, W // 2, axis=1)
    lengths = np.array([L, 5_000], np.int32)
    exact = rsw.banded_sw(q, win, lengths, W, 32768)
    low = rsw.banded_sw(q, win, lengths, W, 32768, int16=True)
    assert list(exact[0]) == [2 * L, 2 * 5_000] and list(exact[1]) == [L, 5_000]
    assert low[0][0] != exact[0][0]  # 40,000 does not fit 16 bits
    assert (low[0][1], low[1][1]) == (exact[0][1], exact[1][1])

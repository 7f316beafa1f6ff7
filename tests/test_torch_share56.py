"""The ``share56`` deployment (``benchmark/configs/share56.json``: one
index rank's share of the pod-scale RefSeq index, genomes by ``count``
in many equal shards stacked on the device) cut to CPU size: the port's
``Classifier`` against the benchmark's plain reference
(``benchmark/reference``), read by read, in both count modes the
benchmark's mixes use."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import world
from benchmark.reference import classify as rcls
from benchmark.reference import index as ridx
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align.runtime import Classifier
from monica_tpu_torch.index.build import build_index_from_arrays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 5
# CPU size: 16 genomes of 30 kb in 8 shards of 2 (the share: 1,232 of
# 3 Mb in 56 shards of 22), reads of a 1.5 kb mean
N_GENOMES, LENGTH, N_SHARDS = 16, 30_000, 8


def _load(kind, name):
    return json.loads((ROOT / "benchmark" / kind / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def share():
    config = _load("configs", "share56")
    assert config["n_shards"] == 56 and config["genomes"] == [
        {"name": "refseq_3mb", "length": 3_000_000, "count": 1232}]
    config = dict(config, n_shards=N_SHARDS,
                  genomes=[dict(g, length=LENGTH, count=N_GENOMES) for g in config["genomes"]])
    genomes = world.draw_genomes(config, SEED, "cpu")
    ix = config["index"]
    built = build_index_from_arrays(genomes, n_shards=config["n_shards"], k=ix["k"], w=ix["w"],
                                    frac=ix["frac"], device="cpu")
    ref = ridx.build(genomes, config["n_shards"], ix["k"], ix["w"], ix["frac"], "cpu")
    return dict(config=config, genomes=genomes, built=built, ref=ref)


@pytest.mark.parametrize("mix", ["r9_query", "r9_matching"])
def test_share_answers_equal_the_reference(share, mix):
    config, genomes, ref = share["config"], share["genomes"], share["ref"]
    traffic = _load("traffic", mix)
    traffic.update(file_reads=40, pool_files=1)
    traffic["lengths"].update(mean=1500, sd=1000)
    mode = traffic["count_mode"]
    assert mode == {"r9_query": "query_length", "r9_matching": "matching"}[mix]
    pool = world.make_pool(genomes, world.genome_weights(config), traffic, SEED)
    clf = Classifier(share["built"], pl.ClassifyParams(**config["classify"]), mode, device="cpu")
    # a stacked index of every shard, as on the card
    assert len(share["built"].shards) == len(ref.shards) == N_SHARDS and ref.grouped
    assert sum(g.mz_rows.shape[0] for g in clf.index) == N_SHARDS
    p = rcls.Params(k=config["index"]["k"], w=config["index"]["w"],
                    frac=config["index"]["frac"], **config["classify"])
    expected = rcls.classify(ref, [(b.codes, b.lengths) for b in pool], p, mode == "matching",
                             "cpu")
    extended = 0
    for b, (es, ea, em) in zip(pool, expected):
        st, ac, ml, counts = clf.fetch(*clf.classify(b.codes, b.lengths))
        np.testing.assert_array_equal(st, es)
        np.testing.assert_array_equal(ac, ea)
        np.testing.assert_array_equal(ml, em)
        np.testing.assert_array_equal(counts, rcls.count_reads(es, ea, em, b.lengths,
                                                               len(genomes), mode))
        extended += sum(len(r) for r in rcls.candidates(ref, b.codes, b.lengths, p,
                                                        mode == "matching", "cpu"))
    assert extended > 0  # every read (matching) or the rescues on foreign shards
    got = np.concatenate([e[1] for e in expected])
    truth = np.concatenate([b.source for b in pool])
    assert (got == truth).mean() > 0.9

"""The port's trace spans (``utils.metrics.span``) on the CPU: where
``Classifier.classify`` and ``fetch`` open them and how they nest, the
rescue tier's counts in their names, the answers unchanged under the
profiler, and no ``record_function`` without one."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.ops import chain as ch
from monica_tpu_torch.ops import lookup as lk
from monica_tpu_torch.utils import metrics

torch.set_num_threads(1)

N_GENOMES = 4


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(13)
    seqs = [rng.integers(0, 4, 40_000).astype(np.uint8) for _ in range(N_GENOMES)]
    built = {n: build_index_from_arrays(seqs, n_shards=n, device="cpu") for n in (1, 2)}
    # high error, so some reads fail the vote gate and go to the rescue
    B, L = 32, 512
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(300, L + 1))
        r = ev.simulate_read_codes(rng, seqs[i % N_GENOMES], n, 0.10, 0.04, 0.04, bool(i & 1))
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return dict(built=built, codes=codes, lengths=lengths)


def _traced(clf, codes, lengths):
    """classify + fetch under a CPU profile: (answers, [(span name,
    enclosing span name or None)])."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = clf.fetch(*clf.classify(codes, lengths))
    found = []
    for e in prof.events():
        if not metrics.is_span(e.name):
            continue
        p = e.cpu_parent
        while p is not None and not metrics.is_span(p.name):
            p = p.cpu_parent
        found.append((e.name, None if p is None else p.name))
    return out, found


def _base(name):
    return name.split(" ")[0][len(metrics.SPAN_PREFIX):]


def _rescue_tiers(clf, codes, lengths):
    """(candidates, slots) of each shard's rescue, recomputed from the
    batch as the Classifier sends it (2-bit packed) with the pipeline's
    gate and tier rule."""
    B, L = codes.shape
    params = pl.params_for_bucket(clf.params, L)
    c = pl.unpack_codes(torch.from_numpy(enc.pack_codes_2bit(codes)), L)
    ln = torch.from_numpy(lengths)
    shards = ([clf.index] if isinstance(clf.index, pl.DeviceIndexShard) else
              [pl.DeviceIndexShard(g.mz_rows[s], g.pos_acc[s], g.ref_codes[s])
               for g in clf.index for s in range(g.mz_rows.shape[0])])
    qh, qp, qs, qv = pl.sketch_batch(c, ln, params)
    out = []
    for sh in shards:
        anchors = lk.lookup_anchors(sh.mz_rows, qh, qp, qs, qv, tag_bits=params.tag_bits,
                                    bucket_len=L, anchors_per_seed=params.anchors_per_seed)
        res = ch.chain_votes(*anchors, max_run=min(128, params.n_slots))
        passed = ((ch.mapq_from_votes(res.f1, res.f2) >= params.mapping_quality)
                  & (res.f1 >= params.min_votes) & (ln > 0))
        cand = (~passed & (res.f1 >= params.rescue_min_votes) & (res.f2 * 2 <= res.f1)
                & (ln > 0))
        n = int(cand.sum())
        if n:
            n8, n2 = max(int(B * params.rescue_frac), 1), max(B // 2, 1)
            out.append((n, n8 if n <= n8 else n2 if n <= n2 else B))
    return out


@pytest.mark.parametrize("count_mode", ["query_length", "matching"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_classify_and_fetch_open_their_spans(world, n_shards, count_mode):
    clf = rt.Classifier(world["built"][n_shards], count_mode=count_mode, device="cpu")
    codes, lengths = world["codes"], world["lengths"]
    plain = clf.fetch(*clf.classify(codes, lengths))
    out, found = _traced(clf, codes, lengths)
    # the answers do not change under the profiler
    for a, b in zip(plain, out):
        np.testing.assert_array_equal(a, b)

    parents = {}
    for name, parent in found:
        parents.setdefault(_base(name), set()).add(None if parent is None else _base(parent))
    shard_or_pipeline = {"shard"} if n_shards == 2 else {"pipeline"}
    want = {"classify": {None}, "pack": {"classify"}, "upload": {"classify"},
            "pipeline": {"classify"}, "unpack": {"pipeline"}, "sketch": {"pipeline"},
            "lookup": shard_or_pipeline, "chain": shard_or_pipeline,
            "merge": {"pipeline"}, "count": {"pipeline"},
            "fetch": {None}, "pack_results": {"fetch"}, "copy": {"fetch"}, "split": {"fetch"}}
    if n_shards == 2:
        want["shard"] = {"pipeline"}
    if count_mode == "query_length":
        want["rescue_pick"] = shard_or_pipeline
        want["rescue"] = shard_or_pipeline
    else:
        want["extend"] = shard_or_pipeline
    assert parents == want

    names = [n for n, _ in found]
    B, L = codes.shape
    assert f"monica.classify rows={B} len={L}" in names
    shards = sorted(n for n in names if _base(n) == "shard")
    assert shards == ([] if n_shards == 1 else
                      sorted(f"monica.shard group={g} shard={s}"
                             for g, grp in enumerate(clf.index)
                             for s in range(grp.mz_rows.shape[0])))
    rescues = [n for n in names if _base(n) == "rescue"]
    if count_mode == "query_length":
        tiers = _rescue_tiers(clf, codes, lengths)
        assert tiers, "the batch sends no read to the rescue"
        assert rescues == [f"monica.rescue cand={c} slots={s}" for c, s in tiers]
    else:
        assert names.count(f"monica.extend rows={B}") == n_shards


@pytest.mark.parametrize("n_shards", [1, 2])
def test_no_profiler_no_record_function(world, monkeypatch, n_shards):
    clf = rt.Classifier(world["built"][n_shards], device="cpu")
    want = clf.fetch(*clf.classify(world["codes"], world["lengths"]))

    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(metrics, "record_function", refuse)
    got = clf.fetch(*clf.classify(world["codes"], world["lengths"]))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    with metrics.Metrics(verbose=False).stage("parse:s"):
        pass


def test_span_names_carry_counts_and_stages_open_spans():
    assert metrics.span("rescue", cand=37, slots=187) is metrics.span("pack")  # off: one no-op
    m = metrics.Metrics(verbose=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("rescue", cand=37, slots=187):
            pass
        with m.stage("parse:my sample", items=3):
            pass
        with m.stage("bases"):
            pass
    names = {e.name for e in prof.events() if metrics.is_span(e.name)}
    assert names == {"monica.rescue cand=37 slots=187", "monica.stage.parse of=my_sample",
                     "monica.stage.bases"}
    assert m.summary()["parse:my sample"]["items"] == 3

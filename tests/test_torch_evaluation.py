"""The port's accuracy harness against the JAX package's (CPU): the mock
community, strain siblings, ``evaluate`` through the port's Classifier
(one device and a mesh) and ``strain_pair_eval`` give the same genomes
and the same EvalResult counts for the same seed; the port's concordance
entry point runs at ``--quick`` sizes and writes its artifact."""

import json

import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ref_ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu_torch import concordance
from monica_tpu_torch import convert
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

COUNTS = ("n_reads", "n_mapped", "n_correct", "n_wrong", "n_ambiguous", "n_unmapped")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(), dict(tandem_repeats=2, dispersed_repeats=1)])
def test_mock_community_equals_jax(kw):
    _same(ev.mock_community(np.random.default_rng(4), 3, 40_000, **kw),
          ref_ev.mock_community(np.random.default_rng(4), 3, 40_000, **kw))


@pytest.mark.parametrize("divergence", [0.0, 0.002, 0.03])
def test_sibling_genome_equals_jax(divergence):
    base = np.random.default_rng(1).integers(0, 4, 50_000).astype(np.uint8)
    _same([ev.sibling_genome(np.random.default_rng(2), base, divergence)],
          [ref_ev.sibling_genome(np.random.default_rng(2), base, divergence)])


@pytest.fixture(scope="module")
def community():
    seqs = ref_ev.mock_community(np.random.default_rng(7), 3, 40_000)
    ref_built = ref_build(seqs, n_shards=2)
    return seqs, ref_built, convert.built_from_reference(ref_built)


@pytest.mark.parametrize("where", ["cpu", "mesh"])
@pytest.mark.parametrize("error,hp_bias", [((0.05, 0.03, 0.03), 1.0), ((0.08, 0.05, 0.05), 4.0)])
def test_evaluate_equals_jax(community, where, error, hp_bias):
    """The same reads drawn in the same order, classified by each
    package's Classifier: equal EvalResult counts (a (2, 2) mesh of the
    port pads each batch to the data axis with inert rows)."""
    seqs, ref_built, built = community
    kw = dict(n_reads=96, read_len=800, error=error, batch=40, hp_bias=hp_bias)
    want = ref_ev.evaluate(ref_built, seqs, ref_pl.ClassifyParams(extend_impl="jnp"),
                           np.random.default_rng(3), **kw)
    where_kw = (dict(device="cpu") if where == "cpu"
                else dict(mesh=pm.make_mesh(2, 2, devices=["cpu"] * 4)))
    got = ev.evaluate(built, seqs, pl.ClassifyParams(), np.random.default_rng(3), **kw, **where_kw)
    assert [getattr(got, f) for f in COUNTS] == [getattr(want, f) for f in COUNTS]
    assert got.row() == want.row() and got.n_mapped > 30


def test_strain_pair_eval_equals_jax():
    kw = dict(genome_len=60_000, divergence=0.03, n_reads=64, read_len=900)
    want = ref_ev.strain_pair_eval(np.random.default_rng(5),
                                   ref_pl.ClassifyParams(extend_impl="jnp"), **kw)
    got = ev.strain_pair_eval(np.random.default_rng(5), pl.ClassifyParams(), **kw, device="cpu")
    assert got.row() == want.row()
    assert got.settings["kind"] == "strain_pair" and got.n_mapped > 10


def test_concordance_quick_writes_artifact(tmp_path, capsys):
    """--quick --device cpu: every profile x length row and every strain
    and hard-community row, the ungated quick verdict, exit code 0."""
    out = tmp_path / "concordance.json"
    assert concordance.main(["--quick", "--device", "cpu", "--n_genomes", "3",
                             "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert len(art["rows"]) == 4 * 2 and len(art["strain_rows"]) == 5 + 2
    assert art["verdict"].startswith("CEILING-LIMITED") and art["config"]["device"] == "cpu"
    assert {r["profile"] for r in art["rows"]} == {p for p, _ in concordance.PROFILES}
    assert art["worst_gated_accuracy"] > 0.8 and art["strain_gate"] == "PASS"
    assert "artifact written" in capsys.readouterr().out

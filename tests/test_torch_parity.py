"""The port's parity harness against the JAX package's (CPU): the same
fixture byte for byte, the port's product path (one device, and a mesh)
routing every read as the JAX product path does with equal count dicts,
and the diff helpers agreeing.  The cases that exec the reference's own
aligner skip where the reference tree is absent, as the JAX package's
parity tests do."""

from dataclasses import asdict

import numpy as np
import pandas as pd
import pytest
import torch

from monica_tpu import parity as ref_parity
from monica_tpu.stats.abundance import export_tables as ref_export
from monica_tpu_torch import parity
from monica_tpu_torch.parallel import mesh as pm
from monica_tpu_torch.stats.abundance import export_tables, read_dataframe

torch.set_num_threads(1)

SIZES = dict(seed=7, clean_per_sample=40, shared_per_sample=8, random_per_sample=8,
             focus_per_sample=8)
ALIGNER = ref_parity.REF_ALIGNER  # the reference tree's aligner, where the JAX package looks


@pytest.fixture(scope="module")
def fixtures():
    return ref_parity.make_fixture(**SIZES), parity.make_fixture(**SIZES)


@pytest.fixture(scope="module")
def runs(fixtures, tmp_path_factory):
    ref_fx, fx = fixtures
    out = {"jax": ref_parity.run_ours(ref_fx, tmp_path_factory.mktemp("jax"), mode="basic")}
    out["single"] = parity.run_ours(fx, tmp_path_factory.mktemp("single"), mode="basic",
                                    device="cpu")
    out["mesh"] = parity.run_ours(fx, tmp_path_factory.mktemp("mesh"), mode="basic",
                                  mesh=pm.make_mesh(2, 2, devices=["cpu"] * 4))
    return out


def test_make_fixture_equals_jax(fixtures, tmp_path):
    ref_fx, fx = fixtures
    assert len(fx.genomes) == len(ref_fx.genomes)
    for a, b in zip(fx.genomes, ref_fx.genomes):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (fx.tax_units, fx.accessions, fx.index_of, fx.n_indexes, fx.focus_taxa) == (
        ref_fx.tax_units, ref_fx.accessions, ref_fx.index_of, ref_fx.n_indexes,
        ref_fx.focus_taxa)
    assert [{s: [asdict(r) for r in rs] for s, rs in p.items()} for p in fx.passes] == [
        {s: [asdict(r) for r in rs] for s, rs in p.items()} for p in ref_fx.passes]
    parity.write_sample_fastq(tmp_path / "a.fastq", fx.passes[0]["sample0"])
    ref_parity.write_sample_fastq(tmp_path / "b.fastq", ref_fx.passes[0]["sample0"])
    assert (tmp_path / "a.fastq").read_bytes() == (tmp_path / "b.fastq").read_bytes()


@pytest.mark.parametrize("side", ["single", "mesh"])
def test_run_ours_routes_as_jax(runs, fixtures, side):
    """Every read routed as the JAX product path routes it, the same
    focus copies, and equal count dicts (state and the routes' rule)."""
    ref_routes, ref_state, ref_built = runs["jax"]
    routes, state, built = runs[side]
    assert routes.routes == ref_routes.routes
    assert routes.focus == ref_routes.focus and any(routes.focus.values())
    assert routes.lengths == ref_routes.lengths
    d = parity.diff_routes(ref_routes, routes)
    assert d["agreement"] == 1.0 and d["n_reads"] > 0
    ours = parity.state_to_alignment(state, built.meta)
    assert ours == ref_parity.state_to_alignment(ref_state, ref_built.meta)
    want = parity.expected_alignment_from_routes(routes, fixtures[1], "basic", False)
    assert parity.diff_alignment_dicts(want, ours)["equal"]
    assert set(state.samples) == set(ref_state.samples)
    for s in state.samples:
        assert np.array_equal(state.samples[s], ref_state.samples[s])


def test_diff_helpers_agree(runs, fixtures, tmp_path):
    """diff_routes, expected_alignment_from_routes, state_to_alignment,
    diff_alignment_dicts and diff_tables give the JAX package's answers
    on the same inputs, disagreements included; diff_tables reads the
    port's CSVs without pandas and the JAX package's with it."""
    ref_routes, ref_state, ref_built = runs["jax"]
    routes, state, built = runs["single"]
    fx = fixtures[1]
    # a disagreement to report: one read routed elsewhere
    sample = sorted(routes.routes)[0]
    rid = sorted(routes.routes[sample])[0]
    routes.routes[sample][rid] = ("unmapped", None)
    try:
        for ov in (False, True):
            assert parity.diff_routes(ref_routes, routes) == ref_parity.diff_routes(ref_routes,
                                                                                   routes)
            a = parity.expected_alignment_from_routes(routes, fx, "query_length", ov)
            b = ref_parity.expected_alignment_from_routes(routes, fx, "query_length", ov)
            assert a == b
            assert parity.state_to_alignment(state, built.meta, ov) == \
                ref_parity.state_to_alignment(ref_state, ref_built.meta, ov)
            other = parity.state_to_alignment(state, built.meta, ov)
            assert parity.diff_alignment_dicts(a, other) == ref_parity.diff_alignment_dicts(a, other)
    finally:
        routes.routes[sample][rid] = ref_routes.routes[sample][rid]

    export_tables(state, built.meta, tmp_path / "port")
    ref_export(ref_state, ref_built.meta, tmp_path / "jax")
    for name in ("monica.dataframe", "raw_monica.dataframe"):
        ref_df = pd.read_csv(tmp_path / "jax" / name, index_col=(0, 1))
        ours = read_dataframe(tmp_path / "port" / name)
        off = read_dataframe(tmp_path / "port" / name)
        off.values[0, 0] *= 1.001
        off.to_csv(tmp_path / "off.csv")
        for table, csv in ((ours, tmp_path / "port" / name), (off, tmp_path / "off.csv")):
            got = parity.diff_tables(ref_df, table)
            want = ref_parity.diff_tables(ref_df, pd.read_csv(csv, index_col=(0, 1)))
            # max_rel_err: pandas' float parser lands a few ulps off the
            # written repr, which the port reads exactly
            assert {k: v for k, v in got.items() if k != "max_rel_err"} == \
                {k: v for k, v in want.items() if k != "max_rel_err"}
            assert abs(got["max_rel_err"] - want["max_rel_err"]) <= 1e-15
        assert parity.diff_tables(ref_df, ours)["cells_equal"]
        assert not parity.diff_tables(ref_df, off)["cells_equal"]


def test_reference_path_comes_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("MONICA_REFERENCE", raising=False)
    assert parity.reference_aligner_path() is None and not parity.reference_available()
    with pytest.raises(FileNotFoundError):
        with parity.reference_aligner(tmp_path / "sb"):
            pass
    monkeypatch.setenv("MONICA_REFERENCE", str(tmp_path))
    assert parity.reference_aligner_path() == tmp_path / "monica" / "genomes" / "aligner.py"


reference = pytest.mark.skipif(not parity.reference_available(ALIGNER),
                               reason="reference tree not present")


@reference
def test_route_agreement_gate_against_reference(runs, fixtures, tmp_path):
    """The reference's own routing code on identical reads: >= 95% of
    the reads routed alike by the port (one device and the mesh)."""
    with parity.reference_aligner(tmp_path / "sb", ALIGNER) as mod:
        routes, alignment, _ = parity.run_reference(mod, fixtures[1], tmp_path / "run")
    for side in ("single", "mesh"):
        d = parity.diff_routes(routes, runs[side][0])
        assert d["agreement"] >= 0.95, d
    want = parity.expected_alignment_from_routes(routes, fixtures[1], "basic", False)
    assert parity.diff_alignment_dicts(want, alignment)["equal"]


@reference
def test_tables_match_reference_code(runs, tmp_path):
    """The port's routes' count dict through the reference's normalizer
    and dataframe code, against the port's exported CSVs cell by cell."""
    routes, state, built = runs["single"]
    meta = built.meta
    glens = {meta.accessions[i]: int(meta.genome_lengths[i]) for i in range(meta.n_accessions)}
    with parity.reference_aligner(tmp_path / "sb", ALIGNER) as mod:
        ref_norm, ref_raw = parity.reference_tables(mod, parity.state_to_alignment(state, meta),
                                                    glens, tmp_path / "ref")
    export_tables(state, meta, tmp_path / "ours")
    for ref_df, name in ((ref_norm, "monica.dataframe"), (ref_raw, "raw_monica.dataframe")):
        d = parity.diff_tables(ref_df, read_dataframe(tmp_path / "ours" / name))
        assert d["same_rows"] and d["same_cols"] and d["cells_equal"], d

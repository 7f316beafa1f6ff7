"""The port's barplot, held byte-equal to the JAX package's HTML on the
same tables, and its table reader (``read_dataframe``)."""

import numpy as np
import pandas as pd
import pytest
import torch

from monica_tpu.plots import barplot as ref_barplot
from monica_tpu_torch.plots import barplot
from monica_tpu_torch.stats.abundance import Table, read_dataframe

torch.set_num_threads(1)


def _frame(table: Table) -> pd.DataFrame:
    """The JAX package's DataFrame of a port Table."""
    index = pd.MultiIndex.from_arrays([[t for t, _ in table.index], [a for _, a in table.index]],
                                      names=["tax_unit", "accession"])
    return pd.DataFrame({s: table.values[:, j] for j, s in enumerate(table.samples)}, index=index)


def _tables(rng, n_taxa: int, n_samples: int, nan_share=0.3, ties=0, per_taxon=(1, 4)):
    """(norm, raw) tables: several accessions per tax unit, shuffled so a
    unit's rows are not adjacent, NaN cells, values over many magnitudes;
    ``ties`` tax units are all-NaN (peak 0 after the fill) and as many
    share one peak value."""
    index, raw_rows = [], []
    for t in range(n_taxa):
        for a in range(int(rng.integers(*per_taxon))):
            index.append((f"Genus_species{t}", f"GCF_{t:06d}{a}.1"))
            raw_rows.append(rng.integers(0, 60, n_samples).astype(np.float64))
    order = rng.permutation(len(index))
    index = [index[i] for i in order]
    raw = np.stack(raw_rows)[order]
    raw[rng.random(raw.shape) < nan_share] = np.nan
    raw[raw == 0] = np.nan
    norm = raw * 10.0 ** rng.integers(-9, 1, raw.shape) * rng.random(raw.shape)
    for t in range(ties):  # all-NaN units, then units sharing one peak value
        rows = [i for i, (tax, _) in enumerate(index) if tax == f"Genus_species{t}"]
        norm[rows] = np.nan
        rows = [i for i, (tax, _) in enumerate(index) if tax == f"Genus_species{n_taxa - 1 - t}"]
        norm[rows] = np.nan
        norm[rows[0], 0] = 0.5
    samples = [f"sample_{j}" for j in range(n_samples)]
    return Table(index, samples, norm), Table(index, samples, raw)


def _both(tmp_path, norm, raw, **kw):
    got = barplot.plotter(norm, raw, tmp_path / "port", **kw).read_bytes()
    want = ref_barplot.plotter(_frame(norm), _frame(raw), tmp_path / "ref", **kw).read_bytes()
    return got, want


@pytest.mark.parametrize("case", [
    dict(n_taxa=20, n_samples=3),
    dict(n_taxa=12, n_samples=1, ties=3),
    dict(n_taxa=30, n_samples=5, ties=6, nan_share=0.5),
    dict(n_taxa=5, n_samples=2),
    dict(n_taxa=40, n_samples=4, per_taxon=(1, 12)),
])
def test_barplot_html_byte_equal(tmp_path, case):
    rng = np.random.default_rng(7 * case["n_taxa"] + case["n_samples"])
    norm, raw = _tables(rng, **case)
    for kw in (dict(reads_threshold=0), dict(reads_threshold=15),
               dict(hosts=["Genus_species1"], guests=["Genus species2"], mode="single",
                    reads_threshold=40, show_legend=False)):
        got, want = _both(tmp_path, norm, raw, **kw)
        assert got == want, kw


def test_ranking_ties_follow_pandas():
    """Ties (many zeros, equal peaks) come out in pandas' order, which is
    not a stable descending sort."""
    rng = np.random.default_rng(3)
    for n in (3, 9, 17, 40, 200):
        x = rng.integers(0, 4, n).astype(np.float64)
        x[rng.random(n) < 0.1] = np.nan
        want = pd.Series(x).sort_values(ascending=False).index.to_numpy()
        np.testing.assert_array_equal(barplot._rank_descending(x), want)


def test_by_taxunit_is_pandas_grouped_sum():
    rng = np.random.default_rng(8)
    norm, _ = _tables(rng, 15, 4, per_taxon=(1, 30))
    taxa, sums = barplot.by_taxunit(norm)
    want = ref_barplot.by_taxunit(_frame(norm))
    assert taxa == list(want.index)
    np.testing.assert_array_equal(sums, want.to_numpy())


def test_auto_open_opens_the_file(tmp_path, monkeypatch):
    import webbrowser

    opened = []
    monkeypatch.setattr(webbrowser, "open", lambda uri: opened.append(uri))
    norm, raw = _tables(np.random.default_rng(4), 3, 2)
    out = barplot.plotter(norm, raw, tmp_path, auto_open=True)
    assert opened == [out.resolve().as_uri()]
    barplot.plotter(norm, raw, tmp_path, auto_open=False)
    assert len(opened) == 1


def test_read_dataframe_round_trip(tmp_path):
    """What Table.to_csv writes reads back exactly: labels, samples, NaN
    cells and every float bit.  The row labels and NaN cells equal what
    the JAX package's pandas reader finds, and the values what pandas
    reads with its exact (round-trip) float parser."""
    rng = np.random.default_rng(5)
    norm, raw = _tables(rng, 25, 3)
    norm.values[0, 0] = 1e-300
    norm.values[1, 1] = 123456789.125
    back = {}
    for name, t in (("norm", norm), ("raw", raw)):
        path = tmp_path / f"{name}.dataframe"
        t.to_csv(path)
        back[name] = read_dataframe(path)
        assert back[name].index == t.index and back[name].samples == t.samples
        assert back[name].values.dtype == np.float64
        np.testing.assert_array_equal(back[name].values, t.values)
        ref = pd.read_csv(path, index_col=(0, 1), float_precision="round_trip")
        assert list(ref.index) == back[name].index and list(ref.columns) == back[name].samples
        np.testing.assert_array_equal(ref.to_numpy(), back[name].values)
    # the tables read back plot the same HTML as the tables in memory
    assert (barplot.plotter(norm, raw, tmp_path / "a").read_bytes()
            == barplot.plotter(back["norm"], back["raw"], tmp_path / "b").read_bytes())


def test_read_dataframe_of_the_reference_export(tmp_path):
    """A table the JAX package's export_tables wrote reads into the same
    labels and values the port's writer would have written."""
    from monica_tpu.index.build import IndexMeta as RefMeta
    from monica_tpu.stats.abundance import AbundanceState as RefState
    from monica_tpu.stats.abundance import export_tables as ref_export

    meta = RefMeta(tax_units=["A_x", "B_y", "A_x", "C_z"], accessions=["1", "2", "3", "4"],
                   genome_lengths=np.array([1000, 2000, 3000, 4000]))
    state = RefState(4)
    state.update("s1", np.array([5, 0, 7, 0]))
    state.update("s2", np.array([0, 3, 1, 0]))
    norm, raw = ref_export(state, meta, tmp_path)
    back = read_dataframe(tmp_path / "monica.dataframe")
    assert back.index == list(norm.index) and back.samples == list(norm.columns)
    np.testing.assert_array_equal(back.values, norm.to_numpy())


def test_read_dataframe_is_exact_where_the_reference_reader_is_not(tmp_path):
    """The JAX package's read_dataframe (pandas' default float parser)
    reads 0.04097352393619469 as 0.0409735239361946, 13 ulps below what
    was written, so its plot_only can plot other values than the run did.
    The port reads the written value back."""
    from monica_tpu.stats.abundance import read_dataframe as ref_read

    v = 0.04097352393619469
    path = tmp_path / "monica.dataframe"
    Table([("A_x", "1")], ["s"], np.array([[v]])).to_csv(path)
    assert read_dataframe(path).values[0, 0] == v
    assert ref_read(path).to_numpy()[0, 0] == 0.0409735239361946

"""The port's offline data layer (taxonomy, summary tables, the four
selection modes, genome fetch, cache and eviction) held to the JAX
package on the same fixtures: selection rows equal the JAX DataFrame's
records in order, missing cells where pandas finds them."""

import gzip
import math
import os
import time

import numpy as np
import pytest
import torch

from monica_tpu.data import fetcher as ref_fx
from monica_tpu.data import tables as ref_tb
from monica_tpu.data.taxonomy import Taxonomy as RefTaxonomy
from monica_tpu.data.taxonomy import descendants_taxid_finder as ref_descendants
from monica_tpu_torch.data import fetcher as fx
from monica_tpu_torch.data import tables as tb
from monica_tpu_torch.data.taxonomy import TAXDUMP_URL, Taxonomy, descendants_taxid_finder

torch.set_num_threads(1)

# 1 root -> 2 Bacteria -> 10 Escherichia -> 11 E. coli -> 111/112 strains
#                      -> 20 Salmonella  -> 21 S. enterica
#        -> 10239 Viruses -> 30 Coolvirus X
EDGES = [(2, 1), (10, 2), (11, 10), (111, 11), (112, 11), (20, 2), (21, 20),
         (10239, 1), (30, 10239)]
NAMES = {1: "root", 2: "Bacteria", 10: "Escherichia", 11: "Escherichia coli",
         111: "Escherichia coli K12", 112: "Escherichia coli O157", 20: "Salmonella",
         21: "Salmonella enterica", 10239: "Viruses", 30: "Coolvirus X"}


@pytest.fixture()
def taxonomies():
    return Taxonomy.from_edges(EDGES, NAMES), RefTaxonomy.from_edges(EDGES, NAMES)


def _row(acc, taxid, sp_taxid, org, strain="na"):
    return {"# assembly_accession": acc, "taxid": taxid, "species_taxid": sp_taxid,
            "organism_name": org, "infraspecific_name": strain,
            "ftp_path": f"https://x/genomes/{acc}_sub"}


def _summary_rows():
    return [
        _row("GCF_000000001.1", "111", "11", "Escherichia coli K12", "strain=K12"),
        _row("GCF_000000002.1", "112", "11", "Escherichia coli O157", "strain=O157"),
        _row("GCF_000000003.1", "21", "21", "Salmonella enterica"),
        _row("GCF_000000004.1", "30", "30", "Coolvirus X"),
        # strain cells pandas reads as missing (empty, NA) or as strings
        _row("GCF_000000005.1", "11", "11", "Escherichia coli", ""),
        _row("GCF_000000006.2", "111", "11", "Escherichia coli K12", "NA"),
        _row("GCF_000000007.1", "112", "11", "Escherichia coli O157", "n/a"),
        _row("GCF_000000008.1", "21", "21", "Salmonella enterica", "strain=LT2"),
        _row("GCF_000000009.1", "21", "21", "Salmonella enterica LT2", "strain=LT2"),
        _row("GCF_000000010.1", "30", "30", "Coolvirus X", "None"),
        _row("GCF_000000011.1", "11", "11", "Escherichia sp. Z9", "isolate=Z9"),
        _row("GCF_000000012.1", "999", "999", "Unknownia nobody", "strain=1"),
        _row("GCF_000000013.1", "", "", "Nullia nulla", ""),
    ]


@pytest.fixture()
def tables_dir(tmp_path):
    fixture = tmp_path / "summary.tsv"
    tb.write_fixture_summary(fixture, _summary_rows())
    urls = {tb.REFSEQ_SUMMARY_URL: str(fixture), tb.GENBANK_SUMMARY_URL: str(fixture)}
    assert ref_tb.REFSEQ_SUMMARY_URL == tb.REFSEQ_SUMMARY_URL
    return tmp_path, tb.fixture_downloader(urls), ref_tb.fixture_downloader(urls)


def _records(df) -> list[dict]:
    """A DataFrame's rows as dicts, pandas' missing values as None."""
    return [{k: None if isinstance(v, float) and math.isnan(v) else v for k, v in r.items()}
            for r in df.to_dict("records")]


def _select(mode, species, taxonomies, tables_dir):
    (tax, ref_tax), (tmp, dl, ref_dl) = taxonomies, tables_dir
    got = fx.ftp_selector(mode, species, tax, tmp / "port_tables", dl)
    want = ref_fx.ftp_selector(mode, species, ref_tax, tmp / "ref_tables", ref_dl)
    return got, want


def test_summary_reader_matches_pandas(tables_dir):
    tmp, dl, ref_dl = tables_dir
    got = tb.importer(tmp / "a", "refseq", dl)
    want = ref_tb.importer(tmp / "b", "refseq", ref_dl)
    assert list(want.columns) == tb.COLUMNS
    assert got == _records(want)
    strains = [r["infraspecific_name"] for r in got]
    assert strains[4] is None and strains[5] is None and strains[2] == "na"
    assert got[-1]["taxid"] is None


@pytest.mark.parametrize("mode,species", [
    ("single", ["Escherichia coli", "Coolvirus X"]),
    ("single", ["Coolvirus X"]),
    ("single", ["Escherichia coli", "Escherichia coli", "Salmonella enterica"]),
    ("all", ["Escherichia coli"]),
    ("all", ["Escherichia", "Escherichia coli", "Salmonella enterica"]),
    ("focus", ["Escherichia coli"]),
    ("focus", ["Escherichia coli", "Salmonella enterica", "Escherichia coli"]),
    ("overnight", []),
])
def test_selection_rows_equal_reference(taxonomies, tables_dir, mode, species):
    got, want = _select(mode, species, taxonomies, tables_dir)
    assert got == _records(want)
    assert len(got) > 0
    assert all(r["ftp_path"].endswith("_genomic.fna.gz") for r in got)


def test_selection_duplicates_repeat_rows(taxonomies, tables_dir):
    """A species named twice repeats its rows in 'all' mode (the inner
    join), in the reference's order."""
    once, _ = _select("all", ["Salmonella enterica"], taxonomies, tables_dir)
    twice, want = _select("all", ["Salmonella enterica"] * 2, taxonomies, tables_dir)
    assert len(twice) == 2 * len(once) and twice == _records(want)


def test_selector_requires_species_and_a_known_mode(taxonomies, tables_dir):
    (tax, _), (tmp, dl, _) = taxonomies, tables_dir
    with pytest.raises(ValueError):
        fx.ftp_selector("single", [], tax, tmp, dl)
    with pytest.raises(ValueError, match="mode"):
        fx.ftp_selector("weekly", ["Escherichia coli"], tax, tmp, dl)


def test_taxonomy_queries_and_descendants(taxonomies):
    tax, ref_tax = taxonomies
    assert tax.name_to_taxids("escherichia COLI") == [11]
    assert sorted(tax.descendants(10)) == [11, 111, 112]
    assert tax.lineage(111) == [1, 2, 10, 11, 111]
    assert tax.is_virus("Coolvirus X") and not tax.is_virus("Salmonella enterica")
    for species, focus in ((["Escherichia coli"], False), (["Bacteria", "Viruses"], True)):
        ids, col = descendants_taxid_finder(tax, species, focus=focus)
        df = ref_descendants(ref_tax, species, focus=focus)
        assert [col] == list(df.columns) and ids == list(df[col])


def test_taxonomy_cache_is_shared_with_the_reference(taxonomies, tmp_path):
    tax, ref_tax = taxonomies
    tax.save(tmp_path / "port")
    ref_tax.save(tmp_path / "ref")
    for a, b in ((Taxonomy.load(tmp_path / "ref"), ref_tax),
                 (RefTaxonomy.load(tmp_path / "port"), tax)):
        assert a.parent == b.parent and a.names == b.names
    assert Taxonomy.cache_fresh(tmp_path / "port")


def test_taxonomy_refresh_and_stale_fallback(taxonomies, tmp_path):
    import shutil
    import tarfile

    tax, _ = taxonomies
    cache = tmp_path / "taxcache"
    tax.save(cache)
    boom = lambda url, out: (_ for _ in ()).throw(RuntimeError("no network"))
    assert Taxonomy.ensure(cache, downloader=boom).names[11] == "Escherichia coli"
    old = time.time() - 30 * 86400
    os.utime(cache / "taxonomy.npz", (old, old))
    assert Taxonomy.ensure(cache, downloader=boom).names[11] == "Escherichia coli"
    dump = tmp_path / "dump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text("1\t|\t1\t|\tr\t|\n5\t|\t1\t|\tr\t|\n")
    (dump / "names.dmp").write_text("1\t|\troot\t|\t\t|\tscientific name\t|\n"
                                    "5\t|\tNovus organismus\t|\t\t|\tscientific name\t|\n")
    tarball = tmp_path / "taxdump.tar.gz"
    with tarfile.open(tarball, "w:gz") as tar:
        tar.add(dump / "nodes.dmp", arcname="nodes.dmp")
        tar.add(dump / "names.dmp", arcname="names.dmp")

    def dl(url, out):
        assert url == TAXDUMP_URL
        shutil.copyfile(tarball, out)

    assert Taxonomy.ensure(cache, downloader=dl).names[5] == "Novus organismus"
    assert Taxonomy.cache_fresh(cache) and Taxonomy.load(cache).names[5] == "Novus organismus"


def test_tables_ttl(tables_dir):
    tmp, dl, _ = tables_dir
    assert len(tb.importer(tmp / "t", "refseq", dl)) == len(_summary_rows())

    def boom(url, out):
        raise AssertionError("fetched despite fresh cache")

    tb.importer(tmp / "t", "refseq", boom)  # fresh: the transport is not called
    with pytest.raises(AssertionError):
        tb.importer(tmp / "t", "refseq", boom, ttl_days=0)


def _genome_downloader():
    calls = []

    def dl(url, out):
        calls.append(url)
        with gzip.open(out, "wt") as fh:
            fh.write(">ctg\nACGTACGTACGT\n")

    return dl, calls


def _relative(genomes, base):
    return [(os.path.relpath(p, base), h) for p, h in genomes]


def test_fetcher_cache_reuse_and_version_eviction_match_reference(taxonomies, tables_dir,
                                                                  tmp_path):
    got_sel, want_sel = _select("single", ["Escherichia coli", "Salmonella enterica"],
                                taxonomies, tables_dir)
    results = {}
    for name, mod, sel in (("port", fx, got_sel), ("ref", ref_fx, want_sel)):
        gdl, calls = _genome_downloader()
        gdir = tmp_path / f"genomes_{name}"
        first = mod.fetcher(sel, gdir, downloader=gdl)
        second = mod.fetcher(sel, gdir, downloader=gdl)
        # a version bump downloads the new version and evicts the old one
        if name == "port":
            sel3 = [dict(r) for r in sel]
            for r in sel3:
                if r["# assembly_accession"] == "GCF_000000009.1":
                    r["# assembly_accession"] = "GCF_000000009.2"
        else:
            sel3 = sel.copy()
            sel3.loc[sel3["# assembly_accession"] == "GCF_000000009.1",
                     "# assembly_accession"] = "GCF_000000009.2"
        third = mod.fetcher(sel3, gdir, downloader=gdl)
        results[name] = (
            [(_relative(g, gdir), u) for g, u in (first, second, third)],
            sorted(p.name for p in (gdir / "oldies").iterdir()),
            len(calls),
        )
    assert results["port"] == results["ref"]
    (first, second, third), leftover, n_calls = results["port"]
    assert first[1] and not second[1] and third[1] and n_calls == len(first[0]) + 1
    assert "Salmonella_enterica_000000009.1.fna.gz" not in leftover
    assert "Salmonella_enterica_000000009.2.fna.gz" in leftover


def test_fetcher_retries_then_skips(taxonomies, tables_dir, tmp_path):
    got_sel, _ = _select("single", ["Salmonella enterica"], taxonomies, tables_dir)
    attempts = []

    def flaky(url, out):
        attempts.append(url)
        raise OSError("transient")

    genomes, updated = fx.fetcher(got_sel, tmp_path / "g2", downloader=flaky, retries=2,
                                  backoff_s=0)
    assert genomes == [] and not updated and len(attempts) == 3


def test_focus_fetcher_and_preformatted_match_reference(taxonomies, tables_dir, tmp_path):
    got_sel, want_sel = _select("focus", ["Escherichia coli"], taxonomies, tables_dir)
    pre = tmp_path / "pre"
    pre.mkdir()
    with gzip.open(pre / "GCF_000000011.1_sub_genomic.fna.gz", "wt") as fh:
        fh.write(">c\nACGT\n")
    out = {}
    for name, mod, sel in (("port", fx, got_sel), ("ref", ref_fx, want_sel)):
        gdl, _ = _genome_downloader()
        g, u = mod.focus_fetcher(sel, tmp_path / f"f_{name}", downloader=gdl)
        g2, _ = mod.fetcher(sel, tmp_path / f"p_{name}", format_genomes=pre, downloader=gdl)
        out[name] = (_relative(g, tmp_path / f"f_{name}"), u,
                     _relative(g2, tmp_path / f"p_{name}"))
    assert out["port"] == out["ref"]
    assert {h[0] for _, h in out["port"][0]} >= {"Escherichia_coli_K12", "Escherichia_coli_O157"}
    assert any(p.startswith("..") for p, _ in out["port"][2])  # the preformatted copy

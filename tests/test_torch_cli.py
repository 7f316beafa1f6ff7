"""The port's CLI end to end, offline, with ``--device cpu``, held byte
for byte to the JAX package's CLI on the same offline world (guests, a
host and the focus second pass): routed FASTQs, both dataframes, the
barplot HTML, the focus outputs and the index artifacts.  Also the
``build_index`` / ``list_indexes`` / ``plot_only`` / ``initialize``
subcommands, ``--version``, and the refusals: ``--device cuda`` without
a card, ``--multihost`` and a mesh of several devices."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from monica_tpu import cli as ref_cli
from monica_tpu_torch import cli
from monica_tpu_torch.index import artifact
from tests.fixtures import make_fastq, sample_reads
from tests.test_cli import world  # noqa: F401  (the JAX CLI test's offline world)

torch.set_num_threads(1)

SPECIES = ["-G", "Aquickia prima", "Bcoolia secunda", "-H", "Hostus_major",
           "-F", "Aquickia prima", "-m", "single", "--not_auto_open_plot"]


def _transport(world):
    tmp, taxdump, summary, genome_dir, _ = world
    return ["--taxdump", str(taxdump), "--offline_tables", str(summary), str(summary),
            "--offline_genomes", str(genome_dir)]


def _query(world, folder: Path, seed=32, n=36, read_len=700) -> Path:
    seqs = world[4]
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True)
    for s, genomes in enumerate(([seqs["Aquickia prima"], seqs["Bcoolia secunda"],
                                  seqs["Hostus major"]], [seqs["Bcoolia secunda"]])):
        reads, _ = sample_reads(rng, genomes, n, read_len=read_len, error=(0.03, 0.01, 0.01))
        make_fastq(folder / f"run{s + 1}.fastq", reads)
    return folder


def _files(folder: Path) -> dict[str, bytes]:
    """Every file under ``folder`` by relative path; the timings
    (metrics.json) and the accumulator's npz (zip entry times) left out."""
    return {str(p.relative_to(folder)): p.read_bytes() for p in sorted(folder.rglob("*"))
            if p.is_file() and p.name != "metrics.json" and p.suffix != ".npz"}


def _npz(folder: Path) -> dict[str, dict]:
    out = {}
    for p in sorted(folder.rglob("*.npz")):
        with np.load(p, allow_pickle=True) as z:
            out[str(p.relative_to(folder))] = {k: z[k] for k in z.files}
    return out


def _indexes(root: Path) -> dict[str, tuple[dict, dict]]:
    """Each index folder under the root: its manifest without the run id,
    and its arrays by unversioned file name."""
    out = {}
    for d in sorted((root / "indexes").iterdir()):
        man = json.loads((d / artifact.MANIFEST).read_text())
        runid = man.pop("runid")
        arrays = {p.name.replace(f".{runid}", ""): np.load(p) for p in sorted(d.glob("shard*"))}
        out[d.name] = (man, arrays)
    return out


def _assert_same_indexes(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        (man_a, arr_a), (man_b, arr_b) = a[name], b[name]
        assert man_a == man_b, name
        assert arr_a.keys() == arr_b.keys()
        for f in arr_a:
            assert arr_a[f].dtype == arr_b[f].dtype, f
            np.testing.assert_array_equal(arr_a[f], arr_b[f], err_msg=f"{name}/{f}")


def _payload(html: bytes) -> bytes:
    """The data line of a barplot HTML (``const D = {...};``)."""
    (line,) = [x for x in html.splitlines() if x.startswith(b"const D = ")]
    return line


def test_cli_analysis_byte_equal_to_reference(world, tmp_path):
    """Guests, a host and the focus pass: the port's run writes what the
    JAX package's run writes, byte for byte."""
    runs = {}
    for name, mod, extra in (("port", cli, ["--device", "cpu"]), ("ref", ref_cli, [])):
        q = _query(world, tmp_path / f"q_{name}")
        root = tmp_path / f"root_{name}"
        assert mod.main(["--root", str(root), *_transport(world), "-q", str(q), *SPECIES,
                         *extra]) == 0
        runs[name] = (q, root)
    (q, root), (ref_q, ref_root) = runs["port"], runs["ref"]
    out = q / "monica_output"
    for f in ("monica.dataframe", "raw_monica.dataframe", "monica.barplot.html",
              "metrics.json", "focus/monica.dataframe", "focus/monica.barplot.html"):
        assert (out / f).exists(), f
    assert (q / "mapped" / "run1.fastq").exists() and (q / "focus" / "mapped").is_dir()
    assert not (q / "focus" / "run1.fastq").exists()  # the focus copy was consumed
    got, want = _files(q), _files(ref_q)
    assert got.keys() == want.keys()
    for f in got:
        assert got[f] == want[f], f
    got_npz, want_npz = _npz(q), _npz(ref_q)
    assert got_npz.keys() == want_npz.keys()
    for f in got_npz:
        assert got_npz[f].keys() == want_npz[f].keys()
        for k in got_npz[f]:
            np.testing.assert_array_equal(got_npz[f][k], want_npz[f][k], err_msg=f"{f}/{k}")
    _assert_same_indexes(_indexes(root), _indexes(ref_root))
    assert {p.name for p in root.iterdir()} >= {"monica.params", "indexes", "genomes"}
    stages = json.loads((out / "metrics.json").read_text())
    assert any(s.startswith("build_index:G_") for s in stages)
    assert any(s.startswith("build_index:F_") for s in stages)


def test_cli_build_list_cached_load_and_plot_only(world, tmp_path, capsys):
    """build_index caches the groups; list_indexes lists them; the
    analysis run loads the cache (no build stage); plot_only re-renders
    the run's HTML with the same data to the last bit, and the run's
    outputs equal the JAX package's run on the same cache."""
    root = tmp_path / "root"
    assert cli.main(["build_index", "--root", str(root), *_transport(world),
                     "-G", "Aquickia prima", "Bcoolia secunda", "-F", "Aquickia prima",
                     "--device", "cpu"]) == 0
    built = [Path(p) for p in capsys.readouterr().out.strip().splitlines()[-2:]]
    assert [p.name[:2] for p in built] == ["G_", "F_"] and all(map(artifact.is_index_dir, built))

    assert cli.main(["--root", str(root), "list_indexes"]) == 0
    assert capsys.readouterr().out.splitlines() == [str(p) for p in sorted(built)]

    args = [*_transport(world), "-G", "Aquickia prima", "Bcoolia secunda",
            "-F", "Aquickia prima", "--not_auto_open_plot"]
    q = _query(world, tmp_path / "q", seed=33)
    ref_q = _query(world, tmp_path / "ref_q", seed=33)
    assert cli.main(["--root", str(root), "-q", str(q), *args, "--device", "cpu"]) == 0
    # the JAX package's run on the same cache (the root layout is shared)
    assert ref_cli.main(["--root", str(root), "-q", str(ref_q), *args]) == 0
    stages = json.loads((q / "monica_output" / "metrics.json").read_text())
    assert any(s.startswith("load_index:G_") for s in stages)
    assert any(s.startswith("load_index:F_") for s in stages)
    assert not any(s.startswith("build_index:") for s in stages)
    assert _files(q) == _files(ref_q)

    df = q / "monica_output" / "monica.dataframe"
    html = df.parent / "monica.barplot.html"
    live = html.read_bytes()
    html.unlink()
    assert cli.main(["--root", str(root), "plot_only", "-d", str(df),
                     "--not_auto_open_plot"]) == 0
    # plot_only knows no species or mode, so only the title differs: the
    # data read back is the run's, to the last bit
    replot = html.read_bytes()
    assert _payload(replot) == _payload(live)
    assert replot == live.replace(b"Guests: Aquickia prima, Bcoolia secunda; analysis mode: single",
                                  b"Analysis mode: None")
    # -R filters on the raw counts; without the raw table, on the normalized one
    assert cli.main(["--root", str(root), "plot_only", "-d", str(df), "-R", "1e12",
                     "--not_auto_open_plot"]) == 0
    assert _payload(html.read_bytes()) != _payload(live)
    solo = tmp_path / "solo"
    solo.mkdir()
    shutil.copy(df, solo / df.name)
    assert cli.main(["--root", str(root), "plot_only", "-d", str(solo / df.name),
                     "--not_auto_open_plot"]) == 0
    assert "filter on NORMALIZED" in capsys.readouterr().err


def test_cli_indexes_folder_registers_outside(world, tmp_path, capsys):
    root = tmp_path / "root"
    outside = tmp_path / "outside"
    assert cli.main(["build", "--root", str(root), *_transport(world), "-G", "Aquickia prima",
                     "--indexes_folder", str(outside), "--device", "cpu"]) == 0
    path = Path(capsys.readouterr().out.strip().splitlines()[-1])
    assert path.parent == outside and artifact.is_index_dir(path)
    assert cli.main(["--root", str(root), "indexes"]) == 0
    assert str(path.absolute()) in capsys.readouterr().out.splitlines()


def test_cli_initialize_and_version(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("MONICA_TPU_ROOT", raising=False)
    assert cli.main(["initialize", "-r", str(tmp_path / "elsewhere")]) == 0
    capsys.readouterr()
    assert (tmp_path / ".monica_tpu" / ".root").read_text().strip() == str(tmp_path / "elsewhere")
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.startswith("monica_tpu_torch ")


def test_cli_refuses_what_it_cannot_run(world, tmp_path):
    """No card: --device cuda exits with an error before anything runs.
    --multihost without a coordinator or the env:// variables is
    refused, and so is a mesh of more devices than there are.  A run
    without a query folder is a usage error."""
    q = _query(world, tmp_path / "q")
    base = ["--root", str(tmp_path / "root"), *_transport(world), "-q", str(q), *SPECIES]
    if not torch.cuda.is_available():
        for argv in (base, base + ["--device", "cuda"],
                     ["build_index", "--root", str(tmp_path / "root"), *_transport(world),
                      "-G", "Aquickia prima"]):
            with pytest.raises(SystemExit, match="torch.cuda.is_available"):
                cli.main(argv)
        assert not (q / "monica_output").exists()
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        assert v not in os.environ
    with pytest.raises(ValueError, match="env://"):
        cli.main(base + ["--device", "cpu", "--multihost"])
    with pytest.raises(SystemExit, match="needs 2 devices"):
        cli.main(base + ["--device", "cpu", "--n_data", "2"])
    with pytest.raises(SystemExit) as e:
        cli.main(["--root", str(tmp_path / "root"), "-G", "Aquickia prima", "--device", "cpu"])
    assert e.value.code == 2


def test_resolve_mesh_arithmetic(monkeypatch):
    """The mesh sizes follow the JAX package's arithmetic over the CUDA
    card count; one device gives None, more a mesh of distinct cards."""
    from monica_tpu_torch import orchestrate as orch

    assert orch.resolve_mesh(1, 5, "cpu") is None
    assert orch.resolve_mesh(-1, 5, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert orch.resolve_mesh(1, 5, "cuda") is None
    for n_data, n_shards, shape in ((-1, 5, (1, 4)), (2, 1, (2, 1)), (4, 1, (4, 1)),
                                    (-1, 1, (4, 1))):
        mesh = orch.resolve_mesh(n_data, n_shards, "cuda")
        assert (mesh.shape["data"], mesh.shape["index"]) == shape
        cells = [d for row in mesh.devices for d in row]
        assert cells == [torch.device("cuda", i) for i in range(len(cells))]
    with pytest.raises(SystemExit, match="needs 8 devices"):
        orch.resolve_mesh(8, 1, "cuda")

"""The PyTorch port imports without jax, the JAX package and pandas,
and its kernel dispatch never falls back: a CUDA route asked for on a
CPU tensor raises."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import monica_tpu_torch
from monica_tpu_torch.ops import _native
from monica_tpu_torch.ops import extend as ex

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "monica_tpu_torch"
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PKG)], prefix="monica_tpu_torch.")
)


# jax, the JAX package and pandas are made unimportable in the child process
BLOCK = ("import sys\nsys.modules['jax'] = None\nsys.modules['monica_tpu'] = None\n"
         "sys.modules['pandas'] = None\n")


def _run_blocked(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCK + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_with_jax_blocked():
    proc = _run_blocked(
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
        "assert not [m for m in loaded if m in ('jax', 'pandas')\n"
        "            or m.startswith(('jax.', 'monica_tpu.', 'pandas.'))]\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout


def test_chip_smoke_imports_nothing_of_jax_and_fails_without_a_card():
    """chip_smoke.py runs with jax, the JAX package and pandas
    unimportable, and with no CUDA card it exits nonzero before printing
    any result."""
    proc = _run_blocked("import runpy\nrunpy.run_path('chip_smoke.py', run_name='__main__')\n")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_module_list_covers_the_slice():
    for name in ("index.minimizer", "index.build", "ops.lookup", "ops.chain",
                 "ops.extend", "ops._native", "align.pipeline", "align.runtime",
                 "convert", "io.encode", "io.seq", "io.native", "evaluation",
                 "stats.abundance", "utils.metrics", "parallel.mesh", "parallel.dist"):
        assert f"monica_tpu_torch.{name}" in MODULES


def test_module_list_covers_the_product_path():
    for name in ("index.artifact", "data.tables", "data.fetcher", "data.taxonomy",
                 "plots.barplot", "orchestrate", "cli", "utils.root", "utils.units",
                 "parity", "concordance"):
        assert f"monica_tpu_torch.{name}" in MODULES


CHECKS = ("demo_watch", "abundance_accuracy", "sensitivity_r9", "ingest_rss")


def test_module_list_covers_the_checking_entry_points():
    for name in CHECKS:
        assert f"monica_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("name", CHECKS)
def test_checking_entry_point_help_with_jax_and_pandas_blocked(name):
    """``python -m monica_tpu_torch.<name> --help`` starts with jax, the
    JAX package and pandas unimportable; each but the host-only
    ingest_rss takes --device."""
    proc = _run_blocked(
        "import runpy\n"
        f"sys.argv = ['{name}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('monica_tpu_torch.{name}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
        "assert not [m for m in loaded if m in ('jax', 'pandas')\n"
        "            or m.startswith(('jax.', 'monica_tpu.', 'pandas.'))]\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert ("--device" in proc.stdout) == (name != "ingest_rss")


@pytest.mark.parametrize("name", CHECKS[:3])
def test_checking_entry_point_device_defaults_to_cuda(name, monkeypatch):
    _assert_device_defaults_to_cuda(name, monkeypatch)


def _assert_device_defaults_to_cuda(name, monkeypatch):
    """Nothing picks a device: the default is cuda, as the CLI's."""
    import argparse

    seen = {}

    def stop(self, args=None, namespace=None):
        seen.update(vars(argparse.ArgumentParser.parse_known_args(self, args, namespace)[0]))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    mod = __import__(f"monica_tpu_torch.{name}", fromlist=["main"])
    with pytest.raises(SystemExit):
        mod.main([])
    assert seen["device"] == "cuda"


MEASURE = ("bench", "profile_stages", "bench_stream", "bench_sw", "roofline_sw", "exp_knobs",
           "scaling_curve", "podscale_model")


def test_module_list_covers_the_measurement_entry_points():
    for name in (*MEASURE, "ops.ceiling"):
        assert f"monica_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("name", MEASURE)
def test_measurement_entry_point_imports_nothing_of_jax(name):
    """``python -m monica_tpu_torch.<name> --help`` starts with jax, the
    JAX package, pandas, ``bench.py`` and ``scripts/`` unimportable, and
    offers --device and --quick."""
    proc = _run_blocked(
        "sys.modules['bench'] = None\nsys.modules['scripts'] = None\n"
        "import runpy\n"
        f"sys.argv = ['{name}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('monica_tpu_torch.{name}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
        "assert not [m for m in loaded if m in ('jax', 'pandas', 'bench')\n"
        "            or m.startswith(('jax.', 'monica_tpu.', 'pandas.', 'scripts'))]\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--quick" in proc.stdout


@pytest.mark.parametrize("name", MEASURE)
def test_measurement_entry_point_device_defaults_to_cuda(name, monkeypatch):
    _assert_device_defaults_to_cuda(name, monkeypatch)


def test_cli_entry_point_runs_with_jax_and_pandas_blocked():
    """``python -m monica_tpu_torch.cli`` starts and answers --version and
    --help with jax, the JAX package and pandas unimportable."""
    for flag, want in (("--version", "monica_tpu_torch "), ("--help", "--device")):
        proc = _run_blocked(
            "import runpy\n"
            f"sys.argv = ['monica_tpu_torch', {flag!r}]\n"
            "try:\n"
            "    runpy.run_module('monica_tpu_torch.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
        )
        assert proc.returncode == 0, proc.stderr
        assert want in proc.stdout


def test_no_jax_import_in_source():
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import monica_tpu.",
                                     "from monica_tpu.", "from monica_tpu ",
                                     "import monica_tpu ", "import pandas",
                                     "from pandas")), f"{path}: {s}"


def _sw_inputs(B=2, L=64, W=64):
    q = torch.zeros((B, L), dtype=torch.uint8)
    refwin = torch.zeros((B, L + W), dtype=torch.uint8)
    lengths = torch.full((B,), L, dtype=torch.int32)
    return q, refwin, lengths


@pytest.mark.parametrize("band", [64, 128])
def test_cuda_impl_on_cpu_tensor_raises(band):
    q, refwin, lengths = _sw_inputs(W=band)
    with pytest.raises(ValueError, match="CUDA"):
        ex.banded_sw(q, refwin, lengths, ex.ExtendParams(band=band), impl="cuda")


def test_auto_on_cpu_tensor_runs_plain_version_without_building():
    q, refwin, lengths = _sw_inputs()
    before = dict(_native.LAUNCHES)
    score, mlen = ex.banded_sw(q, refwin, lengths, ex.ExtendParams(band=64))
    assert score.tolist() == [2 * 64, 2 * 64] and mlen.tolist() == [64, 64]
    assert _native.LAUNCHES == before
    assert _native._lib is None


def test_unknown_impl_raises():
    q, refwin, lengths = _sw_inputs()
    with pytest.raises(ValueError, match="impl"):
        ex.banded_sw(q, refwin, lengths, ex.ExtendParams(band=64), impl="pallas")


def test_library_name_keyed_by_sources(monkeypatch):
    monkeypatch.delenv("MONICA_TORCH_BUILD_DIR", raising=False)
    path = _native.library_path()
    assert path.parent == ROOT / "build" / "monica_tpu_torch"
    assert path.name.startswith("libmonica_kernels_") and path.suffix == ".so"
    assert [p.name for p in _native.sources()] == ["alu_ceiling.cu", "banded_sw.cu"]


def test_build_dir_override_and_installed_package(monkeypatch, tmp_path):
    monkeypatch.setenv("MONICA_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    assert _native.library_path().parent == tmp_path / "kernels"
    # outside a source checkout the library goes to the user's cache
    monkeypatch.delenv("MONICA_TORCH_BUILD_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    site = tmp_path / "site-packages" / "monica_tpu_torch" / "ops" / "_native.py"
    monkeypatch.setattr(_native, "__file__", str(site))
    assert _native.build_dir() == tmp_path / "cache" / "monica_tpu_torch"


def test_classifier_requires_device_and_refuses_mesh():
    from monica_tpu_torch.align import runtime as rt
    from monica_tpu_torch.index.build import build_index_from_arrays

    rng = np.random.default_rng(0)
    built = build_index_from_arrays([rng.integers(0, 4, 5000).astype(np.uint8)], device="cpu")
    with pytest.raises(TypeError):
        rt.Classifier(built)
    # a device or a mesh, not both
    with pytest.raises(TypeError, match="device or a mesh"):
        rt.Classifier(built, device="cpu", mesh=object())
    two = build_index_from_arrays(
        [rng.integers(0, 4, 5000).astype(np.uint8) for _ in range(2)], n_shards=2, device="cpu"
    )
    clf = rt.Classifier(two, device="cpu")  # a multi-shard index: stacked groups
    assert isinstance(clf.index, tuple) and clf.index[0].mz_rows.shape[0] == 2
    assert monica_tpu_torch.__doc__

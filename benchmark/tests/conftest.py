"""Shared set-up of the benchmark's own tests (run as
``python -m pytest benchmark/tests -q -p xdist -n 4``).

``tiny_bench`` copies the benchmark's data files (``BENCHMARK.json``,
configurations, traffic mixes, limits, metric readers) into a temporary
directory with every size cut so that a whole run fits the CPU, and adds
a sharded copy of each configuration (``<config>_sharded``, 3 shards
merged) with a cell for each of its mixes, so that the grouped path
runs too; the code still comes from the repository.  Tests that need a CUDA card carry the
``card`` marker and take the ``card`` fixture, which decides whether
there is one when the test runs.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread a worker: the tests run under several xdist workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LENGTH = 60_000
TINY_SHARDS = 3


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def shrink(bench: Path) -> None:
    """Cut the copied configurations and mixes to CPU size in place, and
    add the sharded configurations and their cells."""
    spec_path = bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    for f in list((bench / "configs").glob("*.json")):
        c = json.loads(f.read_text())
        c["genomes"] = [dict(g, length=TINY_LENGTH) for g in c["genomes"]]
        f.write_text(json.dumps(c))
        name = f"{f.stem}_sharded"
        (bench / "configs" / f"{name}.json").write_text(json.dumps(dict(c, n_shards=TINY_SHARDS)))
        spec["workloads"] += [dict(w, name=f"{name}.{w['traffic']}", config=name)
                              for w in spec["workloads"] if w["config"] == f.stem]
    spec_path.write_text(json.dumps(spec))
    for f in (bench / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(file_reads=40, pool_files=2, check_rows_per_batch=8)
        t["lengths"].update(mean=1500, sd=1000)
        f.write_text(json.dumps(t))


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    """A copy of the benchmark's data at CPU size; returns its
    ``benchmark`` directory (``BENCHMARK.json`` beside it)."""
    bench = tmp_path / "benchmark"
    for part in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / part, bench / part)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(bench)
    return bench

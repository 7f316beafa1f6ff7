"""The port's ingest-memory harness against ``scripts/ingest_rss.py`` (the
script loaded by path) at 4 MiB with 1 MiB chunks: the same file, the
same record counts from the JAX script's worker and the port's, and the
JAX script's payload keys; and the peak each worker reports is its own
(the kernel's high-water mark, or VmRSS sampled where there is none)."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from monica_tpu_torch import ingest_rss as ir

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 1 << 20


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_script_ingest_rss",
                                                  ROOT / "scripts" / "ingest_rss.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_worker(script, mode: str, path: Path) -> tuple[int, int]:
    """(records, peak RSS bytes) from the JAX script's worker."""
    out = subprocess.run([sys.executable, "-c", script.WORKER.format(repo=str(script.REPO)),
                          mode, str(path), str(CHUNK)],
                         capture_output=True, text=True, check=True).stdout.split()
    return int(out[0]), int(out[1]) * 1024


def test_worker_counts_equal_jax(script, tmp_path):
    path = tmp_path / "big.fastq"
    n = ir.write_fastq(path, 4)
    assert n == 4 * (1 << 20) // 2040
    for mode in ("whole", "chunked"):
        records, rss = ir.run_worker(mode, path, CHUNK)
        assert records == _jax_worker(script, mode, path)[0] == n
        assert rss > 0
    assert ir.run_worker("baseline", path, CHUNK)[0] == 0


def test_main_writes_the_script_keys(script, tmp_path, monkeypatch, capsys):
    out = tmp_path / "ingest.json"
    assert ir.main(["--mb", "4", "--chunk_mb", "1", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    ref_out = tmp_path / "ingest_ref.json"
    monkeypatch.setattr(sys, "argv", ["ingest_rss.py", "--mb", "4", "--chunk_mb", "1",
                                      "--out", str(ref_out)])
    script.main()
    want = json.loads(ref_out.read_text())
    assert got.keys() == want.keys()
    assert (got["records"], got["file_mb"], got["chunk_mb"]) == (
        want["records"], want["file_mb"], want["chunk_mb"])
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == got


def test_worker_peak_is_its_own_not_the_parents(script, tmp_path):
    """From a parent that has touched 512 MiB more than a worker needs, the
    port's worker reports its own peak (VmHWM), while the JAX script's
    ru_maxrss carries the parent's peak over (ROADMAP, faults section)."""
    path = tmp_path / "small.fastq"
    ir.write_fastq(path, 1)
    ballast = np.ones(512 << 20, np.uint8)
    with open("/proc/self/status") as fh:
        parent = next(int(x.split()[1]) for x in fh if x.startswith("VmHWM:")) * 1024
    _, port = ir.run_worker("baseline", path, CHUNK)
    _, ref = _jax_worker(script, "baseline", path)
    del ballast
    assert port < parent - (400 << 20)
    assert ref >= parent - (64 << 20)


def test_sampled_peak_where_the_kernel_keeps_no_high_water_mark(monkeypatch, tmp_path):
    """Without VmHWM (gVisor's /proc has none) the worker reports the
    largest VmRSS it sampled: within 10% of VmHWM's peak, and still the
    whole-file parse above the chunked one."""
    path = tmp_path / "f.fastq"
    ir.write_fastq(path, 16)
    exact = {m: ir.run_worker(m, path, CHUNK)[1] for m in ("whole", "chunked")}
    monkeypatch.setattr(ir, "WORKER", ir.WORKER.replace('status_kb("VmHWM")', "None"))
    sampled = {m: ir.run_worker(m, path, CHUNK)[1] for m in ("whole", "chunked")}
    for m in exact:
        assert abs(sampled[m] - exact[m]) < 0.1 * exact[m], m
    assert sampled["whole"] > sampled["chunked"] + (8 << 20)

"""The port's quantification harness against ``scripts/abundance_accuracy.py``
(CPU, the script loaded by path): ``run_profile`` on one index carried
across gives the same row (est and truth lists included) and the same
routed reads; ``main`` at ``--quick`` sizes writes the JAX script's keys."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu_torch import abundance_accuracy as aa
from monica_tpu_torch import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_READS = 512


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _script("abundance_accuracy")


@pytest.fixture(scope="module")
def world():
    """The harness's community at an eighth of its genome lengths (the
    second shared block moved inside the 50 kb genome)."""
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, g // 8).astype(np.uint8) for g in aa.GENOME_LENGTHS]
    block = rng.integers(0, 4, 2000).astype(np.uint8)
    seqs[0][10_000:12_000] = block
    seqs[1][30_000:32_000] = block
    ref_built = ref_build(seqs)
    return seqs, ref_built, convert.built_from_reference(ref_built)


def test_constants_equal_the_script(script):
    assert aa.PROFILES == script.PROFILES and aa.GATED == script.GATED
    assert (aa.L1_TARGET, aa.REL_TARGET) == (script.L1_TARGET, script.REL_TARGET)


@pytest.mark.parametrize("profile", ["r10_fast", "r9_old"])
def test_run_profile_equals_jax(script, world, profile, tmp_path):
    seqs, ref_built, built = world
    error = dict(aa.PROFILES)[profile]
    want = script.run_profile(ref_built, seqs, aa.MIXTURE, error, N_READS, 1000,
                              tmp_path / "ref")
    got = aa.run_profile(built, seqs, aa.MIXTURE, error, N_READS, 1000, tmp_path / "port",
                         device="cpu")
    assert got == want
    assert got["n_reads"] == N_READS and len(got["est"]) == len(seqs)
    for route in ("mapped", "unmapped", "ambiguous"):
        assert ((tmp_path / "port" / "q" / route / "mix.fastq").read_bytes()
                == (tmp_path / "ref" / "q" / route / "mix.fastq").read_bytes()), route


def test_main_quick_writes_the_script_keys(tmp_path, capsys):
    out = tmp_path / "abundance.json"
    rc = aa.main(["--quick", "--device", "cpu", "--n_reads", "256", "--out", str(out)])
    art = json.loads(out.read_text())
    assert rc == (0 if art["gate"]["passed"] else 1)
    want = json.loads((ROOT / "ABUNDANCE_r05.json").read_text())
    assert art.keys() == want.keys() and art["gate"].keys() == want["gate"].keys()
    assert art["genome_lengths"] == [g // 2 for g in aa.GENOME_LENGTHS]
    assert [r["profile"] for r in art["rows"]] == [p for p, _ in aa.PROFILES]
    for r in art["rows"]:
        assert r.keys() == want["rows"][0].keys() and r["n_reads"] == 256
    assert '"gate_pass"' in capsys.readouterr().out.splitlines()[-1]

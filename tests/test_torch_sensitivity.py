"""The port's rescue-tier harness against ``scripts/sensitivity_r9.py``
(CPU, the script loaded by path): ``measure_saturation`` gives the same
candidate, overflow and tier counts on one index carried across, and
``evaluate`` the same row for each of the three settings."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monica_tpu import evaluation as ref_ev
from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu_torch import convert
from monica_tpu_torch import evaluation as ev
from monica_tpu_torch import sensitivity_r9 as sr
from monica_tpu_torch.align import pipeline as pl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
R9_OLD = dict(sr.PROFILES)["r9_old"]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_script_sensitivity_r9",
                                                  ROOT / "scripts" / "sensitivity_r9.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def world():
    seqs = ref_ev.mock_community(np.random.default_rng(11), 4, 60_000)
    ref_built = ref_build(seqs)
    return seqs, ref_built, convert.built_from_reference(ref_built)


def test_profiles_equal_the_script(script):
    assert sr.PROFILES == script.PROFILES


@pytest.mark.parametrize("read_len", [300, 1000])
def test_measure_saturation_equals_jax(script, world, read_len):
    seqs, ref_built, built = world
    want = script.measure_saturation(ref_built, seqs, ref_pl.ClassifyParams(), R9_OLD, read_len,
                                     256, 128)
    got = sr.measure_saturation(built, seqs, pl.ClassifyParams(), R9_OLD, read_len, 256, 128,
                                device="cpu")
    assert got == want
    assert sum(got["tier_usage"].values()) == 2
    assert sum(n for t, n in got["tier_usage"].items() if t != "skip") > 0


@pytest.mark.parametrize("setting", [name for name, _ in sr.SETTINGS])
def test_evaluate_row_equals_jax(world, setting):
    seqs, ref_built, built = world
    params = dict(sr.SETTINGS)[setting]
    ref_params = ref_pl.ClassifyParams(rescue_min_votes=params.rescue_min_votes,
                                       rescue_min_cov=params.rescue_min_cov)
    kw = dict(n_reads=256, read_len=1000, error=R9_OLD)
    want = ref_ev.evaluate(ref_built, seqs, ref_params, np.random.default_rng(5), **kw)
    got = ev.evaluate(built, seqs, params, np.random.default_rng(5), **kw, device="cpu")
    assert got.row() == want.row() and got.n_mapped > 150


def test_main_quick_writes_the_script_keys(tmp_path):
    out = tmp_path / "sensitivity.json"
    rc = sr.main(["--quick", "--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert rc == (0 if art["gate"]["passed"] else 1)
    want = json.loads((ROOT / "SENSITIVITY_r05.json").read_text())
    assert art.keys() == want.keys() and art["config"]["quick"] is True
    assert len(art["saturation"]) == 4 * 2 and len(art["rows"]) == 4 * 2 * 3
    assert art["saturation"][0].keys() == want["saturation"][0].keys()
    assert art["rows"][0].keys() == want["rows"][0].keys()

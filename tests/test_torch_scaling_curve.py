"""The port's mesh-overhead harness against ``scripts/scaling_curve.py``
(CPU, the script loaded by path).

* Both programs' ``main`` run with ``median_dispatch_seconds`` replaced
  by one sequence of given times (the measurement itself cannot agree
  across machines): the mesh rows, the ``derived`` block and every JSON
  key equal the JAX script's.
* A (2, 1) and a (1, 2) mesh of ``cpu`` classify the script's reads as
  the meshless Classifier does, on its 1-shard and 4-shard indexes.
* ``--quick`` on the CPU writes the JAX payload's keys; ``--device cuda``
  raises without a card.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monica_tpu_torch import scaling_curve as sc
from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.index.build import build_index_from_arrays
from monica_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GLEN, ROWS = 5_000, 8
# t_single, then (mesh, meshless control) for each data axis, then each index axis
TIMES = [0.0125, 0.0131, 0.0127, 0.0202, 0.0133, 0.0391, 0.0142, 0.0788, 0.0171,
         0.0233, 0.0252, 0.0261]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_script_scaling_curve",
                                                  ROOT / "scripts" / "scaling_curve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _given_times():
    it = iter(TIMES)
    return lambda clf, codes, lens, reps=7: next(it)


@pytest.fixture(scope="module")
def payloads(script, tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling")
    argv = ["--glen", str(GLEN), "--rows_per_device", str(ROWS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(script, "median_dispatch_seconds", _given_times())
        mp.setattr("sys.argv", ["scaling_curve.py", *argv, "--out", str(out / "jax.json")])
        script.main()
        mp.setattr(sc, "median_dispatch_seconds", _given_times())
        assert sc.main([*argv, "--device", "cpu", "--out", str(out / "port.json")]) == 0
    return (json.loads((out / "jax.json").read_text()),
            json.loads((out / "port.json").read_text()))


def _keys(obj):
    """Every key path of a JSON payload (list items by their first item)."""
    if isinstance(obj, dict):
        return {(k, *p) for k, v in obj.items() for p in _keys(v) | {()}}
    if isinstance(obj, list) and obj:
        return _keys(obj[0])
    return set()


def test_rows_and_derived_equal_the_jax_formulas(payloads):
    want, got = payloads
    for key in ("rows_per_device", "meshless_single_dispatch_s", "data_axis_weak_scaling",
                "index_axis", "derived"):
        assert got[key] == want[key], key
    assert got["derived"] == sc.derived(TIMES[0], got["data_axis_weak_scaling"],
                                        got["index_axis"])
    assert [r["n_data"] for r in got["data_axis_weak_scaling"]] == [1, 2, 4, 8]
    assert [r["shards_per_rank"] for r in got["index_axis"]] == [4, 2, 1]


def test_payload_keys_equal_the_script(payloads):
    want, got = payloads
    assert list(got) == list(want)
    assert _keys(got) == _keys(want)
    assert got["lockstep_schedule_s_per_sample"] >= 0


@pytest.fixture(scope="module")
def world():
    seqs, reads = sc.world(20_000)
    codes, lens = reads(16)
    return seqs, codes, lens


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_equals_meshless(world, n_shards, shape):
    seqs, codes, lens = world
    built = build_index_from_arrays(seqs, n_shards=n_shards, device="cpu")
    params = pl.ClassifyParams(n_slots=64)
    single = rt.Classifier(built, params, count_mode="basic", device="cpu")
    mesh = rt.Classifier(built, params, count_mode="basic",
                         mesh=pm.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1])))
    want = single.fetch(*single.classify(codes, lens))
    got = mesh.fetch(*mesh.classify(codes, lens))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (want[0] == pl.MAPPED).sum() == len(codes)


def test_quick_run_writes_the_script_keys(payloads, tmp_path, capsys):
    want, _ = payloads
    out = tmp_path / "quick.json"
    assert sc.main(["--device", "cpu", "--quick", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert _keys(got) == _keys(want)
    assert got["rows_per_device"] == sc.QUICK["rows_per_device"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "cpu" and json.loads(lines[-1]) == got["derived"]


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sc.main(["--device", "cuda", "--quick"])

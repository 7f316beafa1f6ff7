"""The port's config-5 harness against ``scripts/podscale_model.py`` (CPU,
the script loaded by path).

* ``structural_run`` at 8 genomes × 20 kb in 8 shards: the port's single
  device and (4, 2) mesh of ``cpu`` against the JAX script's on conftest's
  8 virtual CPU devices — the same mapped count, the abundance rows equal
  bit for bit, ``mesh_equals_single_device`` on both sides.
* ``capacity_model`` given the JAX script's constants reproduces its rows
  (every field but the wording of ``note``); the index-axis rule on a few
  (memory, shard bytes) pairs; the ``--scaling`` fold equals the JAX
  script's on ``SCALING_r05.json`` (below 1.0: no derate) and on a
  payload above it.
* ``--quick`` on the CPU: the JAX payload's keys (plus the port's
  ``per_card_share`` and its two extra model inputs), the share's gates
  passed with the rescue's SW run, the quick cut listed; ``--no-share``
  stops after R1; ``--device cuda`` raises without a card.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monica_tpu.stats.abundance import AbundanceState as RefAbundanceState
from monica_tpu_torch import podscale_model as psm
from monica_tpu_torch.ops import extend as ex

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# scripts/podscale_model.py:100-106, the JAX model's constants
JAX_HBM, JAX_R1 = 16e9, 230_108
JAX_SHARD_BYTES = 60e9 * 3.0 * 1.35 / 895
SMALL = (8, 20_000, 8)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_script_podscale_model",
                                                  ROOT / "scripts" / "podscale_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_structural_run_equals_jax(script):
    loaded = []
    load = RefAbundanceState.load

    def keep(cls, folder, n):
        st = load(folder, n)
        if "s" in st.samples:
            loaded.append(st.samples["s"].copy())
        return st

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RefAbundanceState, "load", classmethod(keep))
        want = script.structural_run(*SMALL)
    n_genomes, n_shards, got = psm.structural_results(*SMALL, device="cpu")
    assert psm.structural_summary(n_genomes, n_shards, got) == want
    assert want["mesh_equals_single_device"] and want["mapped"] > 100
    assert len(loaded) == 2
    for name, row in zip(("single", "mesh"), loaded):
        assert got[name][0] == want["mapped"]
        assert got[name][1].dtype == row.dtype
        np.testing.assert_array_equal(got[name][1], row)


def test_capacity_model_equals_jax_rows(script):
    want = script.capacity_model()
    got = psm.capacity_model(JAX_HBM, JAX_SHARD_BYTES, JAX_R1)
    assert list(got) == list(want)
    assert len(got["scaling_rows"]) == len(want["scaling_rows"]) == 3
    for g, w in zip(got["scaling_rows"], want["scaling_rows"]):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k != "note"} == \
            {k: v for k, v in w.items() if k != "note"}


def _jax_index_axis(n_shards, shard_bytes, hbm, n_chips):
    # scripts/podscale_model.py:121-125
    return next(i for i in (1, 2, 4, 8, 16, 32, 64)
                if i <= n_chips and np.ceil(n_shards / i) * shard_bytes < hbm * 0.5)


@pytest.mark.parametrize("hbm, shard_bytes, n_chips", [
    (JAX_HBM, JAX_SHARD_BYTES, 64),
    (85e9, 603e6, 64),
    (85e9, 603e6, 16),
    (40e9, 603e6, 256),
    (160e9, 603e6, 128),
    (1e9, 2.3e6, 64),
])
def test_index_axis_rule_equals_jax(hbm, shard_bytes, n_chips):
    assert psm.index_axis(895, shard_bytes, hbm, n_chips) == \
        _jax_index_axis(895, shard_bytes, hbm, n_chips)


def test_index_axis_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="fit no index axis"):
        psm.index_axis(895, 603e6, 8e9, 64)


def _scaling_files(tmp_path):
    above = json.loads((ROOT / "SCALING_r05.json").read_text())
    above["derived"]["sharding_overhead_8x"] = 1.37
    path = tmp_path / "above.json"
    path.write_text(json.dumps(above))
    return [ROOT / "SCALING_r05.json", path]


@pytest.fixture(scope="module")
def jax_payloads(script, tmp_path_factory):
    """The JAX ``main`` with each SCALING file, its structural run given
    (the fold and the model need none)."""
    tmp = tmp_path_factory.mktemp("podscale")
    out = []
    for k, path in enumerate(_scaling_files(tmp)):
        dest = tmp / f"jax{k}.json"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(script, "structural_run", lambda **kw: {
                "n_genomes": 24, "n_shards": 24, "mesh": "given", "mapped": 128,
                "mesh_equals_single_device": True})
            mp.setattr("sys.argv", ["podscale_model.py", "--out", str(dest),
                                    "--scaling", str(path)])
            with pytest.raises(SystemExit) as e:
                script.main()
        assert e.value.code == 0
        out.append((path, json.loads(dest.read_text())))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_scaling_fold_equals_jax(jax_payloads, k):
    path, want = jax_payloads[k]
    model = psm.capacity_model(JAX_HBM, JAX_SHARD_BYTES, JAX_R1)
    psm.fold_scaling(model, json.loads(Path(path).read_text()), str(path))
    assert model["measured_overheads"] == want["capacity_model"]["measured_overheads"]
    assert [r["modeled_reads_per_s_with_measured_overhead"] for r in model["scaling_rows"]] == \
        [r["modeled_reads_per_s_with_measured_overhead"]
         for r in want["capacity_model"]["scaling_rows"]]
    assert model["measured_overheads"]["applied_derate"] == [1.0, 1.37][k]


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """``main --quick --device cpu`` in this process, the plain SW version
    counted: (exit code, payload, SW calls)."""
    out = tmp_path_factory.mktemp("quick") / "podscale.json"
    calls = []
    plain = ex.banded_sw_torch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex, "banded_sw_torch", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
        rc = psm.main(["--device", "cpu", "--quick", "--out", str(out),
                       "--scaling", str(ROOT / "SCALING_r05.json")])
    return rc, json.loads(out.read_text()), len(calls)


def _keys(obj):
    if isinstance(obj, dict):
        return {(k, *p) for k, v in obj.items() for p in _keys(v) | {()}}
    if isinstance(obj, list) and obj:
        return _keys(obj[0])
    return set()


def test_quick_payload_keys_are_the_scripts(quick, jax_payloads):
    _, got, _ = quick
    _, want = jax_payloads[0]
    assert list(got)[: len(want)] == list(want)
    extra = {p for p in _keys(got) - _keys(want)}
    assert {p[:3] if p[0] == "capacity_model" else p[:1] for p in extra} == {
        ("per_card_share",), ("capacity_model", "inputs", "hbm_per_chip"),
        ("capacity_model", "inputs", "shard_bases")}


def test_quick_share_passes_its_gates(quick):
    rc, payload, sw_calls = quick
    share = payload["per_card_share"]
    assert rc == 0 and payload["verdict"] == "PASS"
    assert share["gates"] == {"mesh_equals_single_device": True, "accuracy": True,
                              "sw_launched": True}
    assert share["shards"] == 3 and share["genomes"] == 3 * share["genomes_per_shard"]
    assert share["reduced"] == [{"what": "shards", "model": share["shards_model"], "run": 3,
                                 "why": "--quick: CPU test size"}]
    assert share["accuracy"] >= psm.MIN_ACCURACY
    assert share["structural"]["mesh_equals_single_device"]
    assert share["structural"]["n_shards"] == 3
    assert share["work_conserving_ratio"] == pytest.approx(
        share["reads_per_s"] * 3 / share["r1_reads_per_s"])
    assert sw_calls > 0  # the rescue tier extended reads
    # the model's inputs are the run's own measurements
    cap = share["capacity_inputs"]
    assert cap["shard_bytes"] == share["stacked_mib"] * 2**20 / 3
    rows = payload["capacity_model"]["scaling_rows"]
    assert max(r["shards_per_chip"] for r in rows) == share["shards_model"]
    assert rows[0]["modeled_reads_per_s"] == int(cap["reads_per_s_1shard"] * 64 / 895)


def test_no_share_stops_after_r1(tmp_path):
    out = tmp_path / "p.json"
    assert psm.main(["--device", "cpu", "--quick", "--no-share", "--out", str(out)]) == 0
    share = json.loads(out.read_text())["per_card_share"]
    assert not share["full"] and share["gates"] == {}
    assert share["r1_reads_per_s"] > 0 and "reads_per_s" not in share
    assert share["capacity_inputs"]["shard_bytes_from"].startswith("one-shard index")


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        psm.main(["--device", "cuda", "--quick"])

"""The port's abundance accumulator, normalization and table export
against the JAX package's: normalize equal, the exported CSVs byte-equal
to pandas' (with and without the overnight genus collapse),
``alignment.npz`` read across packages in both directions, and the
stats module importable with pandas blocked."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from monica_tpu.index.build import IndexMeta as RefMeta
from monica_tpu.stats import abundance as ref_ab
from monica_tpu_torch import convert
from monica_tpu_torch.index.build import IndexMeta
from monica_tpu_torch.stats import abundance as ab

ROOT = Path(__file__).resolve().parents[1]


def _metas(n=9, seed=1):
    rng = np.random.default_rng(seed)
    tax = [f"Genus{i % 3}_species{i}" for i in range(n)]
    tax[4] = "Odd,name_with comma"  # a field the CSV must quote
    tax[5] = 'Quote"d_sp'
    acc = [f"AC{i:04d}.1" for i in range(n)]
    gl = rng.integers(1_000, 10**7, n).astype(np.int64)
    return RefMeta(tax, acc, gl), IndexMeta(tax, acc, gl)


def _states(n=9, seed=2, samples=("s_b", "s_a", "s_c")):
    rng = np.random.default_rng(seed)
    ref, port = ref_ab.AbundanceState(n), ab.AbundanceState(n)
    for s in samples:
        for _ in range(2):  # two batches per sample: the monotone update
            c = rng.integers(0, 10**6, n) * (rng.random(n) < 0.5)
            ref.update(s, c)
            port.update(s, c)
    return ref, port


def test_normalize_equal():
    ref_meta, meta = _metas()
    ref, port = _states()
    want = ref_ab.normalize(ref, ref_meta.genome_lengths)
    got = ab.normalize(port, meta.genome_lengths)
    assert set(want) == set(got)
    for s in want:
        assert got[s].dtype == want[s].dtype
        np.testing.assert_array_equal(got[s], want[s])
    empty = ab.AbundanceState(9)
    empty.update("z", np.zeros(9, np.int64))
    np.testing.assert_array_equal(ab.normalize(empty, meta.genome_lengths)["z"], np.zeros(9))


@pytest.mark.parametrize("overnight", [False, True])
@pytest.mark.parametrize("samples", [("s_b", "s_a", "s_c"), ("only",), ()])
def test_export_tables_byte_equal(tmp_path, overnight, samples):
    ref_meta, meta = _metas()
    ref, port = _states(samples=samples)
    want_norm, want_raw = ref_ab.export_tables(ref, ref_meta, tmp_path / "ref", overnight=overnight)
    norm, raw = ab.export_tables(port, meta, tmp_path / "port", overnight=overnight)
    for name in (ab.DATAFRAME_FILENAME, ab.RAW_DATAFRAME_FILENAME):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    for table, frame in ((norm, want_norm), (raw, want_raw)):
        assert table.index == list(frame.index)
        assert table.samples == list(frame.columns)
        np.testing.assert_array_equal(table.values, frame.to_numpy())


def test_all_zero_sample_exports_header_only(tmp_path):
    ref_meta, meta = _metas()
    ref, port = ref_ab.AbundanceState(9), ab.AbundanceState(9)
    ref.update("z", np.zeros(9, np.int64))
    port.update("z", np.zeros(9, np.int64))
    ref_ab.export_tables(ref, ref_meta, tmp_path / "ref")
    ab.export_tables(port, meta, tmp_path / "port")
    got = (tmp_path / "port" / ab.RAW_DATAFRAME_FILENAME).read_bytes()
    assert got == (tmp_path / "ref" / ab.RAW_DATAFRAME_FILENAME).read_bytes()
    assert got == b"tax_unit,accession,z\n"


def test_alignment_npz_loads_across_packages(tmp_path):
    ref, port = _states()
    for d, st in (("from_ref", ref), ("from_port", port)):
        (tmp_path / d).mkdir()
        st.save(tmp_path / d)
    # the port reads the JAX package's file, and the JAX package the port's
    got = ab.AbundanceState.load(tmp_path / "from_ref", 9)
    back = ref_ab.AbundanceState.load(tmp_path / "from_port", 9)
    for s in ref.samples:
        np.testing.assert_array_equal(got.samples[s], ref.samples[s])
        np.testing.assert_array_equal(back.samples[s], port.samples[s])
        assert got.samples[s].dtype == np.int64
    assert set(got.samples) == set(back.samples) == set(ref.samples)
    # another accession count, or no file: an empty state
    assert ab.AbundanceState.load(tmp_path / "from_ref", 10).samples == {}
    assert ab.AbundanceState.load(tmp_path, 9).samples == {}
    ab.AbundanceState.clear(tmp_path / "from_port")
    assert ab.AbundanceState.load(tmp_path / "from_port", 9).samples == {}
    ab.AbundanceState.clear(tmp_path / "from_port")  # clearing twice is fine


def test_state_from_reference_copies():
    ref, _ = _states()
    got = convert.state_from_reference(ref)
    assert got.n_accessions == ref.n_accessions
    for s in ref.samples:
        np.testing.assert_array_equal(got.samples[s], ref.samples[s])
    got.update("s_a", np.ones(9, np.int64))
    assert not np.array_equal(got.samples["s_a"], ref.samples["s_a"])


def test_stats_import_with_pandas_blocked(tmp_path):
    code = (
        "import sys\n"
        "for m in ('pandas', 'jax', 'monica_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from monica_tpu_torch.index.build import IndexMeta\n"
        "from monica_tpu_torch.stats import abundance as ab\n"
        "st = ab.AbundanceState(2)\n"
        "st.update('s', np.array([3, 0]))\n"
        f"ab.export_tables(st, IndexMeta(['A_b', 'C_d'], ['X', 'Y'], np.array([10, 20])), {str(tmp_path)!r})\n"
        "assert not [m for m in sys.modules if m.startswith('pandas') and sys.modules[m]]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / ab.RAW_DATAFRAME_FILENAME).read_text() == "tax_unit,accession,s\nA_b,X,3.0\n"


def test_metrics_match_reference(tmp_path):
    from monica_tpu.utils import metrics as ref_metrics
    from monica_tpu_torch.utils import metrics

    got, want = metrics.Metrics(verbose=False), ref_metrics.Metrics(verbose=False)
    for m in (got, want):
        with m.stage("parse:s", items=10):
            pass
        m.add("bases", 0.0, 500)
        m.add("bases", 2.0, 500)
    assert got.summary()["bases"] == want.summary()["bases"] == {
        "seconds": 2.0, "calls": 2, "items": 1000, "per_s": 500.0}
    assert got.summary().keys() == want.summary().keys()
    assert got.rate("bases") == 500.0 and got.rate("missing") == 0.0
    got.dump(tmp_path / "m.json")
    assert "parse:s" in (tmp_path / "m.json").read_text()
    with metrics.profiler_trace(str(tmp_path / "trace")):
        np.ones(10).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with metrics.profiler_trace(None):
        pass

"""``monica_tpu_torch.bench_sw`` and ``roofline_sw`` against
``scripts/bench_sw.py`` and ``scripts/roofline_sw.py`` (CPU).

* Their inputs equal the JAX scripts' draws (written out here as the
  scripts write them; ``roofline_sw.py`` imports jax and sets its
  compilation cache at import time, so neither is imported), and the
  plain SW on them equals ``ex.banded_sw(impl="jnp")`` bit for bit at
  B = 8, L = 1024, bands 64 and 128.
* The ALU-ceiling chain: the plain version's sum equals the JAX chain's
  in the low 32 bits (torch sums int32 into int64, jnp's sum wraps) at
  64 × 64 lanes and unroll 8; the DPX chain equals a numpy int64 model.
* The SASS counter reads a ``cuobjdump`` listing's instances.
* Each module's ``--device cpu --quick`` run prints the card line
  (``cpu``) and the JAX script's JSON keys (roofline_sw: plus
  ``measured_dpx_gops_per_s``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.ops import extend as ref_ex
from monica_tpu_torch import bench_sw, roofline_sw
from monica_tpu_torch.ops import _native, ceiling
from monica_tpu_torch.ops import extend as ex

torch.set_num_threads(1)


def _jax_bench_sw_inputs(B, L, W):
    """scripts/bench_sw.py:29-38."""
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    starts = rng.integers(0, len(ref) - L - W, B)
    q = np.stack([ref[s : s + L] for s in starts])
    m = rng.random(q.shape) < 0.08
    q[m] = rng.integers(0, 4, int(m.sum()))
    refwin = ref_ex.extract_ref_windows(jnp.asarray(ref), jnp.asarray(starts.astype(np.int32)),
                                        L, W)
    return q, np.asarray(refwin), np.full(B, L, np.int32)


def _jax_roofline_inputs(band, B, L):
    """scripts/roofline_sw.py:83-89."""
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, (B, L), dtype=np.uint8)
    refwin = rng.integers(0, 4, (B, L + band), dtype=np.uint8)
    return q, refwin, np.full(B, L, np.int32)


@pytest.mark.parametrize("band", [64, 128])
@pytest.mark.parametrize("script", ["bench_sw", "roofline_sw"])
def test_inputs_equal_jax_draws_and_plain_sw_equals_jnp(script, band):
    B, L = 8, 1024
    if script == "bench_sw":
        want = _jax_bench_sw_inputs(B, L, band)
        got = bench_sw.inputs(B, L, band, "cpu")
    else:
        want = _jax_roofline_inputs(band, B, L)
        got = roofline_sw.kernel_inputs(band, B, L, "cpu")
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    p = ex.ExtendParams(band=band)
    score, mlen = ex.banded_sw(*got, p)
    ref_score, ref_mlen = ref_ex.banded_sw(*(jnp.asarray(w) for w in want),
                                           ref_ex.ExtendParams(band=band), impl="jnp")
    np.testing.assert_array_equal(score.numpy(), np.asarray(ref_score))
    np.testing.assert_array_equal(mlen.numpy(), np.asarray(ref_mlen))
    assert (score > 0).all()


def test_bench_sw_large_inputs_equal_jax_draws():
    """At the module's default shape, the draws still agree (B, L, W =
    2048, 1024, 64)."""
    want = _jax_bench_sw_inputs(2048, 1024, 64)
    got = bench_sw.inputs(2048, 1024, 64, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_int32_chain_equals_jax_chain_low_bits():
    """scripts/roofline_sw.py:51-59 at 64 × 64 lanes, unroll 8."""
    x = ceiling.chain_input((64, 64))
    np.testing.assert_array_equal(
        x, np.random.default_rng(0).integers(0, 1 << 30, (64, 64), dtype=np.int32))

    @jax.jit
    def chain(x):
        y = x
        for i in range(8):
            y = (y + x) ^ (y >> 1) ^ np.int32(2 * i + 1)
        return y.sum()

    want = int(np.asarray(chain(jnp.asarray(x))))
    got = ceiling.alu_chain(torch.from_numpy(x), 8, "int32")
    assert got.dtype == torch.int64
    assert ceiling.low32(got) == want & ceiling.MASK32
    assert ceiling.low32(got) != 0


def test_dpx_chain_equals_numpy_model():
    x = ceiling.chain_input((64, 64)).astype(np.int64)
    a, b = (x & 255) - 128, -(x & 1023)
    y = x.copy()
    for _ in range(40):
        y = np.maximum(y + a, b)
    got = ceiling.alu_chain(torch.from_numpy(ceiling.chain_input((64, 64))), 40, "dpx")
    assert int(got) == int(y.sum())


def test_ceiling_kernel_refuses_cpu_tensors_and_other_unrolls():
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _native.alu_ceiling_cuda(x, 256, "int32")
    with pytest.raises(ValueError, match="chain"):
        ceiling.alu_chain_torch(x, 8, "int64")
    assert _native.ALU_UNROLLS == (256, 512, 1024) and _native.LAUNCHES["alu_ceiling"] == 0


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_118alu_ceiling_kernelILi256ELb0EEEvPKiiPj
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
{body0}
        /*1000*/                   EXIT ;                                /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_118alu_ceiling_kernelILi1024ELb0EEEvPKiiPj
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
{body1}
        /*1000*/                   EXIT ;                                /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_118alu_ceiling_kernelILi256ELb1EEEvPKiiPj
        /*0000*/              @!P0 VIADDMNMX R3, R3, R4, R5, !PT ;      /* 0x0000000403037246 */
\t\tFunction : _ZN12_GLOBAL__N_118alu_ceiling_kernelILi1024ELb1EEEvPKiiPj
{dpx1}
"""


def test_sass_per_step_counts_instances():
    step = ("        /*0010*/                   IADD3 R2, R3, R4, RZ ;   /* 0x0 */\n"
            "        /*0020*/                   SHF.R.S32.HI R5, RZ, 0x1, R3 ;   /* 0x0 */\n"
            "        /*0030*/                   LOP3.LUT R3, R2, R5, 0x1, 0x96, !PT ;   /* 0x0 */")
    dpx = "        /*0010*/                   VIADDMNMX R3, R3, R4, R5, !PT ;   /* 0x0 */"
    text = SASS.format(body0="\n".join([step] * 256), body1="\n".join([step] * 1024),
                       dpx1="\n".join([dpx] * 769))
    out = ceiling.sass_per_step(text)
    assert out["int32"]["per_step"] == 3.0
    assert out["int32"]["opcodes_per_step"] == {"IADD3": 1.0, "LOP3": 1.0, "SHF": 1.0}
    assert out["int32"]["instructions"] == {256: 2 + 3 * 256, 1024: 2 + 3 * 1024}
    assert out["dpx"]["per_step"] == 1.0 and out["dpx"]["opcodes_per_step"] == {"VIADDMNMX": 1.0}


def test_per_cell_instructions_are_chip_smokes():
    p = ex.ExtendParams(band=64)  # reach 16: a 16-lane window, 3 three-way maxes
    assert roofline_sw.per_cell_instructions(True, p) == 10
    assert roofline_sw.per_cell_instructions(False, p) == 21
    assert roofline_sw.per_cell_instructions(True, p._replace(max_gap=0)) == 7 + 4


def test_bench_sw_cpu_run_prints_jax_keys(capsys):
    assert bench_sw.main(["--device", "cpu", "--quick"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert lines[-2] == "cpu"
    assert list(out) == ["metric", "value", "unit", "vs_baseline"]  # bench_sw.py:59-68
    assert out["metric"] == "banded_sw_mcells_per_s_per_chip" and out["value"] > 0


def test_roofline_cpu_run_prints_jax_keys(tmp_path, capsys):
    art = tmp_path / "roof.json"
    assert roofline_sw.main(["--device", "cpu", "--quick", "--out", str(art)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert lines[-2] == "cpu"
    # roofline_sw.py:151-153, and the DPX rate beside the int32 one
    assert list(out) == ["measured_vpu_gops_per_s", "measured_dpx_gops_per_s",
                         "speed_of_light_gcells_per_s", "fraction_of_light"]
    payload = json.loads(art.read_text())
    assert payload["ops_per_cell"] == {"packed": 10, "pairstate": 21}
    assert payload["sass_per_step"] is None and payload["device"] == "cpu"
    assert [r["kernel"] for r in payload["kernels"]] == ["banded_sw_packed_w64",
                                                         "banded_sw_packed_w128"]
    assert [json.loads(ln)["band"] for ln in lines if ln.startswith('{"band"')] == [64, 128]
    assert sum(ln.startswith("ceiling ") for ln in lines) == 2

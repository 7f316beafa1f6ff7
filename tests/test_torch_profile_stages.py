"""``monica_tpu_torch.profile_stages`` against ``scripts/profile_stages.py``
(CPU).

The JAX script imports jax and sets its compilation cache at import
time, so its variants are rebuilt here from ``monica_tpu``'s functions
exactly as it writes them (``pl.sketch_batch``, ``lk.lookup_anchors``,
``ch.chain_votes``, ``pl.classify_batch``), each summed by its ``live()``
under a jitted ``lax.scan`` over the resident batches.  Each of the port's
five variants through ``bench.time_scalar`` gives the same live
scalar within float32 summation tolerance: rtol 1e-5 (the two sum the
same values as float32 in another order; the lookup's sum reaches ~1e13,
where the two orders differ by ~3e-7 of it).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.align import pipeline as ref_pl
from monica_tpu.index.build import build_index_from_arrays as ref_build
from monica_tpu.ops import chain as ref_ch
from monica_tpu.ops import lookup as ref_lk
from monica_tpu_torch import bench, profile_stages
from monica_tpu_torch.index.build import build_index_from_arrays

torch.set_num_threads(1)

R, B, L = 2, 64, 1024


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, 100_000).astype(np.uint8) for _ in range(5)]
    codes = bench.make_reads(seqs, rng, R * B).reshape(R, B, L)
    lengths = np.full((R, B), L, np.int32)
    ref = ref_build(seqs, n_shards=1)
    dev, tb = ref_pl.device_shard(ref.shards[0])
    built = build_index_from_arrays(seqs, n_shards=1, device="cpu")
    index, params, n_acc = bench.prepare(built, "cpu")
    return dict(codes=codes, lengths=lengths, ref_dev=dev, tag_bits=tb, n_acc=n_acc,
                index=index, params=params)


def _jax_variants(tb, n_acc):
    """scripts/profile_stages.py:74-118, as written there."""
    params = ref_pl.params_for_bucket(ref_pl.ClassifyParams(tag_bits=tb), L)
    params_noext = params._replace(extend=False)

    def stage_lookup(index, c, l):
        sk = ref_pl.sketch_batch(c, l, params)
        return ref_lk.lookup_anchors(index.mz_rows, *sk, tag_bits=params.tag_bits,
                                     bucket_len=L, anchors_per_seed=params.anchors_per_seed)

    return params, {
        "sketch": lambda index, c, l: ref_pl.sketch_batch(c, l, params),
        "+lookup": stage_lookup,
        "+chain": lambda index, c, l: ref_ch.chain_votes(*stage_lookup(index, c, l)),
        "full(noext)": lambda index, c, l: ref_pl.classify_batch(index, c, l, params_noext,
                                                                 n_acc),
        "full(rescue)": lambda index, c, l: ref_pl.classify_batch(index, c, l, params, n_acc),
    }


def _jax_live(out):
    return sum(x.astype(jnp.float32).sum() for x in jax.tree_util.tree_leaves(out))


@pytest.mark.parametrize("name", profile_stages.VARIANTS)
def test_variant_live_scalar_equals_jax(world, name):
    ref_params, variants = _jax_variants(world["tag_bits"], world["n_acc"])
    assert ref_params.n_slots == world["params"].n_slots == 64
    stage = variants[name]

    @jax.jit
    def run(index, codes, lengths):
        def body(c, b):
            return c + _jax_live(stage(index, b[0], b[1])), None

        return jax.lax.scan(body, jnp.float32(0), (codes, lengths))[0]

    want = float(run(world["ref_dev"], jnp.asarray(world["codes"]), jnp.asarray(world["lengths"])))
    mine = profile_stages.stages(world["index"], world["params"], world["n_acc"])[name]
    cd, ld = bench.resident(world["codes"], world["lengths"], "cpu")
    dts, got = bench.time_scalar(lambda c, l: profile_stages.live(mine(c, l)), cd, ld, reps=1)
    assert len(dts) == 1 and want != 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_live_sums_every_leaf():
    out = (torch.tensor([1, 2], dtype=torch.int32),
           (torch.tensor([True, False]), torch.tensor([0.5, 0.25])))
    assert [t.dtype for t in profile_stages.leaves(out)] == [torch.int32, torch.bool,
                                                             torch.float32]
    assert float(profile_stages.live(out)) == 4.75


def test_cpu_run_prints_the_jax_keys(world, capsys):
    assert profile_stages.main(["--device", "cpu", "--quick"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert lines[-2] == "cpu"
    assert list(out) == ["ms_per_batch_2048"]
    assert list(out["ms_per_batch_2048"]) == list(profile_stages.VARIANTS)
    assert all(v > 0 for v in out["ms_per_batch_2048"].values())
    # a line a variant with its reps, and the launches (not measured off the card)
    for name in profile_stages.VARIANTS:
        assert any(ln.startswith(f"{name} ") and "reps_ms_per_batch=" in ln for ln in lines)
        assert f"launches {name:22s} not measured (no card)" in lines
    cd, ld = bench.resident(world["codes"], world["lengths"], "cpu")
    stage = profile_stages.stages(world["index"], world["params"], world["n_acc"])["sketch"]
    assert profile_stages.launches(stage, cd[0], ld[0]) is None

"""Read sketching in the PyTorch port is bit-equal to the JAX
reference (``sketch_reads_jax``) and to its numpy k-mer/winnow path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.index import minimizer as ref_mz
from monica_tpu_torch.index import minimizer as mz

torch.set_num_threads(1)


def _reads(seed, B, L, pad_tail=False, interior_n=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    if pad_tail:
        for b in range(0, B, 2):
            codes[b, int(rng.integers(20, L)):] = 4
        codes[1, 10:] = 4  # a read barely longer than k
    if interior_n:
        for b in range(B):
            codes[b, rng.integers(0, L, 3)] = 4
    return codes


CASES = {
    "fast_L1024_slots64": dict(B=6, L=1024, n_slots=64, frac=1.0),
    "winnow_L512_slots128": dict(B=6, L=512, n_slots=128, frac=1.0),
    "frac_half": dict(B=6, L=1024, n_slots=64, frac=0.5),
    "pad_tails_and_N": dict(B=6, L=1024, n_slots=64, frac=1.0, pad_tail=True,
                            interior_n=True),
    "pad_tails_winnow": dict(B=6, L=512, n_slots=128, frac=1.0, pad_tail=True,
                             interior_n=True),
    "non_pow2_segments": dict(B=3, L=700, n_slots=64, frac=1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sketch_reads_bit_equal(name):
    c = dict(CASES[name])
    B, L, n_slots, frac = c.pop("B"), c.pop("L"), c.pop("n_slots"), c.pop("frac")
    codes = _reads(len(name), B, L, **c)
    want = [np.asarray(x) for x in ref_mz.sketch_reads_jax(jnp.asarray(codes), n_slots, frac=frac)]
    got = [x.numpy() for x in mz.sketch_reads(torch.from_numpy(codes), n_slots, frac=frac)]
    for field, a, b in zip(("hash", "pos", "strand", "valid"), want, got):
        assert a.shape == b.shape == (B, n_slots), field
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=field)


@pytest.mark.parametrize("k", [15, 11])
def test_kmer_hashes_match_numpy(k):
    codes = _reads(3, 4, 300, interior_n=True)
    h_ref, s_ref = ref_mz.kmer_hashes(codes, k, np)
    h, s = mz.kmer_hashes(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(h_ref.astype(np.int64), h.numpy())
    np.testing.assert_array_equal(s_ref, s.numpy())


@pytest.mark.parametrize("frac", [1.0, 0.25])
def test_select_minimizers_match_numpy(frac):
    codes = _reads(4, 4, 400, interior_n=True)
    h_ref, _ = ref_mz.kmer_hashes(codes, 15, np)
    keep_ref = ref_mz.select_minimizers(h_ref, 10, np, frac=frac)
    h, _ = mz.kmer_hashes(torch.from_numpy(codes), 15)
    np.testing.assert_array_equal(keep_ref, mz.select_minimizers(h, 10, frac=frac).numpy())


def test_first_argmin_takes_first_tie():
    x = torch.tensor([[3, 1, 1, 0, 0], [2, 2, 2, 2, 2]])
    assert mz.first_argmin(x).tolist() == [3, 0]

"""Banded Smith–Waterman in the PyTorch port: the plain version
(``banded_sw_torch``, both state branches) and ``extend_hits`` against
the JAX reference — the jnp DP, the Pallas kernels in interpret mode and
the scalar gold DP — bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.ops import extend as ref_ex
from monica_tpu_torch.ops import extend as ex
from tests.test_extend import gold_banded_sw

torch.set_num_threads(1)

ref_sw_jnp = jax.jit(ref_ex.banded_sw_jnp, static_argnums=3)


def _case(seed, B, L, W, short=True, sub=0.1):
    """Reads drawn from a random reference at 10% substitutions, their
    windows, and (optionally) a PAD-tailed short read in row 0."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 50_000).astype(np.uint8)
    starts = rng.integers(0, len(ref) - L - W, B)
    q = np.stack([ref[s : s + L] for s in starts])
    m = rng.random(q.shape) < sub
    q[m] = rng.integers(0, 4, int(m.sum()))
    lengths = np.full(B, L, np.int32)
    if short:
        lengths[0] = L // 3
        q[0, L // 3 :] = 4
    refwin = np.array(ref_ex.extract_ref_windows(
        jnp.asarray(ref), jnp.asarray(starts.astype(np.int32)), L, W))
    return ref, starts, q, refwin, lengths


def _port(q, refwin, lengths, p):
    s, m = ex.banded_sw_torch(torch.from_numpy(q), torch.from_numpy(refwin),
                              torch.from_numpy(lengths), ex.ExtendParams(*p))
    return s.numpy(), m.numpy()


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]), err_msg="score")
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]), err_msg="mlen")


@pytest.mark.parametrize("B,L", [(7, 300), (16, 1000)])
def test_packed_w64_matches_pairs_kernel_and_jnp(B, L):
    p = ref_ex.ExtendParams(band=64)
    _, _, q, refwin, lengths = _case(B + L, B, L, 64)
    assert ref_ex.packed_mbits(L, p) > 0
    got = _port(q, refwin, lengths, p)
    args = (jnp.asarray(q), jnp.asarray(refwin), jnp.asarray(lengths), p)
    _assert_same(ref_sw_jnp(*args), got)
    _assert_same(ref_ex.banded_sw_pairs(*args, interpret=True), got)


def test_packed_w128_matches_packed_kernel():
    p = ref_ex.ExtendParams(band=128)
    _, _, q, refwin, lengths = _case(3, 8, 256, 128)
    got = _port(q, refwin, lengths, p)
    args = (jnp.asarray(q), jnp.asarray(refwin), jnp.asarray(lengths), p)
    _assert_same(ref_ex.banded_sw_pallas(*args, block_reads=8, interpret=True), got)
    _assert_same(ref_sw_jnp(*args), got)


def test_pair_state_matches_sw_kernel_jnp_and_gold():
    """match = 2^18 makes packed_mbits 0 at L=128, so every form runs
    the pair-state DP (the Pallas one is _sw_kernel)."""
    p = ref_ex.ExtendParams(band=32, match=1 << 18)
    L, B = 128, 3
    ref, starts, q, refwin, lengths = _case(9, B, L, 32, sub=0.12)
    assert ref_ex.packed_mbits(L, p) == 0
    got = _port(q, refwin, lengths, p)
    args = (jnp.asarray(q), jnp.asarray(refwin), jnp.asarray(lengths), p)
    _assert_same(ref_ex.banded_sw_pallas(*args, block_reads=8, interpret=True), got)
    _assert_same(ref_sw_jnp(*args), got)
    for b in range(B):
        gs, gm = gold_banded_sw(q[b][: lengths[b]], ref, int(starts[b]), 32, p)
        assert (got[0][b], got[1][b]) == (gs, gm), f"read {b}"


def test_pair_state_at_the_32k_bucket():
    """Default params in the 32,768 bucket: packed_mbits is 0, so this
    is the pair-state branch at its real shape."""
    p = ref_ex.ExtendParams(band=64)
    L = 32768
    _, _, q, refwin, lengths = _case(4, 2, L, 64, sub=0.08)
    lengths[0] = 20_001
    q[0, 20_001:] = 4
    assert ref_ex.packed_mbits(L, p) == 0
    got = _port(q, refwin, lengths, p)
    _assert_same(ref_sw_jnp(jnp.asarray(q), jnp.asarray(refwin), jnp.asarray(lengths), p), got)
    assert got[1][1] > 0.8 * L


def test_extract_ref_windows_clamps_like_clip_gather():
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 5, 3000).astype(np.uint8)
    diag = np.array([-500, 0, 31, 1500, 2900, 9999], np.int32)
    for L, W in ((256, 64), (1024, 128)):
        want = np.asarray(ref_ex.extract_ref_windows(jnp.asarray(ref), jnp.asarray(diag), L, W))
        got = ex.extract_ref_windows(torch.from_numpy(ref), torch.from_numpy(diag), L, W)
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("band", [64, 128])
def test_extend_hits_fwd_rc_and_ends(band):
    rng = np.random.default_rng(band)
    T, L, k = 6000, 256, 15
    ref = rng.integers(0, 4, T).astype(np.uint8)
    rows, lens, rpos, qpos, rcs = [], [], [], [], []
    # (ref start, rc): interior loci, and loci within `band` of either end
    for start, rc in ((1000, False), (2500, True), (10, False), (3, True),
                      (T - L - 5, False), (T - L - 20, True)):
        frag = ref[start : start + L].copy()
        if rc:
            frag = (3 - frag)[::-1]
        m = rng.random(L) < 0.08
        frag[m] = rng.integers(0, 4, int(m.sum()))
        n = int(rng.integers(L // 2, L + 1))
        row = np.full(L, 4, np.uint8)
        row[:n] = frag[:n]
        rows.append(row)
        lens.append(n)
        rp = int(rng.integers(0, n - k))  # anchor at read position rp
        qpos.append(rp)
        rpos.append(start + rp if not rc else start + L - 1 - rp - (k - 1))
        rcs.append(rc)
    codes = np.stack(rows)
    codes[0, lens[0]:] = 1  # junk past the length must be masked to PAD
    args = [codes, np.asarray(lens, np.int32), np.asarray(rpos, np.int32),
            np.asarray(qpos, np.int32), np.asarray(rcs)]
    want = ref_ex.extend_hits(jnp.asarray(ref), *map(jnp.asarray, args), k=k,
                              p=ref_ex.ExtendParams(band=band), impl="jnp")
    got = ex.extend_hits(torch.from_numpy(ref), *map(torch.from_numpy, args), k=k,
                         p=ex.ExtendParams(band=band), impl="torch")
    for name in ("score", "mlen", "nm"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(), err_msg=name)
    np.testing.assert_allclose(got.inv_identity.numpy(), np.asarray(want.inv_identity),
                               rtol=1e-6, atol=0)
    assert (got.mlen.numpy() > 0.6 * np.asarray(lens)).all()


@pytest.mark.parametrize("packed", [False, True])
def test_row_update_on_tie_rich_states(packed):
    """One DP row from states drawn from a few values, so that the up,
    diagonal and horizontal candidates tie often: the strict '>'
    selections decide which mlen survives, and must match the
    reference row update exactly."""
    rng = np.random.default_rng(7 + packed)
    B, W, mbits = 256, 32, 8
    p = ref_ex.ExtendParams(band=W)
    reach = ref_ex._gap_reach(W, p.max_gap)
    h = (rng.integers(0, 4, (B, W)) * 2).astype(np.int32)
    m = rng.integers(0, 40, (B, W)).astype(np.int32)
    qcol = rng.integers(0, 5, (B, 1)).astype(np.int32)
    rrow = rng.integers(0, 5, (B, W)).astype(np.int32)
    lane = np.arange(W, dtype=np.int32)
    if packed:
        P = (h << mbits) | m
        lane_gp = lane * (p.gap << mbits)
        want = [ref_ex._row_update_packed(*map(jnp.asarray, (P, qcol, rrow, lane_gp)), p, mbits)]
        got = [ex._row_update_packed(*map(torch.from_numpy, (P, qcol, rrow, lane_gp)),
                                     ex.ExtendParams(*p), mbits, reach)]
    else:
        want = ref_ex._row_update(*map(jnp.asarray, (h, m, qcol, rrow, lane * p.gap)), p)
        got = ex._row_update(*map(torch.from_numpy, (h, m, qcol, rrow, lane * p.gap)),
                             ex.ExtendParams(*p), reach)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

"""A numpy model of the banded-SW CUDA kernels' per-warp algorithm
(``monica_tpu_torch/ops/csrc/banded_sw.cu``), step for step as a warp
runs it, held bit-equal to the port's ``banded_sw_torch`` and the JAX
package's ``banded_sw_jnp``.

The kernels run only on the card; this checks their algorithm here: the
cell-to-lane layout (C = W/32 contiguous cells a lane), the shuffles with
their real semantics (a lane with no source gets its own value back),
the one-round windowed max with its masks and tree, the pair state's
(u * 128 + j) key with the one-row-late m side and the fetch of m, the
lazy per-cell best and its final butterfly reduction, the staging of
bytes in 128-row chunks, and the stop at each read's length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monica_tpu.ops import extend as ref_ex
from monica_tpu_torch.ops import extend as ex

torch.set_num_threads(1)

NEG = -(1 << 20)
LANES = 32
ROWS = 128
BIG = 0x7FFFFFFF
LANE = np.arange(LANES)

ref_sw_jnp = jax.jit(ref_ex.banded_sw_jnp, static_argnums=3)


# ---- warp primitives (x is lane-major: x[lane, ...]) ----

def shfl_up(x, d):
    """__shfl_up_sync: lane l gets lane l-d's value, lanes < d their own."""
    out = x.copy()
    if d:
        out[d:] = x[:-d]
    return out


def shfl_down(x, d):
    """__shfl_down_sync: lane l gets lane l+d's value, lanes >= 32-d their own."""
    out = x.copy()
    out[: LANES - d] = x[d:]
    return out


def live_mask(d):
    """The kernel's (d - 1 - lane) >> 31: all ones where lane >= d."""
    return (d - 1 - LANE) >> 31


def passes(reach):
    n = 0
    while (1 << n) < reach:
        n += 1
    return n


def window_max(v, npass):
    """window_max<W, NPASS>: one round of shuffles, masks, then a tree."""
    C = v.shape[1]
    WN = 1 << npass
    if WN == 1:
        return v
    pre = np.maximum.accumulate(v, axis=1)
    suf = np.maximum.accumulate(v[:, ::-1], axis=1)[:, ::-1]
    out = np.empty_like(v)
    if WN >= C:
        KL = WN // C
        s = [shfl_up(pre[:, C - 1], dl) & live_mask(dl) for dl in range(1, KL)]
        w = 1
        while w < KL - 1:
            for i in range(0, KL - 1 - w, 2 * w):
                s[i] = np.maximum(s[i], s[i + w])
            w *= 2
        mid = s[0] if KL > 1 else np.zeros(LANES, v.dtype)
        for c in range(C):
            pc = shfl_up(suf[:, c + 1], KL) & live_mask(KL) if c + 1 < C else 0
            out[:, c] = np.maximum(np.maximum(pre[:, c], mid), pc)
    else:
        for c in range(C):
            lo = c - WN + 1
            if lo >= 0:
                out[:, c] = v[:, lo : c + 1].max(axis=1)
            else:
                out[:, c] = np.maximum(pre[:, c], shfl_up(suf[:, C + lo], 1) & live_mask(1))
    return out


def doubling_passes(u, reach):
    """The reference's passes along the last axis (NEG fill)."""
    s = 1
    while s < reach:
        fill = np.full(u.shape[:-1] + (s,), NEG, u.dtype)
        u = np.maximum(u, np.concatenate([fill, u[..., :-s]], axis=-1))
        s *= 2
    return u


def staged_rows(q, refwin, L, W, length, rng):
    """Yield (row, query byte, the band's reference bytes (32, C)) as the
    kernel reads them from its double-buffered chunks: 16-byte pieces when
    L % 16 == 0, else bytes, each clipped to its row's end; bytes never
    staged are garbage."""
    C = W // 32
    vec = L % 16 == 0
    sq = rng.integers(0, 256, (2, ROWS))
    sr = rng.integers(0, 256, (2, ROWS + W))

    def stage(buf, i0):
        if vec:
            for k in range(ROWS // 16):
                if i0 + 16 * k < L:
                    sq[buf, 16 * k : 16 * k + 16] = q[i0 + 16 * k : i0 + 16 * k + 16]
            for k in range((ROWS + W) // 16):
                if i0 + 16 * k < L + W:
                    sr[buf, 16 * k : 16 * k + 16] = refwin[i0 + 16 * k : i0 + 16 * k + 16]
        else:
            for j in range(ROWS):
                if i0 + j < L:
                    sq[buf, j] = q[i0 + j]
            for j in range(ROWS + W):
                if i0 + j < L + W:
                    sr[buf, j] = refwin[i0 + j]

    cells = LANE[:, None] * C + np.arange(C)[None, :]
    if length > 0:
        stage(0, 0)
    buf = 0
    for i0 in range(0, length, ROWS):
        if i0 + ROWS < length:
            stage(buf ^ 1, i0 + ROWS)
        for j in range(min(ROWS, length - i0)):
            yield i0 + j, int(sq[buf, j]), sr[buf, j + cells]
        buf ^= 1


def warp_packed(q, refwin, length, L, p, mbits, reach, rng):
    W = p.band
    C = W // 32
    d = LANE[:, None] * C + np.arange(C)[None, :]
    scale = 1 << mbits
    lane_gp = d * (p.gap * scale)
    P = np.zeros((LANES, C), np.int64)
    best = np.zeros(LANES, np.int64)
    for _, qc, rc in staged_rows(q, refwin, L, W, length, rng):
        is_match = (qc == rc) & (qc < 4)
        sub = np.where(is_match, p.match * scale + 1, -p.mismatch * scale)
        up = shfl_down(P[:, 0], 1)
        up[31] = NEG
        pu = np.concatenate([P[:, 1:], up[:, None]], axis=1) - p.gap * scale
        t = np.maximum(np.maximum(P + sub, pu), 0)  # __viaddmax_s32_relu
        u = window_max(t + lane_gp, passes(reach))
        P = np.maximum(u - lane_gp, t)  # __viaddmax_s32
        best = np.maximum(best, P.max(axis=1))
        assert P.max() < 2**31
    for o in (16, 8, 4, 2, 1):
        best = np.maximum(best, best[LANE ^ o])
    return int(best[0]) >> mbits, int(best[0]) & ((1 << mbits) - 1)


def best_merge(h, r, m, oh, orr, om):
    eq = (oh == h) & (orr == r)
    take = (oh > h) | ((oh == h) & (orr < r))
    return (np.where(take, oh, h), np.where(take, orr, r),
            np.where(take, om, np.where(eq, np.maximum(m, om), m)))


def lazy_best_update(best, h, m, i):
    """Each cell's (bh, br, bm): taken only on a strictly greater h."""
    bh, br, bm = best
    better = h > bh
    return np.where(better, h, bh), np.where(better, i, br), np.where(better, m, bm)


def lazy_best_result(best):
    """Merge the cells of a lane, then the lanes by a butterfly."""
    bh, br, bm = best
    H, R, M = bh[:, 0], br[:, 0], bm[:, 0]
    for c in range(1, bh.shape[1]):
        H, R, M = best_merge(H, R, M, bh[:, c], br[:, c], bm[:, c])
    for o in (16, 8, 4, 2, 1):
        H, R, M = best_merge(H, R, M, H[LANE ^ o], R[LANE ^ o], M[LANE ^ o])
    return int(H[0]), int(M[0]) if H[0] > 0 else 0


def pair_h_side(h, is_match, p, npass, kbase, lane_g):
    """One row's h side: the key window; returns (h', j*, the flags the
    m side needs)."""
    hup = shfl_down(h[:, 0], 1)
    hup[31] = NEG
    cand_d = h + np.where(is_match, p.match, -p.mismatch)
    cand_u = np.concatenate([h[:, 1:], hup[:, None]], axis=1) - p.gap
    t = np.maximum(np.maximum(cand_u, cand_d), 0)
    key = window_max(t * 128 + kbase, npass)
    return (key >> 7) - lane_g, key & 127, (cand_u > cand_d, (cand_u < 0) & (cand_d < 0)), t * 128 + kbase


def pair_m_side(m, mup, flags, is_match, js):
    """The same row's m side, from the previous row's m (mup: m[:, 0] one
    lane up, as __shfl_down_sync gives it): mt, then mt[j*] fetched with
    one __shfl_sync per cell of a lane."""
    up, floor0 = flags
    C = m.shape[1]
    mup = mup.copy()
    mup[31] = 0
    mu = np.concatenate([m[:, 1:], mup[:, None]], axis=1)
    mt = np.where(floor0, 0, np.where(up, mu, m + is_match))
    src, cell = js // C, js % C
    return np.choose(cell, [mt[src, cc] for cc in range(C)])


def warp_pairstate(q, refwin, length, L, p, reach, rng):
    W = p.band
    C = W // 32
    d = LANE[:, None] * C + np.arange(C)[None, :]
    lane_g = d * p.gap
    kbase = lane_g * 128 + d
    key32 = max(p.match, 0) * L + p.gap * (W - 1) < (1 << 24)
    z = np.zeros((LANES, C), np.int64)
    h, m = z.copy(), z.copy()
    # "row -1": its m side gives m = 0 everywhere and no better best
    flags, matched, js = (z.astype(bool), ~z.astype(bool)), z.astype(bool), d.copy()
    best = (z.copy(), np.full((LANES, C), BIG), z.copy())
    for i, qc, rc in staged_rows(q, refwin, L, W, length, rng):
        is_match = (qc == rc) & (qc < 4)
        mup = shfl_down(m[:, 0], 1)
        hn, jsn, flagsn, key = pair_h_side(h, is_match, p, passes(reach), kbase, lane_g)
        assert not key32 or key.max() < 2**31
        m = pair_m_side(m, mup, flags, matched, js)  # row i-1's m side, one row late
        best = lazy_best_update(best, h, m, i - 1)
        h, js, flags, matched = hn, jsn, flagsn, is_match
    if length > 0:
        m = pair_m_side(m, shfl_down(m[:, 0], 1), flags, matched, js)
        best = lazy_best_update(best, h, m, length - 1)
    return lazy_best_result(best)


def model_banded_sw(q, refwin, lengths, p, seed=0):
    """The kernels' grid: one block of one warp per read."""
    B, L = q.shape
    mbits = ex.packed_mbits(L, ex.ExtendParams(*p))
    reach = ex._gap_reach(p.band, p.max_gap)
    rng = np.random.default_rng(seed)
    score, mlen = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), L)
        if mbits:
            out = warp_packed(q[b], refwin[b], length, L, p, mbits, reach, rng)
        else:
            out = warp_pairstate(q[b], refwin[b], length, L, p, reach, rng)
        score[b], mlen[b] = out
    return score, mlen


def _case(seed, B, L, W, alphabet=4, sub=0.1, lengths=None):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, alphabet, 20_000).astype(np.uint8)
    starts = rng.integers(0, len(ref) - L - W, B)
    q = np.stack([ref[s : s + L] for s in starts])
    mut = rng.random(q.shape) < sub
    q[mut] = rng.integers(0, alphabet, int(mut.sum()))
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    for b, n in enumerate(lengths or []):
        lens[b] = n
    for b in range(B):
        q[b, max(lens[b], 0):] = 4
    refwin = np.array(ref_ex.extract_ref_windows(
        jnp.asarray(ref), jnp.asarray(starts.astype(np.int32)), L, W))
    return q, refwin, lens


BIG_MATCH = 1 << 18  # packed_mbits 0 at these L: the pair-state branch

CASES = [  # (id, B, L, band, max_gap, match, alphabet, lengths)
    ("packed-w64-gap16", 7, 384, 64, 16, 2, 4, [0, 1, 384]),
    ("packed-w64-gap20", 5, 300, 64, 20, 2, 4, [384, 1]),
    ("packed-w64-gap0-ties", 5, 256, 64, 0, 2, 2, [0, 256]),
    ("packed-w128-gap16", 5, 320, 128, 16, 2, 4, [320, 0, 1]),
    ("packed-w128-gap20-ties", 3, 256, 128, 20, 2, 2, [256]),
    ("packed-w128-gap0", 3, 200, 128, 0, 2, 4, [1, 200]),
    ("packed-w64-gap1", 3, 256, 64, 1, 2, 4, [256]),
    ("packed-w128-gap2", 3, 256, 128, 2, 2, 4, [256]),
    ("pair-w64-gap16-ties", 7, 384, 64, 16, BIG_MATCH, 2, [0, 1, 384]),
    ("pair-w64-gap20", 5, 300, 64, 20, BIG_MATCH, 4, [300, 1]),
    ("pair-w64-gap0-ties", 3, 256, 64, 0, BIG_MATCH, 2, [256]),
    ("pair-w128-gap16-ties", 5, 256, 128, 16, BIG_MATCH, 2, [256, 0]),
    ("pair-w128-gap20", 3, 200, 128, 20, BIG_MATCH, 4, [200, 1]),
    ("pair-w128-gap0", 3, 256, 128, 0, BIG_MATCH, 4, [256]),
    ("pair-w128-gap2-ties", 3, 256, 128, 2, BIG_MATCH, 2, [256]),
    ("pair-w64-gap16-int32key", 3, 256, 64, 16, 40_000, 2, [256, 1]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_warp_model_matches_torch_and_jnp(case):
    _, B, L, W, max_gap, match, alphabet, lengths = case
    p = ref_ex.ExtendParams(band=W, max_gap=max_gap, match=match)
    q, refwin, lens = _case(B * L + W + max_gap, B, L, W, alphabet, lengths=lengths)
    pair_state = ref_ex.packed_mbits(L, p) == 0
    assert pair_state == (match != 2)
    got = model_banded_sw(q, refwin, lens, p, seed=B)
    want = ex.banded_sw_torch(torch.from_numpy(q), torch.from_numpy(refwin),
                              torch.from_numpy(lens), ex.ExtendParams(*p))
    ref = ref_sw_jnp(jnp.asarray(q), jnp.asarray(refwin), jnp.asarray(lens), p)
    for a, b, name in zip(got, want, ("score", "mlen")):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{name} vs banded_sw_torch")
    for a, b, name in zip(got, ref, ("score", "mlen")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} vs banded_sw_jnp")
    assert (got[0][lens <= 0] == 0).all()


@pytest.mark.parametrize("W", [64, 128])
def test_window_max_equals_the_doubling_passes(W):
    """Every pass count of both widths, on values with many ties."""
    rng = np.random.default_rng(W)
    for reach in range(1, W + 1):
        for keyed in (False, True):
            v = rng.integers(0, 6, (LANES, W // 32)).astype(np.int64)
            if keyed:
                v = v * 128 + np.arange(W).reshape(LANES, W // 32)
            want = doubling_passes(v.reshape(-1), reach).reshape(v.shape)  # the flat band
            np.testing.assert_array_equal(window_max(v, passes(reach)), want,
                                          err_msg=f"W={W} reach={reach} keyed={keyed}")


def test_key_carries_the_rightmost_argmax_and_its_m():
    """The reference's pass on (u, m) equals the max of u * 128 + j, with
    m read back at j: the pair state's key."""
    rng = np.random.default_rng(5)
    W = 64
    for reach in (1, 2, 16, 20, 64):
        u = rng.integers(0, 4, (200, W)).astype(np.int32)
        m = rng.integers(0, 50, (200, W)).astype(np.int32)
        pu, pm = ref_ex._prefix_max_pair(jnp.asarray(u), jnp.asarray(m), W, reach)
        key = doubling_passes(u.astype(np.int64) * 128 + np.arange(W), reach)
        np.testing.assert_array_equal(key >> 7, np.asarray(pu))
        np.testing.assert_array_equal(np.take_along_axis(m, key & 127, axis=1), np.asarray(pm))


@pytest.mark.parametrize("W", [64, 128])
def test_pair_row_on_tie_rich_states(W):
    """One pair-state row of the model (h side, then m side) from states
    drawn from a few values, so the up, diagonal and horizontal
    candidates tie often, against the reference's row update."""
    rng = np.random.default_rng(11 + W)
    C = W // 32
    d = LANE[:, None] * C + np.arange(C)[None, :]
    for max_gap in (16, 20, 0, 2):
        p = ref_ex.ExtendParams(band=W, max_gap=max_gap)
        reach = ref_ex._gap_reach(W, max_gap)
        for _ in range(40):
            h = rng.integers(0, 4, (LANES, C)).astype(np.int64) * 2
            m = rng.integers(0, 40, (LANES, C)).astype(np.int64)
            qc = int(rng.integers(0, 5))
            rc = rng.integers(0, 5, (LANES, C))
            is_match = (qc == rc) & (qc < 4)
            hn, js, flags, _ = pair_h_side(h, is_match, p, passes(reach), d * p.gap * 128 + d,
                                           d * p.gap)
            mn = pair_m_side(m, shfl_down(m[:, 0], 1), flags, is_match, js)
            want = ref_ex._row_update(jnp.asarray(h.reshape(1, W)), jnp.asarray(m.reshape(1, W)),
                                      jnp.full((1, 1), qc), jnp.asarray(rc.reshape(1, W)),
                                      jnp.arange(W) * p.gap, p)
            np.testing.assert_array_equal(hn.reshape(1, W), np.asarray(want[0]))
            np.testing.assert_array_equal(mn.reshape(1, W), np.asarray(want[1]))


def test_lazy_best_equals_the_per_row_rule():
    """Per-cell lazy bests merged at the end equal the reference's per-row
    rule (row best rb taken on rb > best, with the max m among cells at
    rb), on tie-rich row sequences."""
    rng = np.random.default_rng(3)
    for W in (64, 128):
        C = W // 32
        for _ in range(60):
            rows = int(rng.integers(1, 30))
            H = rng.integers(0, 4, (rows, LANES, C)).astype(np.int64)
            M = rng.integers(0, 9, (rows, LANES, C)).astype(np.int64)
            best, bm = 0, 0
            for i in range(rows):
                rb = H[i].max()
                if rb > best:
                    best, bm = int(rb), int(M[i][H[i] == rb].max())
            z = np.zeros((LANES, C), np.int64)
            lazy = (z, np.full((LANES, C), BIG), z)
            for i in range(rows):
                lazy = lazy_best_update(lazy, H[i], M[i], i)
            assert lazy_best_result(lazy) == (best, bm)

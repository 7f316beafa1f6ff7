// Banded Smith–Waterman extension kernels for Hopper (sm_90a).
//
// Two kernels compute the per-read (best local score, matched bases on
// that path) of a banded, linear-gap Smith–Waterman.  Row i of the DP
// pairs read base q[b, i] with the reference window
// refwin[b, i .. i + W), so the band is W cells wide and advances one
// reference base per row.  Per row:
//
//   diagonal   cand_d[d] = H[d] + (match ? +match : -mismatch)
//   up         cand_u[d] = H[d + 1] - gap          (NEG past the band)
//   t[d]       = max(cand_u, cand_d), floored at 0 (local alignment)
//   horizontal u = t + d*gap; windowed prefix max by doubling passes
//              s = 1, 2, 4, ... < reach (NEG fill); H' = max(u - d*gap, t)
//
// exactly as monica_tpu/ops/extend.py does it, so results are
// bit-equal to the reference's banded_sw_jnp.  The passes make the
// window the next power of two >= reach (reach 20 -> 32 cells, reach 1
// -> none); the kernels run the same passes.
//
// * banded_sw_packed<W> replaces the Pallas kernels
//   extend.py:_sw_kernel_pairs (driven by banded_sw_pairs) at W = 64 and
//   extend.py:_sw_kernel_packed (driven by banded_sw_pallas) at W = 128.
//   State is one int32 per cell, P = score << mbits | mlen, whose
//   integer order is the (score, mlen) order.
// * banded_sw_pairstate<W> replaces extend.py:_sw_kernel (driven by
//   banded_sw_pallas) for reads too long for the packed state (the
//   32 kb bucket at W = 64): separate int32 H and M, strict '>'
//   selections, and per row the max M among the cells tied at the row's
//   best H, taken only on a strictly better row.
//
// What bounds them on this card.  The work is integer ALU: with the
// fused DPX forms below, ~10 instructions a cell for packed and ~21 for
// pair state (reach 16; chip_smoke.py's sw_bound counts them), so
// 8 x 32768 x 64 pair-state cells need ~21 us at 16.7 T int32
// instructions/s (132 SMs x 64 INT32 lanes x 1.98 GHz); the bytes (2 a
// row) need far less.  But the main path launches them on few reads (a rescue tier of
// ~33 reads, a bucket of 128), so few SMs have work and the time is the
// number of rows times the latency of one row's dependent chain: the
// up-neighbour, then the horizontal windowed max.  PERF.md has the times
// and cycles a row.
//
// The design cuts that chain:
// * One warp per read, one read per block (4 or 8 reads a block share
//   an SM's shuffle unit and ran slower at the main path's B; PERF.md).
//   The band lives in registers, C = W/32 contiguous cells
//   per lane (lane l holds cells l*C .. l*C + C-1).  The up-neighbour is
//   the lane's own next cell, or one __shfl_down_sync for its last cell
//   (NEG past the band).  Only warp shuffles and __syncwarp: no block
//   barrier anywhere, so no read waits for another.
// * The windowed max is one round of shuffles, not log2(window) rounds:
//   a window of K lanes is a suffix of lane l-K, lanes l-K+1 .. l-1
//   whole (their lane maxima) and a prefix of lane l, all shuffled at
//   once and reduced by a tree (window_max).  Max is associative, so any
//   grouping of the same window is bit-equal.
// * Pair state keys the window: the reference's pass rule "take the left
//   (u, m) only if its u is strictly greater" keeps the rightmost argmax
//   j* of u, which is the max of u * 128 + j; m is then fetched from lane
//   j*/C.  So the pass is a plain max and the h chain never waits for m.
//   Each row's m side (its selections, the fetch, the lazy best) runs
//   one row behind, while the next row's h side waits on its shuffles.
// * Each read stops at its own length: rows at or past it do not count
//   towards the best, and later rows cannot change earlier ones.
// * Byte loads stay off the row chain: each warp stages its query bytes
//   and reference window in shared memory in chunks of ROWS rows,
//   double-buffered, the next chunk loaded during this one (16-byte
//   cp.async when the rows are 16-byte aligned, else byte copies), and
//   reads each row's bytes a row ahead.
// * Hopper's DPX instructions where they map: t = __viaddmax_s32_relu
//   (max(P + sub, cand_u, 0)), P' = __viaddmax_s32(u, -d*gap, t) and the
//   window's three-way __vimax3_s32.  The pair state's strict '>'
//   selections of M became the key's plain max, so __vibmax_s32 has no
//   place left.
// * The window's pass count is a template parameter (0 .. log2 W), so
//   every register index is static; the entry points pick the instance
//   from reach.
// * Pair state keeps a lazy best per cell in place of the reference's
//   per-row W-lane reduction (below), reduced once per read at the end.
//
// The lazy best of the pair state.  The reference takes, on each row
// i < len with row best rb = max_d H[i, d] > best, best = rb and
// bm = max M[i, d] over the cells with H[i, d] = rb.  Each cell keeps
// (bh, br, bm): its best H over the rows, updated only on a strictly
// greater value, the first row br that reached it, and its M at that
// row.  At the end one warp reduction takes H* = max bh, r* = the least
// br among cells with bh = H*, and m = the max bm among cells with
// bh = H* and br = r*; the result is (0, 0) if H* = 0.  This is the
// reference's answer: the best only rises strictly, so its final value
// is H* (or 0), and its M is that of the first row r* at which any cell
// reaches H*.  At r* the cells with H = H* are exactly those whose bh is
// H* and whose br is r*, so m is the max M among them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 128;  // DP rows per staged chunk

template <int W>
constexpr int log2_width() {
  static_assert(W == 64 || W == 128, "band widths 64 and 128");
  return W == 64 ? 6 : 7;
}

struct SwParams {
  int match;
  int mismatch;
  int gap;
  int mbits;  // mlen bits of the packed state (packed kernel only)
};

struct SwArgs {
  const uint8_t* q;
  const uint8_t* refwin;
  const int* lengths;
  int* score;
  int* mlen;
  int B;
  int L;
  bool vec;  // rows 16-byte aligned: stage them with cp.async
  SwParams p;
};

// One warp's staged bytes, double-buffered by chunk parity.
template <int W>
struct __align__(16) Stage {
  uint8_t q[2][ROWS];
  uint8_t r[2][ROWS + W];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Stage rows i0 .. i0 + ROWS of one read: its query bytes [i0, i0 + ROWS)
// and reference bytes [i0, i0 + ROWS + W), clipped to the row ends L and
// L + W.  vec: L % 16 == 0 and both bases 16-byte aligned.
template <int W>
__device__ __forceinline__ void stage_chunk(uint8_t* sq, uint8_t* sr, const uint8_t* qr,
                                            const uint8_t* rr, int i0, int L, bool vec,
                                            int lane) {
  if (vec) {
    constexpr int NQ = ROWS / 16, NR = (ROWS + W) / 16;
    static_assert(NQ + NR <= 32, "one 16-byte piece per lane");
    if (lane < NQ) {
      const int g = i0 + 16 * lane;
      if (g < L) cp_async16(sq + 16 * lane, qr + g);
    } else if (lane < NQ + NR) {
      const int k = lane - NQ, g = i0 + 16 * k;
      if (g < L + W) cp_async16(sr + 16 * k, rr + g);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int j = lane; j < ROWS; j += 32)
      if (i0 + j < L) sq[j] = qr[i0 + j];
    for (int j = lane; j < ROWS + W; j += 32)
      if (i0 + j < L + W) sr[j] = rr[i0 + j];
  }
}

__device__ __forceinline__ void wait_chunk() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ int kmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ long long kmax(long long a, long long b) { return a > b ? a : b; }
__device__ __forceinline__ int kmax3(int a, int b, int c) { return __vimax3_s32(a, b, c); }
__device__ __forceinline__ long long kmax3(long long a, long long b, long long c) {
  return kmax(kmax(a, b), c);
}

// All ones where lane - dl is a lane of the warp, else 0.
__device__ __forceinline__ int live_mask(int lane, int dl) { return (dl - 1 - lane) >> 31; }

// The horizontal windowed max: v[d] = max(v[d - 2^NPASS + 1 .. d]),
// cells below 0 left out, over a warp's band of C = W/32 cells a lane.
// It equals the reference's NPASS doubling passes: max is associative,
// and their NEG fill never wins, since every value here is >= 0 (0 is
// then the identity of a masked-out lane).  For a window of K >= 1
// lanes, cell d = l*C + c takes
//   suffix c+1.. of lane l-K  |  lanes l-K+1 .. l-1 whole  |  cells 0..c of lane l,
// all shuffled in one round (no pass waits for another), then a tree.
// between() runs after the shuffles are issued, before their results
// are used: independent work that the warp issues while they fly.
template <int W, int NPASS, typename K, class Between>
__device__ __forceinline__ void window_max(K (&v)[W / 32], int lane, Between between) {
  constexpr int C = W / 32;
  constexpr int WN = 1 << NPASS;
  if constexpr (WN == 1) {
    between();
  } else {
    K pre[C], suf[C];
    pre[0] = v[0];
#pragma unroll
    for (int c = 1; c < C; ++c) pre[c] = kmax(pre[c - 1], v[c]);
    suf[C - 1] = v[C - 1];
#pragma unroll
    for (int c = C - 2; c >= 0; --c) suf[c] = kmax(suf[c + 1], v[c]);
    if constexpr (WN >= C) {
      constexpr int KL = WN / C;  // lanes the window reaches
      K s[KL];                    // s[dl-1]: lane l-dl whole; s[KL-1] unused
      K part[C];                  // cells c+1 .. C-1 of lane l-KL
#pragma unroll
      for (int dl = 1; dl < KL; ++dl) s[dl - 1] = __shfl_up_sync(FULL, pre[C - 1], dl);
#pragma unroll
      for (int c = 0; c + 1 < C; ++c) part[c] = __shfl_up_sync(FULL, suf[c + 1], KL);
      between();
      K mid = 0;  // lanes l-KL+1 .. l-1
      if constexpr (KL > 1) {
#pragma unroll
        for (int dl = 1; dl < KL; ++dl) s[dl - 1] &= static_cast<K>(live_mask(lane, dl));
#pragma unroll
        for (int w = 1; w < KL - 1; w *= 2)
#pragma unroll
          for (int i = 0; i + w < KL - 1; i += 2 * w) s[i] = kmax(s[i], s[i + w]);
        mid = s[0];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const K pc = c + 1 < C ? part[c] & static_cast<K>(live_mask(lane, KL)) : K(0);
        v[c] = kmax3(pre[c], mid, pc);
      }
    } else {  // a window shorter than a lane: cells c-WN+1 .. c
      K prev[C];  // suffix C+lo.. of lane l-1, for the cells whose window starts there
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c - WN + 1 < 0) prev[c] = __shfl_up_sync(FULL, suf[C + c - WN + 1], 1);
      between();
      K out[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int lo = c - WN + 1;
        if (lo >= 0) {
          out[c] = v[lo];
#pragma unroll
          for (int k = lo + 1; k <= c; ++k) out[c] = kmax(out[c], v[k]);
        } else {
          out[c] = kmax(pre[c], prev[c] & static_cast<K>(live_mask(lane, 1)));
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = out[c];
    }
  }
}

template <int W, int NPASS>
__global__ void __launch_bounds__(32) banded_sw_packed_kernel(SwArgs a) {
  constexpr int C = W / 32;
  __shared__ Stage<W> st;  // one read (warp) per block
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int L = a.L;
  const int len = min(max(a.lengths[b], 0), L);
  const uint8_t* qr = a.q + (size_t)b * L;
  const uint8_t* rr = a.refwin + (size_t)b * (L + W);

  const int scale = 1 << a.p.mbits;
  const int sub_match = a.p.match * scale + 1;  // score += match, mlen += 1
  const int sub_mis = -a.p.mismatch * scale;
  const int gap_s = a.p.gap * scale;
  int lane_gp[C], P[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lane_gp[c] = (lane * C + c) * gap_s;
    P[c] = 0;
  }
  int best = 0;  // lazy best over this lane's cells and the read's rows

  if (len > 0) stage_chunk<W>(st.q[0], st.r[0], qr, rr, 0, L, a.vec, lane);
  for (int i0 = 0, buf = 0; i0 < len; i0 += ROWS, buf ^= 1) {
    wait_chunk();
    if (i0 + ROWS < len)
      stage_chunk<W>(st.q[buf ^ 1], st.r[buf ^ 1], qr, rr, i0 + ROWS, L, a.vec, lane);
    const uint8_t* sq = st.q[buf];
    const uint8_t* sr = st.r[buf] + lane * C;
    const int n = min(ROWS, len - i0);
    int qn = sq[0], rn[C];  // the next row's bytes, loaded a row ahead
#pragma unroll
    for (int c = 0; c < C; ++c) rn[c] = sr[c];
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const int qc = qn;
      int sub[C];
#pragma unroll
      for (int c = 0; c < C; ++c) sub[c] = (qc == rn[c] && qc < 4) ? sub_match : sub_mis;
      const int jn = j + 1 < n ? j + 1 : j;
      qn = sq[jn];
#pragma unroll
      for (int c = 0; c < C; ++c) rn[c] = sr[jn + c];

      int up = __shfl_down_sync(FULL, P[0], 1);
      if (lane == 31) up = NEG;
      int t[C], u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int pu = (c + 1 < C ? P[c + 1] : up) - gap_s;
        t[c] = __viaddmax_s32_relu(P[c], sub[c], pu);  // max(P + sub, cand_u, 0)
        u[c] = t[c] + lane_gp[c];
      }
      window_max<W, NPASS, int>(u, lane, [] {});
#pragma unroll
      for (int c = 0; c < C; ++c) {
        P[c] = __viaddmax_s32(u[c], -lane_gp[c], t[c]);  // max(u - d*gap, t)
        best = max(best, P[c]);
      }
    }
    __syncwarp();  // every lane is done with buf before it is restaged
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) {
    a.score[b] = best >> a.p.mbits;
    a.mlen[b] = best & ((1 << a.p.mbits) - 1);
  }
}

// Merge two lazy bests (h, first row, m at that row): the larger h, then
// the earlier row, then at equal (h, row) the larger m.
__device__ __forceinline__ void best_merge(int& h, int& r, int& m, int oh, int orr, int om) {
  const bool eq = oh == h && orr == r;
  const bool take = oh > h || (oh == h && orr < r);
  m = take ? om : (eq ? max(m, om) : m);
  h = take ? oh : h;
  r = take ? orr : r;
}

// Pair state.  The horizontal pass carries (u, m) with the rule "take the
// left only if its u is strictly greater": the window's rightmost argmax
// j* of u, with its m.  The kernel takes the window max of the key
// u * 128 + j, which is that argmax, and then fetches mt[j*] with one
// shuffle per cell of a lane.  The row's new h is then max u - d*gap
// and its m is mt[j*]: when j* = d, hz = t and the reference keeps
// (t, mt[d]); otherwise u[j*] > u[d], so hz > t and it takes the pass's
// (hz, mt[j*]).  K is int when u * 128 + 127 fits, else long long.
//
// The h side never reads m, so each row's m side (mt, the fetch, the
// lazy best) runs one row late, in the same loop body as the next row's
// h side: the in-order warp issues it while the h chain waits on its
// shuffles.
template <int W, int NPASS, typename K>
__global__ void __launch_bounds__(32) banded_sw_pairstate_kernel(SwArgs a) {
  constexpr int C = W / 32;
  __shared__ Stage<W> st;  // one read (warp) per block
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int L = a.L;
  const int len = min(max(a.lengths[b], 0), L);
  const uint8_t* qr = a.q + (size_t)b * L;
  const uint8_t* rr = a.refwin + (size_t)b * (L + W);
  const int match = a.p.match, mismatch = a.p.mismatch, gap = a.p.gap;

  int lane_g[C], h[C], m[C];
  K kbase[C];  // d*gap*128 + d
  // the previous row's m side: its cells' selections and argmaxes
  bool up[C], floor0[C], matched[C];
  int js[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = lane * C + c;
    lane_g[c] = d * gap;
    kbase[c] = static_cast<K>(lane_g[c]) * 128 + d;
    h[c] = 0;
    m[c] = 0;
    up[c] = false;
    floor0[c] = true;  // "row -1": m = 0 everywhere, h = 0
    matched[c] = false;
    js[c] = d;
  }
  int bh[C], br[C], bm[C];  // each cell's lazy best (see the note)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bh[c] = 0;
    br[c] = 0x7fffffff;
    bm[c] = 0;
  }

  // m side of row i: mt from row i-1's m (mup: its m[0] one lane up),
  // the fetch of mt[j*], then the lazy best with row i's h
  auto m_side = [&](int i, int mup) {
    if (lane == 31) mup = 0;
    int mt[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int mu = c + 1 < C ? m[c + 1] : mup;
      const int md = m[c] + (matched[c] ? 1 : 0);
      mt[c] = floor0[c] ? 0 : (up[c] ? mu : md);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int src = js[c] / C, cell = js[c] % C;
      int mj = __shfl_sync(FULL, mt[0], src);
#pragma unroll
      for (int cc = 1; cc < C; ++cc) {
        const int g = __shfl_sync(FULL, mt[cc], src);
        mj = cell == cc ? g : mj;
      }
      m[c] = mj;
      const bool better = h[c] > bh[c];  // a strictly greater h, in a later row
      bh[c] = better ? h[c] : bh[c];
      br[c] = better ? i : br[c];
      bm[c] = better ? mj : bm[c];
    }
  };

  if (len > 0) stage_chunk<W>(st.q[0], st.r[0], qr, rr, 0, L, a.vec, lane);
  for (int i0 = 0, buf = 0; i0 < len; i0 += ROWS, buf ^= 1) {
    wait_chunk();
    if (i0 + ROWS < len)
      stage_chunk<W>(st.q[buf ^ 1], st.r[buf ^ 1], qr, rr, i0 + ROWS, L, a.vec, lane);
    const uint8_t* sq = st.q[buf];
    const uint8_t* sr = st.r[buf] + lane * C;
    const int n = min(ROWS, len - i0);
    int qn = sq[0], rn[C];  // the next row's bytes, loaded a row ahead
#pragma unroll
    for (int c = 0; c < C; ++c) rn[c] = sr[c];
#pragma unroll 4  // lets the compiler overlap one row's m side with the next h side
    for (int j = 0; j < n; ++j) {
      const int qc = qn;
      bool is_match[C];
#pragma unroll
      for (int c = 0; c < C; ++c) is_match[c] = qc == rn[c] && qc < 4;
      const int jn = j + 1 < n ? j + 1 : j;
      qn = sq[jn];
#pragma unroll
      for (int c = 0; c < C; ++c) rn[c] = sr[jn + c];

      // h side of row i0 + j (and the shuffle the m side of row i0 + j - 1 needs)
      int hup = __shfl_down_sync(FULL, h[0], 1);
      const int mup = __shfl_down_sync(FULL, m[0], 1);
      if (lane == 31) hup = NEG;
      bool upn[C], floorn[C];
      K key[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cand_d = h[c] + (is_match[c] ? match : -mismatch);
        const int cand_u = (c + 1 < C ? h[c + 1] : hup) - gap;
        const int t = __viaddmax_s32_relu(cand_u, 0, cand_d);  // max(cand_u, cand_d, 0)
        upn[c] = cand_u > cand_d;
        floorn[c] = cand_u < 0 && cand_d < 0;
        key[c] = static_cast<K>(t) * 128 + kbase[c];
      }
      // the m side of row i0 + j - 1 runs while the window's shuffles fly
      window_max<W, NPASS, K>(key, lane, [&] { m_side(i0 + j - 1, mup); });
#pragma unroll
      for (int c = 0; c < C; ++c) {
        h[c] = static_cast<int>(key[c] >> 7) - lane_g[c];
        up[c] = upn[c];
        floor0[c] = floorn[c];
        matched[c] = is_match[c];
        js[c] = static_cast<int>(key[c] & 127);
      }
    }
    __syncwarp();  // every lane is done with buf before it is restaged
  }
  if (len > 0) m_side(len - 1, __shfl_down_sync(FULL, m[0], 1));

  // H* = max bh; r* = least br at H*; m = max bm at (H*, r*)
#pragma unroll
  for (int c = 1; c < C; ++c) best_merge(bh[0], br[0], bm[0], bh[c], br[c], bm[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int oh = __shfl_xor_sync(FULL, bh[0], o);
    const int orr = __shfl_xor_sync(FULL, br[0], o);
    const int om = __shfl_xor_sync(FULL, bm[0], o);
    best_merge(bh[0], br[0], bm[0], oh, orr, om);
  }
  if (lane == 0) {
    a.score[b] = bh[0];
    a.mlen[b] = bh[0] > 0 ? bm[0] : 0;
  }
}

// Launch the instance for this many passes: NPASS = ceil(log2(reach)).
template <int W, int NPASS = 0>
int launch_packed(const SwArgs& a, int npass, cudaStream_t s) {
  if constexpr (NPASS > log2_width<W>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (npass != NPASS) return launch_packed<W, NPASS + 1>(a, npass, s);
    banded_sw_packed_kernel<W, NPASS><<<a.B, 32, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int W, typename K, int NPASS = 0>
int launch_pairstate(const SwArgs& a, int npass, cudaStream_t s) {
  if constexpr (NPASS > log2_width<W>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (npass != NPASS) return launch_pairstate<W, K, NPASS + 1>(a, npass, s);
    banded_sw_pairstate_kernel<W, NPASS, K><<<a.B, 32, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

// The reference's passes s = 1, 2, 4, ... < reach: ceil(log2(reach)).
int passes(int reach) {
  int n = 0;
  while ((1 << n) < reach) ++n;
  return n;
}

SwArgs make_args(const void* q, const void* refwin, const void* lengths, void* score,
                 void* mlen, int B, int L, SwParams p) {
  const bool vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(refwin) % 16 == 0;
  return SwArgs{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(refwin),
                static_cast<const int*>(lengths), static_cast<int*>(score),
                static_cast<int*>(mlen), B, L, vec, p};
}

}  // namespace

// C entry points (bound with ctypes).  Pointers are device pointers:
// q (B, L) uint8, refwin (B, L + W) uint8, lengths (B,) int32,
// score/mlen (B,) int32 outputs.  Each launches on the given stream,
// allocates nothing and returns cudaGetLastError() after the launch
// (0 = success).  An unsupported W, a reach outside 1..W or a negative
// gap (the windowed max takes every u >= 0) returns
// cudaErrorInvalidValue without launching.

extern "C" int monica_banded_sw_packed(const void* q, const void* refwin, const void* lengths,
                                       void* score, void* mlen, int B, int L, int W, int match,
                                       int mismatch, int gap, int reach, int mbits,
                                       void* stream) {
  if (reach < 1 || reach > W || gap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const SwArgs a = make_args(q, refwin, lengths, score, mlen, B, L, {match, mismatch, gap, mbits});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64:
      return launch_packed<64>(a, passes(reach), s);
    case 128:
      return launch_packed<128>(a, passes(reach), s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int monica_banded_sw_pairstate(const void* q, const void* refwin, const void* lengths,
                                          void* score, void* mlen, int B, int L, int W, int match,
                                          int mismatch, int gap, int reach, void* stream) {
  if (reach < 1 || reach > W || gap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const SwArgs a = make_args(q, refwin, lengths, score, mlen, B, L, {match, mismatch, gap, 0});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // u <= match * L + gap * (W - 1); the key u * 128 + 127 must fit its type
  const long long umax = static_cast<long long>(match > 0 ? match : 0) * L +
                         static_cast<long long>(gap) * (W - 1);
  const bool key32 = umax < (1LL << 24);
  const int np = passes(reach);
  switch (W) {
    case 64:
      return key32 ? launch_pairstate<64, int>(a, np, s) : launch_pairstate<64, long long>(a, np, s);
    case 128:
      return key32 ? launch_pairstate<128, int>(a, np, s)
                   : launch_pairstate<128, long long>(a, np, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// bit-equal to the reference's banded_sw_jnp.
//
// * banded_sw_packed<W> replaces the Pallas kernels _sw_kernel_pairs
//   (extend.py:424-499, driven by banded_sw_pairs) at W = 64 and
//   _sw_kernel_packed (extend.py:309-351, driven by banded_sw_pallas)
//   at W = 128.  State is one int32 per cell, P = score << mbits | mlen,
//   whose integer order is the (score, mlen) order.  The TPU kernel's
//   lane-parity interleave of two reads is a 128-lane layout trick and
//   is not carried over.
// * banded_sw_pairstate<W> replaces _sw_kernel (extend.py:258-306,
//   driven by banded_sw_pallas) for reads too long for the packed state
//   (the 32 kb bucket at W = 64): separate int32 H and M, strict '>'
//   selections, and per row the max M among the cells tied at the
//   row's best H, taken only on a strictly better row.
//
// Mapping (a simple first version): one read per W threads, one band
// cell per thread, READS_PER_BLOCK reads per block.  The row state is
// double-buffered in shared memory by row parity; each prefix-max pass
// goes through a shared buffer with one __syncthreads().  A block stops
// after the longest of its reads; rows at or past a read's length do
// not update its best (they could not raise it anyway).
//
// What bounds it: integer ALU work and block synchronisation, not
// memory.  Each cell reads 2 bytes per row (one broadcast query byte,
// one coalesced reference byte) against ~20 integer ops and
// 1 + log2(reach) barriers per row, so the design keeps everything but
// those two loads in registers and shared memory.  Warp-shuffle
// mappings without block barriers are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int READS_PER_BLOCK = 2;

struct SwParams {
  int match;
  int mismatch;
  int gap;
  int reach;  // horizontal prefix-max reach in lanes
  int mbits;  // mlen bits of the packed state (packed kernel only)
};

// Rows the block must run: the longest of its reads, clamped to L.
__device__ __forceinline__ int block_rows(const int* lengths, int B, int L) {
  int n = 0;
  for (int r = 0; r < READS_PER_BLOCK; ++r) {
    const int b = blockIdx.x * READS_PER_BLOCK + r;
    if (b < B) n = max(n, min(max(lengths[b], 0), L));
  }
  return n;
}

template <int W>
__global__ void __launch_bounds__(W * READS_PER_BLOCK)
banded_sw_packed_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ refwin,
                        const int* __restrict__ lengths, int* __restrict__ score,
                        int* __restrict__ mlen, int B, int L, SwParams p) {
  __shared__ int state[2][READS_PER_BLOCK][W];  // previous row P, by row parity
  __shared__ int scan[2][READS_PER_BLOCK][W];   // prefix-max pass buffers
  __shared__ int part[READS_PER_BLOCK][W / 32]; // per-warp partial maxima

  const int d = threadIdx.x;
  const int r = threadIdx.y;
  const int b = blockIdx.x * READS_PER_BLOCK + r;
  const bool live = b < B;
  const int len = live ? min(max(lengths[b], 0), L) : 0;
  const int n_rows = block_rows(lengths, B, L);
  const uint8_t* qr = q + (size_t)(live ? b : 0) * L;
  const uint8_t* rr = refwin + (size_t)(live ? b : 0) * (L + W);

  const int scale = 1 << p.mbits;
  const int lane_gp = d * (p.gap << p.mbits);
  const int sub_match = p.match * scale + 1;  // score += match, mlen += 1
  const int sub_mis = -p.mismatch * scale;
  const int gap_s = p.gap * scale;

  int P = 0;     // this cell's state in the previous row
  int best = 0;  // lazy per-lane best over the read's rows
  state[0][r][d] = 0;
  __syncthreads();

  for (int i = 0; i < n_rows; ++i) {
    const int cur = i & 1;
    const int qc = qr[i];
    const int rc = rr[i + d];
    const int cand_d = P + ((qc == rc && qc < 4) ? sub_match : sub_mis);
    const int cand_u = (d + 1 < W ? state[cur][r][d + 1] : NEG) - gap_s;
    const int t = max(max(cand_u, cand_d), 0);
    int u = t + lane_gp;
    int buf = 0;
    for (int s = 1; s < p.reach; s *= 2) {
      scan[buf][r][d] = u;
      __syncthreads();
      u = max(u, d >= s ? scan[buf][r][d - s] : NEG);
      buf ^= 1;
    }
    P = max(u - lane_gp, t);
    if (i < len) best = max(best, P);
    state[cur ^ 1][r][d] = P;
    __syncthreads();
  }

  // best over the W lanes: warp shuffles, then the W/32 warp partials
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((d & 31) == 0) part[r][d >> 5] = best;
  __syncthreads();
  if (d == 0 && live) {
    int m = part[r][0];
    for (int k = 1; k < W / 32; ++k) m = max(m, part[r][k]);
    score[b] = m >> p.mbits;
    mlen[b] = m & ((1 << p.mbits) - 1);
  }
}

// (h, m) pair reduction: max h, and the max m among cells at that h.
__device__ __forceinline__ void pair_max(int& h, int& m, int oh, int om) {
  if (oh > h) {
    h = oh;
    m = om;
  } else if (oh == h) {
    m = max(m, om);
  }
}

template <int W>
__global__ void __launch_bounds__(W * READS_PER_BLOCK)
banded_sw_pairstate_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ refwin,
                           const int* __restrict__ lengths, int* __restrict__ score,
                           int* __restrict__ mlen, int B, int L, SwParams p) {
  __shared__ int hst[2][READS_PER_BLOCK][W];  // previous row H, by row parity
  __shared__ int mst[2][READS_PER_BLOCK][W];  // previous row M
  __shared__ int su[2][READS_PER_BLOCK][W];   // prefix-max pass buffers (u, m)
  __shared__ int sm[2][READS_PER_BLOCK][W];
  __shared__ int ph[2][READS_PER_BLOCK][W / 32];  // per-warp row partials, by row parity
  __shared__ int pm[2][READS_PER_BLOCK][W / 32];

  const int d = threadIdx.x;
  const int r = threadIdx.y;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int b = blockIdx.x * READS_PER_BLOCK + r;
  const bool live = b < B;
  const int len = live ? min(max(lengths[b], 0), L) : 0;
  const int n_rows = block_rows(lengths, B, L);
  const uint8_t* qr = q + (size_t)(live ? b : 0) * L;
  const uint8_t* rr = refwin + (size_t)(live ? b : 0) * (L + W);
  const int lane_g = d * p.gap;

  int h = 0, m = 0;       // this cell in the previous row
  int best = 0, bm = 0;   // best row score and its mlen
  hst[0][r][d] = 0;
  mst[0][r][d] = 0;
  __syncthreads();

  for (int i = 0; i < n_rows; ++i) {
    const int cur = i & 1;
    const int qc = qr[i];
    const int rc = rr[i + d];
    const bool is_match = qc == rc && qc < 4;
    const int cand_d = h + (is_match ? p.match : -p.mismatch);
    const int md = m + (is_match ? 1 : 0);
    const int cand_u = (d + 1 < W ? hst[cur][r][d + 1] : NEG) - p.gap;
    const int mu = d + 1 < W ? mst[cur][r][d + 1] : 0;
    const bool up = cand_u > cand_d;
    int t = up ? cand_u : cand_d;
    int mt = up ? mu : md;
    if (t < 0) {
      t = 0;
      mt = 0;
    }
    int u = t + lane_g;
    int mh = mt;
    int buf = 0;
    for (int s = 1; s < p.reach; s *= 2) {
      su[buf][r][d] = u;
      sm[buf][r][d] = mh;
      __syncthreads();
      if (d >= s) {
        const int pu = su[buf][r][d - s];
        if (pu > u) {
          u = pu;
          mh = sm[buf][r][d - s];
        }
      }
      buf ^= 1;
    }
    const int hz = u - lane_g;
    if (hz > t) {
      h = hz;
      m = mh;
    } else {
      h = t;
      m = mt;
    }
    hst[cur ^ 1][r][d] = h;
    mst[cur ^ 1][r][d] = m;

    int rh = h, rm = m;
    for (int o = 16; o > 0; o >>= 1) {
      const int oh = __shfl_xor_sync(0xffffffffu, rh, o);
      const int om = __shfl_xor_sync(0xffffffffu, rm, o);
      pair_max(rh, rm, oh, om);
    }
    if (lane == 0) {
      ph[cur][r][warp] = rh;
      pm[cur][r][warp] = rm;
    }
    __syncthreads();
    rh = ph[cur][r][0];
    rm = pm[cur][r][0];
    for (int k = 1; k < W / 32; ++k) pair_max(rh, rm, ph[cur][r][k], pm[cur][r][k]);
    if (i < len && rh > best) {
      best = rh;
      bm = rm;
    }
  }

  if (d == 0 && live) {
    score[b] = best;
    mlen[b] = bm;
  }
}

}  // namespace

// C entry points (bound with ctypes).  Pointers are device pointers:
// q (B, L) uint8, refwin (B, L + W) uint8, lengths (B,) int32,
// score/mlen (B,) int32 outputs.  Each returns cudaGetLastError() after
// the launch (0 = success); an unsupported W returns
// cudaErrorInvalidValue without launching.

extern "C" int monica_banded_sw_packed(const void* q, const void* refwin, const void* lengths,
                                       void* score, void* mlen, int B, int L, int W, int match,
                                       int mismatch, int gap, int reach, int mbits,
                                       void* stream) {
  const SwParams p{match, mismatch, gap, reach, mbits};
  const dim3 grid((B + READS_PER_BLOCK - 1) / READS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* rr = static_cast<const uint8_t*>(refwin);
  const auto* ll = static_cast<const int*>(lengths);
  auto* so = static_cast<int*>(score);
  auto* mo = static_cast<int*>(mlen);
  switch (W) {
    case 64:
      banded_sw_packed_kernel<64><<<grid, dim3(64, READS_PER_BLOCK), 0, s>>>(qq, rr, ll, so, mo, B, L, p);
      break;
    case 128:
      banded_sw_packed_kernel<128><<<grid, dim3(128, READS_PER_BLOCK), 0, s>>>(qq, rr, ll, so, mo, B, L, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int monica_banded_sw_pairstate(const void* q, const void* refwin, const void* lengths,
                                          void* score, void* mlen, int B, int L, int W, int match,
                                          int mismatch, int gap, int reach, void* stream) {
  const SwParams p{match, mismatch, gap, reach, 0};
  const dim3 grid((B + READS_PER_BLOCK - 1) / READS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* rr = static_cast<const uint8_t*>(refwin);
  const auto* ll = static_cast<const int*>(lengths);
  auto* so = static_cast<int*>(score);
  auto* mo = static_cast<int*>(mlen);
  switch (W) {
    case 64:
      banded_sw_pairstate_kernel<64><<<grid, dim3(64, READS_PER_BLOCK), 0, s>>>(qq, rr, ll, so, mo, B, L, p);
      break;
    case 128:
      banded_sw_pairstate_kernel<128><<<grid, dim3(128, READS_PER_BLOCK), 0, s>>>(qq, rr, ll, so, mo, B, L, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The card's integer ALU ceiling, measured: a long dependent chain of
// int32 instructions on every element of an array, reduced to one
// scalar.  It takes the place of scripts/roofline_sw.py's
// measure_vpu_ops_per_s, which times the same int32 chain fused by XLA
// into one TPU kernel (it is no port of a Pallas kernel).  Eager PyTorch
// would run each op of the chain as its own kernel and time the memory,
// not the ALU, so the chain is a kernel of its own here.
//
// Two chains, each unrolled UNROLL steps (a template parameter; the
// library holds UNROLL = 256, 512 and 1024: the caller takes the
// difference of the 256 and 1024 times, which cancels the launch, the
// load and the reduction, and checks with 512 that the time is linear
// in the unroll):
//
// * int32: y = (y + x) ^ (y >> 1) ^ (2k + 1), y = x at the start, the
//   add wrapping, the shift arithmetic: the JAX script's chain, so its
//   scalar is the JAX chain's.  ptxas may fold the two xors into one
//   LOP3, so a step is 3 SASS instructions or fewer; roofline_sw counts
//   them with cuobjdump.
// * dpx: y = __viaddmax_s32(y, a, b) = max(y + a, b) with
//   a = (x & 255) - 128 and b = -(x & 1023), y = x at the start (x < 2^30,
//   so nothing overflows; a and b live in registers, so no step needs a
//   constant moved in): one VIADDMNMX a step, the DPX instruction the
//   banded-SW kernels issue most (banded_sw.cu, the packed row update),
//   so the rate chip_smoke.py's sw_bound assumes for DPX can be read.
//
// What bounds it: nothing but the ALU.  Each element is read once (4
// bytes) for 3 * UNROLL (int32) or UNROLL (dpx) dependent instructions;
// 8 blocks of 256 threads an SM (64 warps resident) walk the 2^21
// elements with a grid stride, so the dependent latency of one chain is
// hidden by the others.  Each thread sums its elements in 32 bits
// (wrapping), each block reduces by shuffles and shared memory and adds
// its sum to the scalar with one atomicAdd (one a block, not one an
// element, so the atomics on one address stay a small fixed cost):
// addition mod 2^32 is associative, so the scalar is the same in every
// run and equal to the low 32 bits of the plain version's int64 sum
// (ops/ceiling.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads: a full SM
constexpr unsigned FULL = 0xffffffffu;

template <int UNROLL>
__device__ __forceinline__ int int32_chain(int x) {
  int y = x;
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    // the add in unsigned arithmetic: it wraps as jnp's and torch's int32 add
    const int s = static_cast<int>(static_cast<unsigned>(y) + static_cast<unsigned>(x));
    y = s ^ (y >> 1) ^ (2 * k + 1);
  }
  return y;
}

template <int UNROLL>
__device__ __forceinline__ int dpx_chain(int x) {
  const int a = (x & 255) - 128;
  const int b = -(x & 1023);
  int y = x;
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) y = __viaddmax_s32(y, a, b);
  return y;
}

template <int UNROLL, bool DPX>
__global__ void __launch_bounds__(THREADS) alu_ceiling_kernel(const int* __restrict__ x, int n,
                                                              unsigned* out) {
  unsigned acc = 0;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
    const int v = x[i];
    acc += static_cast<unsigned>(DPX ? dpx_chain<UNROLL>(v) : int32_chain<UNROLL>(v));
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  __shared__ unsigned warp_sum[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sum[w];
    atomicAdd(out, s);
  }
}

template <int UNROLL>
int launch(const int* x, int n, bool dpx, unsigned* out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int needed = (n + THREADS - 1) / THREADS;
  const int blocks = needed < sms * BLOCKS_PER_SM ? needed : sms * BLOCKS_PER_SM;
  if (dpx)
    alu_ceiling_kernel<UNROLL, true><<<blocks, THREADS, 0, s>>>(x, n, out);
  else
    alu_ceiling_kernel<UNROLL, false><<<blocks, THREADS, 0, s>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes).  x: n int32 on the device; out: one
// int32 on the device, zeroed by the caller, to which the chain's sum is
// added (mod 2^32).  dpx = 0 runs the int32 chain, 1 the DPX chain.
// Launches on the given stream, allocates nothing, returns
// cudaGetLastError() after the launch (0 = success); an unroll other
// than 256, 512 or 1024, or n < 1, returns cudaErrorInvalidValue
// unlaunched.
extern "C" int monica_alu_ceiling(const void* x, int n, int unroll, int dpx, void* out,
                                  void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* xi = static_cast<const int*>(x);
  unsigned* o = static_cast<unsigned*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unroll) {
    case 256:
      return launch<256>(xi, n, dpx != 0, o, s);
    case 512:
      return launch<512>(xi, n, dpx != 0, o, s);
    case 1024:
      return launch<1024>(xi, n, dpx != 0, o, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Matmul with compensated accumulation across K-blocks on Hopper.
//
// Replaces the two Pallas calls of the JAX package that share the body
// _matmul_kernel (repro/kernels/kahan_matmul.py):
//   matmul_accumulators          (:101)  grid (M/bm, N/bn, K/bk)
//   matmul_accumulators_batched  (:153)  grid (batch, M/bm, N/bn, K/bk)
// One C entry point serves both: blockIdx.z is the batch index, and each
// batch index runs the rounding sequence of a single call.
//
// What it computes: every output cell (i, j) walks K in blocks of exactly
// block_k columns, in order. Within block g it forms the block product
//   p = sum_{t in block g} a[i, t] * b[t, j]
// as ONE ascending chain of rounded products and rounded adds (p starts at
// 0), then folds it with the scheme's update from schemes.cuh:
//   update<S>(s, c, p, g)        (g = the K-block index; pairwise's fold
//                                 depends on it)
// and writes s and c once at the end. finalize (s + c) and slicing stay in
// torch (kernels/engine.py), as they stay outside Pallas in the reference.
// Only block_k and this in-block order decide the bits: every cell is
// independent of the others, so the CTA tile below is free, and a row of
// the output is the same bit for bit whatever M is and whatever the other
// rows hold. The plain version (kernels/kahan_matmul.py::matmul_plain)
// repeats the order as a loop over the block's columns, so kernel and
// plain version agree bit for bit. XLA's in-block dot_general order cannot
// be reproduced: against the reference the port holds a tolerance.
//
// Arithmetic: built with -fmad=false like the other sources, so the
// product and the add round separately; no __fmaf_rn anywhere. Operands:
// each is float32 or bfloat16 when the compute dtype is float32 (a dtype
// code per operand), float64 when it is float64, and is widened to the
// compute dtype when it is staged into shared memory. Widening is exact,
// so the bits equal those of operands promoted first, and bf16 weights are
// read as they are stored, never copied. The caller pads M, N and K to its
// blocks with zeros; the kernel masks the rows and columns of its own tile
// past M and N.
//
// Layout: one CTA of 256 threads owns a TM x TN tile of outputs; each
// thread owns RM x RN cells (rows ty + TY * i, columns tx + TX * j, so a
// warp reads consecutive columns) and keeps their p, s and c in
// registers. K is staged through shared memory kTileK columns at a time,
// inside each K-block. Two tiles: 8 x 32 (one cell per thread) when M <= 8,
// the decode projections, where a 64-row tile would leave 56 rows idle;
// 64 x 64 (4 x 4 per thread) otherwise.
//
// What bounds it on the H100: at decode (M = 8 after padding) the bytes of
// B, read once (2 * K * N for bf16 weights) over 3.35 TB/s; at M >= 64
// the 2 * M * N * K float32 operations over 67 TFLOP/s. The fixed
// in-block chain forbids tensor cores and split-K, and separate multiply
// and add halve the CUDA cores' fma rate. This first kernel stages one
// K-slice at a time with no overlap of loads and compute, and at decode
// it has only 64 CTAs for N = 2048 (one output column per thread). Later
// work: form the block products of different K-blocks in parallel and
// fold them in order in a second pass (the fold order, hence the bits,
// unchanged), and double-buffer the staging (cp.async / TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

constexpr int kThreads = 256;
constexpr int kTileK = 32;    // K columns staged per shared-memory step

template <typename T> __device__ __forceinline__ T widen(float x) { return T(x); }
template <typename T> __device__ __forceinline__ T widen(double x) { return T(x); }
template <typename T> __device__ __forceinline__ T widen(__nv_bfloat16 x) {
  return T(__bfloat162float(x));
}

template <int S, typename T, typename TA, typename TB, int TM, int TN, int RM,
          int RN>
__global__ void __launch_bounds__(kThreads)
kahan_matmul_grid(const TA* __restrict__ a, const TB* __restrict__ b,
                  T* __restrict__ s_out, T* __restrict__ c_out, int m, int n,
                  int k, int block_k) {
  constexpr int TX = TN / RN;
  constexpr int TY = TM / RM;
  static_assert(TX * TY == kThreads, "the thread grid must cover the tile");
  // +1: the A staging writes run along k, a column of this array
  __shared__ T a_sh[kTileK][TM + 1];
  __shared__ T b_sh[kTileK][TN];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const long long batch = blockIdx.z;
  a += batch * m * (long long)k;
  b += batch * k * (long long)n;
  s_out += batch * m * (long long)n;
  c_out += batch * m * (long long)n;

  T p[RM][RN], s[RM][RN], c[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) { s[i][j] = T(0); c[i][j] = T(0); }

  const int steps = k / block_k;
  for (int g = 0; g < steps; ++g) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) p[i][j] = T(0);
    const int k_end = (g + 1) * block_k;
    for (int k0 = g * block_k; k0 < k_end; k0 += kTileK) {
      const int kt = min(kTileK, k_end - k0);
      // stage A [TM rows x kt cols] (row-major: threads along k) and
      // B [kt rows x TN cols] (threads along n), widened, zero past M / N
      for (int e = threadIdx.x; e < TM * kTileK; e += kThreads) {
        const int r = e / kTileK, kk = e % kTileK;
        const int row = m0 + r;
        a_sh[kk][r] = (row < m && kk < kt)
                        ? widen<T>(a[(long long)row * k + k0 + kk]) : T(0);
      }
      for (int e = threadIdx.x; e < kTileK * TN; e += kThreads) {
        const int kk = e / TN, col = e % TN;
        b_sh[kk][col] = (n0 + col < n && kk < kt)
                          ? widen<T>(b[(long long)(k0 + kk) * n + n0 + col])
                          : T(0);
      }
      __syncthreads();
      for (int kk = 0; kk < kt; ++kk) {
        T av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a_sh[kk][ty + TY * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = b_sh[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) p[i][j] = p[i][j] + av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) update<S>(s[i][j], c[i][j], p[i][j], g);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty + TY * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tx + TX * j;
      if (col >= n) continue;
      s_out[(long long)row * n + col] = s[i][j];
      c_out[(long long)row * n + col] = c[i][j];
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  void* s;
  void* c;
  int batch, m, n, k, block_k;
  cudaStream_t stream;
};

template <typename T, typename TA, typename TB, int TM, int TN, int RM, int RN>
int launch_tile(int scheme, const Args& x) {
  const dim3 grid((x.n + TN - 1) / TN, (x.m + TM - 1) / TM, x.batch);
  auto ta = static_cast<const TA*>(x.a);
  auto tb = static_cast<const TB*>(x.b);
  auto ts = static_cast<T*>(x.s);
  auto tc = static_cast<T*>(x.c);
#define REPRO_MATMUL_LAUNCH(S)                                              \
  kahan_matmul_grid<S, T, TA, TB, TM, TN, RM, RN>                           \
      <<<grid, kThreads, 0, x.stream>>>(ta, tb, ts, tc, x.m, x.n, x.k,      \
                                        x.block_k)
  switch (scheme) {
    case NAIVE: REPRO_MATMUL_LAUNCH(NAIVE); break;
    case KAHAN: REPRO_MATMUL_LAUNCH(KAHAN); break;
    case PAIRWISE: REPRO_MATMUL_LAUNCH(PAIRWISE); break;
    case DOT2: REPRO_MATMUL_LAUNCH(DOT2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MATMUL_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T, typename TA, typename TB>
int launch_types(int scheme, const Args& x) {
  if (x.m <= 8) return launch_tile<T, TA, TB, 8, 32, 1, 1>(scheme, x);
  return launch_tile<T, TA, TB, 64, 64, 4, 4>(scheme, x);
}

}  // namespace

// C entry point. dtype codes: 0 = float32, 1 = float64, 2 = bfloat16.
// dtype is the compute dtype of s, c and every operation; a_dtype and
// b_dtype are the operands' (float32 or bfloat16 for a float32 compute
// dtype, float64 for float64). a [batch, m, k] and b [batch, k, n] are
// row-major contiguous, k a multiple of block_k. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int kahan_matmul_launch(int scheme, int dtype, int a_dtype,
                                   int b_dtype, const void* a, const void* b,
                                   void* s, void* c, int batch, int m, int n,
                                   int k, int block_k, void* stream) {
  if (batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 1 ||
      block_k < 1 || k % block_k != 0)
    return (int)cudaErrorInvalidValue;
  const Args x{a, b, s, c, batch, m, n, k, block_k,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (a_dtype == 0 && b_dtype == 0) return launch_types<float, float, float>(scheme, x);
    if (a_dtype == 0 && b_dtype == 2) return launch_types<float, float, __nv_bfloat16>(scheme, x);
    if (a_dtype == 2 && b_dtype == 0) return launch_types<float, __nv_bfloat16, float>(scheme, x);
    if (a_dtype == 2 && b_dtype == 2) return launch_types<float, __nv_bfloat16, __nv_bfloat16>(scheme, x);
  } else if (dtype == 1 && a_dtype == 1 && b_dtype == 1) {
    return launch_types<double, double, double>(scheme, x);
  }
  return (int)cudaErrorInvalidValue;
}

// Compensated dot and sum on Hopper: the paper's two kernel bodies.
//
// Replaces the four Pallas calls of the JAX package:
//   kahan_dot_grid  <- repro/kernels/kahan_dot.py  dot_accumulators (:89)
//                      and dot_accumulators_batched (:139), body _dot_kernel
//   kahan_sum_grid  <- repro/kernels/kahan_sum.py  sum_accumulators (:63)
//                      and sum_accumulators_batched (:105), body _sum_kernel
//
// Layout (the reference's, so the (s, c) grids are bitwise equal):
//   the input row of length n (padded by the caller to a multiple of
//   cells = 8 * U * 128) is read as steps = n / cells blocks of
//   [8U, 128]; accumulator cell (r, l) folds element
//   g * cells + r * 128 + l at step g, in order g = 0 .. steps-1.
//   One launch serves the single and the batched call: blockIdx.y is the
//   batch row. Threads across blockIdx.x * blockDim.x own the cells; each
//   thread keeps its (s, c) pair in registers, walks the steps in order
//   and writes its cell of the [B, 8U, 128] s and c grids at the end. No
//   atomics, no cross-block reduction: the two-sum merge of the grid
//   stays in torch (kernels/engine.py), as it stays outside Pallas in the
//   reference.
//
// Arithmetic: built with -fmad=false, so no product is contracted by the
// compiler. __fmaf_rn / __fma_rn sit at exactly the two sites where XLA
// on the CPU contracts the reference: s = fma(a, b, s) in naive and
// pairwise, y = fma(a, b, c) in kahan. dot2's TwoProd uses the Veltkamp
// split with plain ops; the sum kernel has no fma. The scheme is a
// template argument (ids in kernels/schemes.py). T is float, double or
// Bf16: the reference rounds every bfloat16 op separately and contracts
// nothing, which Bf16 reproduces with the conversion intrinsics (each op
// computed in float32, rounded to bfloat16). The schemes' update and
// mul_update live in schemes.cuh, shared with kahan_flash.cu.
//
// What bounds it on the H100: every input byte is read once, so it is
// bandwidth-bound (n * sizeof(T) bytes per stream over 3.35 TB/s). What
// holds it back: bitwise parity fixes the number of independent chains
// at 1024 * U (8192 at the default U = 8), i.e. 64 blocks of 128 threads
// per batch row on 132 SMs, each thread a serial dependent chain. The
// kernel keeps DEPTH steps of loads in flight per thread ahead of the
// chain, which is far too little to cover HBM latency with so few
// threads; deeper pipelining (cp.async / TMA stages) or a different
// port-default U is later work.

#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

constexpr int kThreads = 128;   // one block = one row r of the [8U, 128] grid
constexpr int kDepth = 8;       // steps of loads issued ahead of the chain

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
kahan_dot_grid(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ s_out, T* __restrict__ c_out,
               long long n, int cells) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long row = blockIdx.y;
  const T* ar = a + row * n + cell;
  const T* br = b + row * n + cell;
  const long long steps = n / cells;
  T s = T(0), c = T(0);
  long long g = 0;
  for (; g + kDepth <= steps; g += kDepth) {
    T av[kDepth], bv[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      av[k] = ar[(g + k) * cells];
      bv[k] = br[(g + k) * cells];
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) mul_update<S>(s, c, av[k], bv[k], g + k);
  }
  for (; g < steps; ++g) mul_update<S>(s, c, ar[g * cells], br[g * cells], g);
  s_out[row * cells + cell] = s;
  c_out[row * cells + cell] = c;
}

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
kahan_sum_grid(const T* __restrict__ x, T* __restrict__ s_out,
               T* __restrict__ c_out, long long n, int cells) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long row = blockIdx.y;
  const T* xr = x + row * n + cell;
  const long long steps = n / cells;
  T s = T(0), c = T(0);
  long long g = 0;
  for (; g + kDepth <= steps; g += kDepth) {
    T xv[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) xv[k] = xr[(g + k) * cells];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) update<S>(s, c, xv[k], g + k);
  }
  for (; g < steps; ++g) update<S>(s, c, xr[g * cells], g);
  s_out[row * cells + cell] = s;
  c_out[row * cells + cell] = c;
}

dim3 grid_for(long long batch, int cells) {
  return dim3((cells + kThreads - 1) / kThreads, (unsigned)batch);
}

template <typename T>
int dot_dispatch(int scheme, const void* a, const void* b, void* s, void* c,
                 long long batch, long long n, int cells, cudaStream_t st) {
  const dim3 grid = grid_for(batch, cells);
  auto ta = static_cast<const T*>(a);
  auto tb = static_cast<const T*>(b);
  auto ts = static_cast<T*>(s);
  auto tc = static_cast<T*>(c);
  switch (scheme) {
    case NAIVE: kahan_dot_grid<NAIVE, T><<<grid, kThreads, 0, st>>>(ta, tb, ts, tc, n, cells); break;
    case KAHAN: kahan_dot_grid<KAHAN, T><<<grid, kThreads, 0, st>>>(ta, tb, ts, tc, n, cells); break;
    case PAIRWISE: kahan_dot_grid<PAIRWISE, T><<<grid, kThreads, 0, st>>>(ta, tb, ts, tc, n, cells); break;
    case DOT2: kahan_dot_grid<DOT2, T><<<grid, kThreads, 0, st>>>(ta, tb, ts, tc, n, cells); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int sum_dispatch(int scheme, const void* x, void* s, void* c,
                 long long batch, long long n, int cells, cudaStream_t st) {
  const dim3 grid = grid_for(batch, cells);
  auto tx = static_cast<const T*>(x);
  auto ts = static_cast<T*>(s);
  auto tc = static_cast<T*>(c);
  switch (scheme) {
    case NAIVE: kahan_sum_grid<NAIVE, T><<<grid, kThreads, 0, st>>>(tx, ts, tc, n, cells); break;
    case KAHAN: kahan_sum_grid<KAHAN, T><<<grid, kThreads, 0, st>>>(tx, ts, tc, n, cells); break;
    case PAIRWISE: kahan_sum_grid<PAIRWISE, T><<<grid, kThreads, 0, st>>>(tx, ts, tc, n, cells); break;
    case DOT2: kahan_sum_grid<DOT2, T><<<grid, kThreads, 0, st>>>(tx, ts, tc, n, cells); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = float64, 2 = bfloat16. Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int kahan_dot_launch(int scheme, int dtype, const void* a,
                                const void* b, void* s, void* c,
                                long long batch, long long n, int cells,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dot_dispatch<float>(scheme, a, b, s, c, batch, n, cells, st);
  if (dtype == 1) return dot_dispatch<double>(scheme, a, b, s, c, batch, n, cells, st);
  if (dtype == 2) return dot_dispatch<Bf16>(scheme, a, b, s, c, batch, n, cells, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int kahan_sum_launch(int scheme, int dtype, const void* x, void* s,
                                void* c, long long batch, long long n,
                                int cells, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return sum_dispatch<float>(scheme, x, s, c, batch, n, cells, st);
  if (dtype == 1) return sum_dispatch<double>(scheme, x, s, c, batch, n, cells, st);
  if (dtype == 2) return sum_dispatch<Bf16>(scheme, x, s, c, batch, n, cells, st);
  return (int)cudaErrorInvalidValue;
}

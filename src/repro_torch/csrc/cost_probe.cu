// Probes of the compensation schemes' device updates, for the cost
// auditor's SASS level (repro_torch/analysis/costmodel.py, --cost --sass).
//
// The counterpart of the reference's jitted scheme body
// (repro/analysis/costmodel.py:322): one small kernel per (scheme, dtype,
// path) that loads one element (two on the dot path) and the accumulator
// pair, applies update<S> / mul_update<S> of schemes.cuh -- the very
// functions the shipping kernels inline -- and stores (s, c). Built by
// kernels/_build.py with the kernels' own NVCC_FLAGS (sm_90a, -fmad=false,
// -ftz=true), disassembled with cuobjdump, and its FADD/FMUL/FFMA
// (DADD/DMUL/DFMA) counts held against the scheme's declared mix. The
// step g is a kernel argument, so pairwise's conditional fold stays in the
// code. Not a kernel of any path: nothing launches these.

#include "schemes.cuh"

using repro_schemes::Bf16;
using repro_schemes::mul_update;
using repro_schemes::update;

template <int S, typename T>
__device__ __forceinline__ void dot_probe(const T* a, const T* b, T* s, T* c,
                                          long long g) {
  T sv = s[0], cv = c[0];
  mul_update<S, T>(sv, cv, a[0], b[0], g);
  s[0] = sv;
  c[0] = cv;
}

template <int S, typename T>
__device__ __forceinline__ void sum_probe(const T* x, T* s, T* c,
                                          long long g) {
  T sv = s[0], cv = c[0];
  update<S, T>(sv, cv, x[0], g);
  s[0] = sv;
  c[0] = cv;
}

#define PROBE(SID, NAME, T, TN)                                              \
  extern "C" __global__ void probe_dot_##NAME##_##TN(                        \
      const T* a, const T* b, T* s, T* c, long long g) {                     \
    dot_probe<SID, T>(a, b, s, c, g);                                        \
  }                                                                          \
  extern "C" __global__ void probe_sum_##NAME##_##TN(                        \
      const T* x, T* s, T* c, long long g) {                                 \
    sum_probe<SID, T>(x, s, c, g);                                           \
  }

#define PROBES(SID, NAME)      \
  PROBE(SID, NAME, float, f32) \
  PROBE(SID, NAME, double, f64) \
  PROBE(SID, NAME, Bf16, bf16)

PROBES(repro_schemes::NAIVE, naive)
PROBES(repro_schemes::KAHAN, kahan)
PROBES(repro_schemes::PAIRWISE, pairwise)
PROBES(repro_schemes::DOT2, dot2)

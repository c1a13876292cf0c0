// Device update functions of the four built-in compensation schemes,
// shared by kahan_reduce.cu (dot and sum grids) and kahan_flash.cu (the
// online-softmax accumulators).
//
// Each function is one scheme's accumulator fold, op for op as the torch
// callables in repro_torch/kernels/schemes.py (and the reference's in
// repro/kernels/schemes.py): update folds an already-formed term x (no
// product, so no contraction can touch it whatever -fmad says);
// mul_update folds the product a * b, with __fmaf_rn / __fma_rn at
// exactly the sites where XLA on the CPU contracts the reference (see
// kahan_reduce.cu, which is built with -fmad=false). The scheme id is a
// template argument: the ids are the device_id values of schemes.py.
// T is float, double or Bf16 (bfloat16 storage, every op computed in
// float32 and rounded to bfloat16, as XLA and torch on the CPU do).

#pragma once

#include <cuda_bf16.h>

namespace repro_schemes {

enum Scheme { NAIVE = 0, KAHAN = 1, PAIRWISE = 2, DOT2 = 3 };
constexpr long long kPairwiseFold = 32;

struct Bf16 {
  __nv_bfloat16 v;
  Bf16() = default;
  __device__ explicit Bf16(float f) : v(__float2bfloat16_rn(f)) {}
  __device__ float f() const { return __bfloat162float(v); }
};
__device__ __forceinline__ Bf16 operator+(Bf16 a, Bf16 b) { return Bf16(a.f() + b.f()); }
__device__ __forceinline__ Bf16 operator-(Bf16 a, Bf16 b) { return Bf16(a.f() - b.f()); }
__device__ __forceinline__ Bf16 operator*(Bf16 a, Bf16 b) { return Bf16(a.f() * b.f()); }
__device__ __forceinline__ Bf16 operator-(Bf16 a) { Bf16 r; r.v = __hneg(a.v); return r; }
static_assert(sizeof(Bf16) == 2, "Bf16 must be 2 bytes");

__device__ __forceinline__ float fused(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fused(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ Bf16 fused(Bf16 a, Bf16 b, Bf16 c) {
  return a * b + c;   // not contracted in bfloat16
}

template <typename T> struct Split;
template <> struct Split<float> { static constexpr float value = 4097.0f; };
template <> struct Split<double> { static constexpr double value = 134217729.0; };
template <> struct Split<Bf16> { static constexpr float value = 4097.0f; };

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bp = s - a;
  const T ap = s - bp;
  e = (a - ap) + (b - bp);
}

template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  const T k = T(Split<T>::value);
  p = a * b;
  const T a_big = k * a;
  const T a_hi = a_big - (a_big - a);
  const T a_lo = a - a_hi;
  const T b_big = k * b;
  const T b_hi = b_big - (b_big - b);
  const T b_lo = b - b_hi;
  // XLA contracts each product of the error term into the add it feeds:
  // exact products in the normal range, so this only shows where they
  // underflow (and fused() is two roundings in bfloat16, as there)
  e = fused(a_lo, b_lo, fused(a_lo, b_hi, fused(a_hi, b_lo,
                                                fused(a_hi, b_hi, -p))));
}

// scheme.update: fold an already-formed term x.
template <int S, typename T>
__device__ __forceinline__ void update(T& s, T& c, T x, long long g) {
  if constexpr (S == NAIVE) {
    s = s + x;
  } else if constexpr (S == KAHAN) {
    const T y = x + c;
    const T t = s + y;
    c = y - (t - s);
    s = t;
  } else if constexpr (S == PAIRWISE) {
    s = s + x;
    if (g % kPairwiseFold == kPairwiseFold - 1) { c = c + s; s = T(0); }
  } else {
    T t, e;
    two_sum(s, x, t, e);
    s = t;
    c = c + e;
  }
}

// scheme.mul_update: fold the product a * b (dot path).
template <int S, typename T>
__device__ __forceinline__ void mul_update(T& s, T& c, T a, T b, long long g) {
  if constexpr (S == NAIVE) {
    s = fused(a, b, s);
  } else if constexpr (S == KAHAN) {
    const T y = fused(a, b, c);
    const T t = s + y;
    c = y - (t - s);
    s = t;
  } else if constexpr (S == PAIRWISE) {
    s = fused(a, b, s);
    if (g % kPairwiseFold == kPairwiseFold - 1) { c = c + s; s = T(0); }
  } else {
    T p, ep, t, es;
    two_prod(a, b, p, ep);
    two_sum(s, p, t, es);
    s = t;
    c = c + (ep + es);
  }
}

}  // namespace repro_schemes

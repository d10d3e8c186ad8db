// The Boys function F_0..F_M(T) in FP64 on the device, shared by both parts
// of kernel 1 (csrc/eri_tile.cu, csrc/eri_tile_highl.cu), kernel 3
// (csrc/eri_tile_values.cu) and the probe that holds it against
// ops/boys.py::boys (eri_boys in eri_tile.cu).
//
// The three branches of ops/boys.py::boys, with one division (1/T) and none
// inside a loop: the Kummer series is one Horner polynomial whose
// coefficients prod_k 1/(2m+2k+1) are compile-time constants, and the
// downward and upward recursions multiply by compile-time reciprocals
// (tests/test_torch_integrals.py holds the same arithmetic on the CPU
// against ops/boys.py::boys). Orders up to 12 (f-shell quartets).
//
// kRsqrt (kernel 3) takes sqrt(T) and 1/T in the closed form from one
// reciprocal square root, in place of a division and two square roots:
// fewer FP64 instructions, other roundings. Kernel 1 keeps the division, so
// that its values, and the SCF runs and anchors built on them, keep their
// bits.

#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace qchem_eri {

constexpr double kPi = 3.141592653589793238462643383279502884;
constexpr double kHalfSqrtPi = 0.886226925452758013649083741671;  // sqrt(pi) / 2
constexpr int kMaxBoys = 12;  // highest order: L = 12, (ff|ff)

template <int K>
struct RcpOdd {  // 1 / (2K + 1)
  static constexpr double v = 1.0 / (2 * K + 1);
};

template <int M, int I>
struct KummerCoef {  // prod_{k=0..I} 1 / (2M + 2k + 1)
  static constexpr double v = KummerCoef<M, I - 1>::v * RcpOdd<M + I>::v;
};
template <int M>
struct KummerCoef<M, 0> {
  static constexpr double v = RcpOdd<M>::v;
};

template <int M>
constexpr int kSeriesTerms = 2 * M + 40;  // ops/boys.py::series_terms

// sum_{i=0..N} c_i x^i by Horner, highest coefficient first
template <int M, int N, int... I>
__device__ __forceinline__ double kummer(double x, std::integer_sequence<int, I...>) {
  double acc = KummerCoef<M, N>::v;
  ((acc = fma(acc, x, KummerCoef<M, N - 1 - I>::v)), ...);
  return acc;
}

template <int... I>
__device__ __forceinline__ void boys_down(double x, double eT, double* F,
                                          std::integer_sequence<int, I...>) {
  // m = M - I: F_{m-1} = (2T F_m + e^-T) / (2m - 1)
  constexpr int M = sizeof...(I);
  ((F[M - I - 1] = fma(x, F[M - I], eT) * RcpOdd<M - I - 1>::v), ...);
}

// F_0..F_M(T) into F[0..M]
template <int M, bool kRsqrt = false>
__device__ __forceinline__ void boys(double T, double* F) {
  static_assert(M >= 0 && M <= kMaxBoys, "Boys orders 0..12");
  if (T < 0.01 && M == 0) {
    // F_0(T) = sum_k (-T)^k / (k! (2k+1)), 7 terms
    double f = 1.0 / 9360.0;
    f = fma(-T, f, 1.0 / 1320.0);
    f = fma(-T, f, 1.0 / 216.0);
    f = fma(-T, f, 1.0 / 42.0);
    f = fma(-T, f, 1.0 / 10.0);
    f = fma(-T, f, 1.0 / 3.0);
    F[0] = fma(-T, f, 1.0);
    return;
  }
  if (M == 0 || T > M + 1.5) {
    double invT;
    if constexpr (kRsqrt) {  // T >= 0.01 here
      const double rT = rsqrt(T);
      invT = rT * rT;
      F[0] = kHalfSqrtPi * rT * erf(T * rT);
    } else {
      invT = 1.0 / T;
      F[0] = 0.5 * sqrt(kPi * invT) * erf(sqrt(T));
    }
    if (M > 0) {
      // upward recursion from the closed form, contracting for T > m + 1/2
      const double eT = exp(-T);
      const double inv2T = 0.5 * invT;
#pragma unroll
      for (int m = 0; m < M; ++m) F[m + 1] = fma(static_cast<double>(2 * m + 1), F[m], -eT) * inv2T;
    }
    return;
  }
  // Kummer series at M, then exact downward recursion
  const double eT = exp(-T);
  const double x = 2.0 * T;
  F[M] = eT * kummer<M, kSeriesTerms<M>>(x, std::make_integer_sequence<int, kSeriesTerms<M>>{});
  boys_down(x, eT, F, std::make_integer_sequence<int, M>{});
}

}  // namespace qchem_eri

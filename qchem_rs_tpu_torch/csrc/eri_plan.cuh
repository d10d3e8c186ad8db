// The compile-time plan of the ERI tile kernels (csrc/eri_tile.cu, kernel 1's
// template part, and csrc/eri_tile_values.cu, kernel 3's; kernel 3's high-L
// part, csrc/eri_tile_values_highl.cu, takes nherm and nth_set_bit): Hermite index
// arithmetic, the downward R recursion of mcmurchie._r_plan unrolled through
// integer sequences into constant indices, the (s1, s2) gather of
// eri._r2_gather with its signs, the R of one primitive quartet, and the bra
// Hermite->Cartesian contraction against one R table; and nth_set_bit,
// with which both parts of kernel 3 list a block's ket points.

#pragma once

#include <cuda_runtime.h>

#include <utility>

#include "boys.cuh"

namespace qchem_eri {

#define HD __host__ __device__

HD constexpr int ntri(int n) { return (n + 1) * (n + 2) / 2; }
HD constexpr int nherm(int L) { return (L + 1) * (L + 2) * (L + 3) / 6; }
HD constexpr int imin(int x, int y) { return x < y ? x : y; }
HD constexpr int imax(int x, int y) { return x > y ? x : y; }

// largest ncart(la) * ncart(lb) over la + lb = L
HD constexpr int max_pair_comps(int L) {
  int m = 0;
  for (int lb = 0; 2 * lb <= L; ++lb) m = imax(m, ntri(L - lb) * ntri(lb));
  return m;
}

// position of (t, u, v) in hermite_components(L): t outer, then u, then v
HD constexpr int hidx(int L, int t, int u, int v) {
  int s = 0;
  for (int k = 0; k < t; ++k) s += ntri(L - k);
  for (int k = 0; k < u; ++k) s += L - t - k + 1;
  return s + v;
}

struct Tuv {
  int t, u, v;
};

HD constexpr Tuv tuv_of(int L, int s) {
  int t = 0;
  while (s >= ntri(L - t)) {
    s -= ntri(L - t);
    ++t;
  }
  int u = 0;
  while (s >= L - t - u + 1) {
    s -= L - t - u + 1;
    ++u;
  }
  return Tuv{t, u, s};
}

// one step of the downward R recursion for entry s > 0 (mcmurchie._r_plan):
// R_s = PC_d R_{s - e_d} + c R_{s - 2 e_d}, d the first nonzero dimension
struct Step {
  int d, i1, i2, c, ord;
};

HD constexpr Step step_of(int L, int s) {
  const Tuv e = tuv_of(L, s);
  const int ord = e.t + e.u + e.v;
  if (e.t >= 1)
    return Step{0, hidx(L, e.t - 1, e.u, e.v), e.t >= 2 ? hidx(L, e.t - 2, e.u, e.v) : 0,
                e.t - 1, ord};
  if (e.u >= 1)
    return Step{1, hidx(L, e.t, e.u - 1, e.v), e.u >= 2 ? hidx(L, e.t, e.u - 2, e.v) : 0,
                e.u - 1, ord};
  return Step{2, hidx(L, e.t, e.u, e.v - 1), e.v >= 2 ? hidx(L, e.t, e.u, e.v - 2) : 0, e.v - 1,
              ord};
}

// R index of the (s1, s2) gather (eri._r2_gather)
HD constexpr int gather_of(int LB, int LK, int s1, int s2) {
  const Tuv b = tuv_of(LB, s1);
  const Tuv k = tuv_of(LK, s2);
  return hidx(LB + LK, b.t + k.t, b.u + k.u, b.v + k.v);
}

HD constexpr bool odd_sign(int LK, int s2) {
  const Tuv k = tuv_of(LK, s2);
  return ((k.t + k.u + k.v) & 1) != 0;
}

template <int LK, int S2>
struct OddSign {  // sign[s2] of the gather is -1
  static constexpr bool v = odd_sign(LK, S2);
};

// position of the r-th (from 0) set bit of m, which has more than r
__device__ __forceinline__ int nth_set_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w /= 2) {
    const unsigned low = m & ((1u << w) - 1u);
    const int n = __popc(low);
    if (r >= n) {
      r -= n;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// ---------------------------------------------------------------- R table

template <int H, bool SMEM, int NT>
struct RTab;

template <int H, int NT>
struct RTab<H, false, NT> {  // registers
  double v[H];
  __device__ explicit RTab(double*) {}
  template <int S>
  __device__ __forceinline__ double& at() { return v[S]; }
};

template <int H, int NT>
struct RTab<H, true, NT> {  // the thread's column of a (H, NT) shared array
  double* p;
  __device__ explicit RTab(double* base) : p(base) {}
  template <int S>
  __device__ __forceinline__ double& at() { return p[S * NT]; }
};

template <int L, int S, class RT>
__device__ __forceinline__ void r_step(RT& R, const double (&pc)[3], int maxo) {
  constexpr Step st = step_of(L, S);
  if (st.ord <= maxo) {
    if constexpr (st.c == 0) {
      R.template at<S>() = pc[st.d] * R.template at<st.i1>();
    } else {
      R.template at<S>() = fma(pc[st.d], R.template at<st.i1>(),
                               static_cast<double>(st.c) * R.template at<st.i2>());
    }
  }
}

// one level of the recursion: entries H-1 down to 1 (each reads only lower
// entries, which still hold the level above)
template <int L, class RT, int... I>
__device__ __forceinline__ void r_level(RT& R, const double (&pc)[3], int maxo,
                                        std::integer_sequence<int, I...>) {
  (r_step<L, nherm(L) - 1 - I>(R, pc, maxo), ...);
}

// ------------------------------------------------------- bra contraction

// acc[j][s2] += e * R[idx(s1, s2)] over s2, for one (alpha chunk entry j, s1)
template <int LB, int LK, int S1V, class RT, int... S2V>
__device__ __forceinline__ void contract_alpha(double (&acc)[nherm(LK)], double e, RT& R,
                                               std::integer_sequence<int, S2V...>) {
  ((acc[S2V] = fma(e, R.template at<gather_of(LB, LK, S1V, S2V)>(), acc[S2V])), ...);
}

template <int LB, int LK, int AC, int S1V, class RT>
__device__ __forceinline__ void contract_row(double (&acc)[AC][nherm(LK)], const double* eb,
                                             int alpha0, int A, RT& R) {
  constexpr int S1 = nherm(LB);
#pragma unroll
  for (int j = 0; j < AC; ++j) {
    const double e = alpha0 + j < A ? __ldg(eb + (alpha0 + j) * S1 + S1V) : 0.0;
    contract_alpha<LB, LK, S1V>(acc[j], e, R, std::make_integer_sequence<int, nherm(LK)>{});
  }
}

template <int LB, int LK, int AC, class RT, int... S1V>
__device__ __forceinline__ void contract(double (&acc)[AC][nherm(LK)], const double* eb,
                                         int alpha0, int A, RT& R,
                                         std::integer_sequence<int, S1V...>) {
  (contract_row<LB, LK, AC, S1V>(acc, eb, alpha0, A, R), ...);
}

// ------------------------------------------------------ one quartet's R

// R_tuv(alpha, P - Q) of the primitive quartet of bra pair (p, P) and ket
// pair (q, Q), times pref = 2 pi^{5/2} / (p q sqrt(p + q)): Boys F_0..F_L
// times pref (-2 alpha)^n (R is linear in them, so pref rides along), then
// the downward recursion, level by level. kRsqrt (kernel 3) takes pref and
// alpha from two reciprocal square roots and Boys's closed form from one
// (boys.cuh), in place of two divisions and four square roots.
template <int L, bool kRsqrt = false, class RT>
__device__ __forceinline__ void quartet_r(RT& R, double p, double Px, double Py, double Pz,
                                          double q, double Qx, double Qy, double Qz) {
  const double ps = p + q;
  const double pq = p * q;
  double al, w;
  if constexpr (kRsqrt) {
    const double rq = rsqrt(pq * ps);  // (pq (p + q))^{-1/2}
    al = pq * pq * (rq * rq);          // pq / (p + q)
    w = 4.0 * kPi * kPi * kHalfSqrtPi * rq * rsqrt(pq);
  } else {
    const double inv = 1.0 / (pq * ps);
    al = pq * pq * inv;
    w = 2.0 * kPi * kPi * sqrt(kPi) * (ps * inv) * sqrt(pq * inv);
  }
  const double pc[3] = {Px - Qx, Py - Qy, Pz - Qz};
  double F[L + 1];
  boys<L, kRsqrt>(al * (pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]), F);
#pragma unroll
  for (int n = 0; n <= L; ++n) {
    F[n] *= w;
    w *= -2.0 * al;
  }
  R.template at<0>() = F[L];
#pragma unroll
  for (int n = L - 1; n >= 0; --n) {
    r_level<L>(R, pc, L - n, std::make_integer_sequence<int, nherm(L) - 1>{});
    R.template at<0>() = F[n];
  }
}

}  // namespace qchem_eri

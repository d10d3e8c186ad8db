// Kernel 1: bra-contracted ERI tiles for one class pair, in FP64.
//
// Replaces the three Pallas kernels of qchem_rs_tpu/ops/eri_pallas.py
// (_kernel_fused_e1, _kernel_fused, _kernel_htab), which computed the same
// chain in (hi, lo)-f32 arithmetic and split it three ways around VMEM and
// Mosaic's unroll limits. Here one kernel with the angular momenta given at
// run time serves every class pair with L = Lb + Lk <= 8.
//
// For tile k (bra pairs ti[k]..ti[k]+T1-1, ket pairs tj[k]..tj[k]+T2-1):
//
//   out[k, alpha, ic*S2+s2, t1, t2] =
//       sum_{ia, s1} E1[ti+t1, ia, alpha, s1] * sign[s2] * pref * R[idx[s1,s2]]
//
// with R the Hermite Coulomb table R_tuv(alpha_q, P - Q) of the primitive
// quartet (bra primitive pair ia, ket primitive pair ic), built from Boys
// F_0..F_L by the downward recursion of mcmurchie._r_plan, and
// pref = 2 pi^{5/2} / (p q sqrt(p + q)).
//
// Bound by FP64 arithmetic and per-thread state. One thread owns one
// (tile, t1, t2, ic) point and loops over ia. The R table (up to 165
// doubles) lives in thread-local memory, updated in place level by level
// (entry s reads only entries of lower index, so a descending sweep needs no
// second buffer). The A*S2 sums accumulate directly in the output, which
// each thread owns exclusively. Consecutive threads differ in t2, so output
// stores coalesce and E1/plan reads are uniform across a warp.
//
// C interface (bound with ctypes): eri_bra_tiles(...) launches on `stream`
// and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 8;
constexpr int kMaxH = (kMaxL + 1) * (kMaxL + 2) * (kMaxL + 3) / 6;  // 165
constexpr double kPi = 3.141592653589793238462643383279502884;
constexpr int kThreads = 128;

// F_0..F_mmax(T): the three branches of qchem_rs_tpu/ops/boys.py::boys.
__device__ void boys(int mmax, double T, double* F) {
  if (mmax == 0) {
    if (T < 0.01) {
      // F_0(T) = sum_k (-T)^k / (k! (2k+1)), 7 terms
      const double c[7] = {1.0, 1.0 / 3.0, 1.0 / 10.0, 1.0 / 42.0,
                           1.0 / 216.0, 1.0 / 1320.0, 1.0 / 9360.0};
      double f = c[6];
      for (int k = 5; k >= 0; --k) f = c[k] - T * f;
      F[0] = f;
    } else {
      F[0] = 0.5 * sqrt(kPi / T) * erf(sqrt(T));
    }
    return;
  }
  const double eT = exp(-T);
  if (T > mmax + 1.5) {
    // upward recursion from the closed form, contracting for T > m + 1/2
    F[0] = 0.5 * sqrt(kPi / T) * erf(sqrt(T));
    const double inv2T = 0.5 / T;
    for (int m = 0; m < mmax; ++m) F[m + 1] = ((2 * m + 1) * F[m] - eT) * inv2T;
  } else {
    // Kummer series at mmax, then exact downward recursion
    double term = 1.0 / (2 * mmax + 1);
    double sum = term;
    const int nterms = 2 * mmax + 40;
    for (int i = 0; i < nterms; ++i) {
      term *= 2.0 * T / (2 * mmax + 2 * i + 3);
      sum += term;
    }
    F[mmax] = eT * sum;
    for (int m = mmax; m > 0; --m) F[m - 1] = (2.0 * T * F[m] + eT) / (2 * m - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
eri_bra_tiles_kernel(int Lb, int Lk, int a, int c, int A, int S1, int S2, int T1, int T2,
                     long long total, const double* __restrict__ E1,
                     const double* __restrict__ p1, const double* __restrict__ P1,
                     const double* __restrict__ p2, const double* __restrict__ P2,
                     const int* __restrict__ ti, const int* __restrict__ tj,
                     const int* __restrict__ rplan, const int* __restrict__ r2plan,
                     double* __restrict__ out) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int t2 = static_cast<int>(gid % T2);
  long long rest = gid / T2;
  const int t1 = static_cast<int>(rest % T1);
  rest /= T1;
  const int ic = static_cast<int>(rest % c);
  const long long tile = rest / c;

  const int L = Lb + Lk;
  const int H = (L + 1) * (L + 2) * (L + 3) / 6;
  const int* rd = rplan;           // PC dimension of each entry's step
  const int* ri1 = rplan + H;      // index of s - e_d
  const int* ri2 = rplan + 2 * H;  // index of s - 2 e_d
  const int* rc = rplan + 3 * H;   // coefficient s_d - 1
  const int* ro = rplan + 4 * H;   // total order t + u + v
  const int* idx = r2plan;         // (S1, S2)
  const int* sgn = r2plan + S1 * S2;

  const int row = ti[tile] + t1;
  const int col = tj[tile] + t2;
  const double q = p2[static_cast<size_t>(col) * c + ic];
  const double* Q = P2 + (static_cast<size_t>(col) * c + ic) * 3;
  const double Qx = Q[0], Qy = Q[1], Qz = Q[2];

  const size_t plane = static_cast<size_t>(T1) * T2;
  const size_t cS2 = static_cast<size_t>(c) * S2;
  double* o = out + (static_cast<size_t>(tile) * A * cS2 + static_cast<size_t>(ic) * S2) * plane +
              static_cast<size_t>(t1) * T2 + t2;

  double R[kMaxH];
  double F[kMaxL + 1];
  for (int ia = 0; ia < a; ++ia) {
    const size_t bp = static_cast<size_t>(row) * a + ia;
    const double p = p1[bp];
    const double ps = p + q;
    const double pq = p * q;
    const double al = pq / ps;
    const double PQ[3] = {P1[bp * 3] - Qx, P1[bp * 3 + 1] - Qy, P1[bp * 3 + 2] - Qz};
    boys(L, al * (PQ[0] * PQ[0] + PQ[1] * PQ[1] + PQ[2] * PQ[2]), F);
    // base[n] = (-2 alpha)^n F_n
    double pw = 1.0;
    for (int n = 0; n <= L; ++n) {
      F[n] *= pw;
      pw *= -2.0 * al;
    }
    R[0] = F[L];
    for (int n = L - 1; n >= 0; --n) {
      const int maxo = L - n;
      for (int s = H - 1; s >= 1; --s) {
        if (ro[s] > maxo) continue;
        R[s] = PQ[rd[s]] * R[ri1[s]] + rc[s] * R[ri2[s]];
      }
      R[0] = F[n];
    }
    const double pref = 2.0 * kPi * kPi * sqrt(kPi) / (pq * sqrt(ps));
    const double* e = E1 + bp * A * S1;
    for (int al_ = 0; al_ < A; ++al_) {
      const double* ea = e + al_ * S1;
      double* oa = o + static_cast<size_t>(al_) * cS2 * plane;
      for (int s2 = 0; s2 < S2; ++s2) {
        double acc = 0.0;
        for (int s1 = 0; s1 < S1; ++s1) acc = fma(ea[s1], R[idx[s1 * S2 + s2]], acc);
        const double v = sgn[s2] * pref * acc;
        double* dst = oa + static_cast<size_t>(s2) * plane;
        *dst = (ia == 0) ? v : *dst + v;
      }
    }
  }
}

}  // namespace

extern "C" int eri_bra_tiles(int Lb, int Lk, int a, int c, int A, int S1, int S2, int T1, int T2,
                             int ntiles, const void* E1, const void* p1, const void* P1,
                             const void* p2, const void* P2, const void* ti, const void* tj,
                             const void* rplan, const void* r2plan, void* out, void* stream) {
  if (Lb < 0 || Lk < 0 || Lb + Lk > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(ntiles) * c * T1 * T2;
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + kThreads - 1) / kThreads;
  eri_bra_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      Lb, Lk, a, c, A, S1, S2, T1, T2, total, static_cast<const double*>(E1),
      static_cast<const double*>(p1), static_cast<const double*>(P1),
      static_cast<const double*>(p2), static_cast<const double*>(P2),
      static_cast<const int*>(ti), static_cast<const int*>(tj),
      static_cast<const int*>(rplan), static_cast<const int*>(r2plan),
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Kernel 1, high-L part: bra-contracted ERI tiles in FP64 for the pair
// classes that csrc/eri_tile.cu is not instantiated for: LB or LK of 5 or 6
// (f-shell pairs such as (fd| and (ff|), L = LB + LK <= 12.
//
// Replaces, for these classes, the Pallas kernels of
// qchem_rs_tpu/ops/eri_pallas.py (_kernel_fused_e1 :205, _kernel_fused
// :175) where L <= 8, and the XLA f64 path that the JAX package takes for
// L > 8 (qchem_rs_tpu/ops/eri_tiled.py:638-643).
//
// The function, its arguments and its output layout are those of
// eri_tile.cu: for tile k (bra pairs ti[k]..ti[k]+T1-1, ket pairs
// tj[k]..tj[k]+T2-1)
//
//   out[k, alpha, ic*S2+s2, t1, t2] =
//       sum_{ia < n1[row], s1} E1[row, ia, alpha, s1] * sign[s2] * pref * R[idx(s1,s2)]
//
// for ket primitive pairs ic < n2[col] of pair col = tj[k]+t2, and 0.0 for
// the others; only real primitive quartets are computed (the counts of
// ops/eri_kernel.py::compact_prims and prim_counts).
//
// Design. Fully unrolled instantiations per (LB, LK) past (4, 4) took ptxas
// and NVVM minutes each and spilled (H = 455 Hermite entries at L = 12, S1
// and S2 up to 84, A up to 100), so this part gives L at run time:
// - The recursion plan (one packed int per Hermite entry) and the (s1, s2)
//   gather with its signs are small device tables built by the caller
//   (ops/eri_kernel.py::highl_plan), read uniformly across a warp.
// - R (up to 455 doubles) lives in the thread's own local memory and is
//   swept in place level by level: entry s reads only entries of lower
//   index, so a descending sweep needs no second buffer.
// - One thread owns one (tile, chunk, t1, ket point). A chunk is kAC
//   Cartesian components alpha by kSC Hermite components s2; its kAC*kSC
//   sums stay in registers over the whole bra loop and are stored once.
//   Classes with more components take more chunks, each recomputing R, so
//   a thread never holds S2 * A sums.
// - Threads of a warp share (tile, chunk, t1), so the bra loop bound and
//   every bra and plan load are uniform across the warp; consecutive
//   threads take consecutive ket points, so the stores coalesce.
//
// What bounds it on the H100: FP64 arithmetic and the local-memory traffic
// of the R sweep, recomputed per chunk; this part is simple and right
// first. Its classes hold a small share of a build's work (one f shell on
// each transition-metal atom of 6-31G*).
//
// C interface (bound with ctypes): eri_bra_tiles_highl(...) launches on
// `stream` and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "boys.cuh"

namespace qchem_eri_highl {

using qchem_eri::boys;
using qchem_eri::kPi;

constexpr int kMaxSide = 6;  // LB, LK <= 6: pair classes up to (f, f)
constexpr int kMaxL = 2 * kMaxSide;
constexpr int kMaxH = (kMaxL + 1) * (kMaxL + 2) * (kMaxL + 3) / 6;  // 455
constexpr int kThreads = 128;
constexpr int kAC = 4;   // Cartesian components alpha of a chunk
constexpr int kSC = 12;  // Hermite components s2 of a chunk

static_assert(kMaxL <= qchem_eri::kMaxBoys, "the Boys function must reach order L");

int nherm(int L) { return (L + 1) * (L + 2) * (L + 3) / 6; }

struct Args {
  const double* E1;   // (N1, a, A, S1)
  const double* p1;   // (N1, a)
  const double* P1;   // (N1, a, 3)
  const double* p2;   // (N2, c)
  const double* P2;   // (N2, c, 3)
  const int* ti;      // (nt,) bra tile offsets
  const int* tj;      // (nt,) ket tile offsets
  const int* n1;      // (N1,) real bra primitive pairs
  const int* korder;  // (N2 / T2, c*T2) ket points ic*T2 + t2, real first
  const int* knreal;  // (N2 / T2,) real ket points per tile block
  // recursion steps of entries 0..H-1, one packed int each: bits 0-1 the
  // dimension d, 2-5 the coefficient c, 6-9 the order t+u+v, 10-18 the
  // index of s - e_d, 19-27 the index of s - 2 e_d
  const int* steps;
  const int* gather;  // (S1, S2) R index of (s1, s2)
  const int* odd;     // (S2,) 1 where sign[s2] is -1
  double* out;        // (nt, A, c*S2, T1, T2)
  int L, H, S1, S2, a, c, A, T1, T2, nsc, nch;
  long long total;    // nt * nch * T1 * c * T2 threads
};

// F_0..F_L(T) for L in 5..12 (the only orders of this part)
__device__ __forceinline__ void boys_l(int L, double T, double* F) {
  switch (L) {
    case 5: boys<5>(T, F); break;
    case 6: boys<6>(T, F); break;
    case 7: boys<7>(T, F); break;
    case 8: boys<8>(T, F); break;
    case 9: boys<9>(T, F); break;
    case 10: boys<10>(T, F); break;
    case 11: boys<11>(T, F); break;
    case 12: boys<12>(T, F); break;
  }
}

__global__ void __launch_bounds__(kThreads) eri_bra_tiles_highl_kernel(const Args g) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= g.total) return;
  const int KP = g.c * g.T2;
  const int kp = static_cast<int>(gid % KP);
  long long rest = gid / KP;
  const int t1 = static_cast<int>(rest % g.T1);
  rest /= g.T1;
  const int ch = static_cast<int>(rest % g.nch);
  const long long tile = rest / g.nch;
  const int alpha0 = (ch / g.nsc) * kAC;
  const int s20 = (ch % g.nsc) * kSC;

  const int kb = g.tj[tile] / g.T2;
  const int code = g.korder[static_cast<size_t>(kb) * KP + kp];
  const int t2 = code % g.T2;
  const int ic = code / g.T2;
  const int row = g.ti[tile] + t1;
  const int col = g.tj[tile] + t2;
  const int nb = kp < g.knreal[kb] ? g.n1[row] : 0;
  const int L = g.L, S1 = g.S1, S2 = g.S2;

  double acc[kAC][kSC];
#pragma unroll
  for (int j = 0; j < kAC; ++j)
#pragma unroll
    for (int s = 0; s < kSC; ++s) acc[j][s] = 0.0;

  if (nb > 0) {
    const size_t kq = static_cast<size_t>(col) * g.c + ic;
    const double q = g.p2[kq];
    const double Qx = g.P2[kq * 3], Qy = g.P2[kq * 3 + 1], Qz = g.P2[kq * 3 + 2];
    double R[kMaxH];
    double F[kMaxL + 1];
    for (int ia = 0; ia < nb; ++ia) {
      const size_t bp = static_cast<size_t>(row) * g.a + ia;
      const double p = __ldg(g.p1 + bp);
      const double ps = p + q;
      const double pq = p * q;
      const double inv = 1.0 / (pq * ps);
      const double al = pq * pq * inv;  // pq / (p + q)
      const double px = __ldg(g.P1 + bp * 3) - Qx;
      const double py = __ldg(g.P1 + bp * 3 + 1) - Qy;
      const double pz = __ldg(g.P1 + bp * 3 + 2) - Qz;
      boys_l(L, al * (px * px + py * py + pz * pz), F);
      // base[n] = pref (-2 alpha)^n F_n; R is linear in them, so pref rides along
      double w = 2.0 * kPi * kPi * sqrt(kPi) * (ps * inv) * sqrt(pq * inv);
      for (int n = 0; n <= L; ++n) {
        F[n] *= w;
        w *= -2.0 * al;
      }
      R[0] = F[L];
      for (int n = L - 1; n >= 0; --n) {
        const int maxo = L - n;
        for (int s = g.H - 1; s >= 1; --s) {
          const int st = __ldg(g.steps + s);
          if (((st >> 6) & 15) > maxo) continue;
          const int d = st & 3;
          const double pc = d == 0 ? px : (d == 1 ? py : pz);
          R[s] = fma(pc, R[(st >> 10) & 511], static_cast<double>((st >> 2) & 15) * R[(st >> 19) & 511]);
        }
        R[0] = F[n];
      }
      const double* eb = g.E1 + bp * g.A * S1;
      for (int s1 = 0; s1 < S1; ++s1) {
        double e[kAC];
#pragma unroll
        for (int j = 0; j < kAC; ++j)
          e[j] = alpha0 + j < g.A ? __ldg(eb + static_cast<size_t>(alpha0 + j) * S1 + s1) : 0.0;
        const int* gi = g.gather + s1 * S2 + s20;
#pragma unroll
        for (int s = 0; s < kSC; ++s) {
          if (s20 + s < S2) {
            const double r = R[__ldg(gi + s)];
#pragma unroll
            for (int j = 0; j < kAC; ++j) acc[j][s] = fma(e[j], r, acc[j][s]);
          }
        }
      }
    }
  }

  const size_t plane = static_cast<size_t>(g.T1) * g.T2;
  const size_t cS2 = static_cast<size_t>(g.c) * S2;
  double* o = g.out + (static_cast<size_t>(tile) * g.A * cS2 + static_cast<size_t>(ic) * S2) * plane +
              static_cast<size_t>(t1) * g.T2 + t2;
#pragma unroll
  for (int j = 0; j < kAC; ++j) {
    if (alpha0 + j >= g.A) continue;
    double* oa = o + static_cast<size_t>(alpha0 + j) * cS2 * plane;
#pragma unroll
    for (int s = 0; s < kSC; ++s) {
      if (s20 + s < S2) {
        const double v = acc[j][s];
        oa[static_cast<size_t>(s20 + s) * plane] = __ldg(g.odd + s20 + s) ? -v : v;
      }
    }
  }
}

}  // namespace qchem_eri_highl

// plan: the int32 table of ops/eri_kernel.py::highl_plan(Lb, Lk), the H
// packed recursion steps of L = Lb + Lk, then the (S1, S2) gather, then the
// S2 odd-sign flags.
extern "C" int eri_bra_tiles_highl(int Lb, int Lk, int a, int c, int A, int T1, int T2,
                                   int ntiles, const void* E1, const void* p1, const void* P1,
                                   const void* p2, const void* P2, const void* ti, const void* tj,
                                   const void* n1, const void* korder, const void* knreal,
                                   const void* plan, void* out, void* stream) {
  using namespace qchem_eri_highl;
  if (Lb < 0 || Lk < 0 || Lb > kMaxSide || Lk > kMaxSide || (Lb <= 4 && Lk <= 4) || a <= 0 ||
      c <= 0 || A <= 0 || T1 <= 0 || T2 <= 0 || ntiles <= 0 || n1 == nullptr ||
      korder == nullptr || knreal == nullptr || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.E1 = static_cast<const double*>(E1);
  g.p1 = static_cast<const double*>(p1);
  g.P1 = static_cast<const double*>(P1);
  g.p2 = static_cast<const double*>(p2);
  g.P2 = static_cast<const double*>(P2);
  g.ti = static_cast<const int*>(ti);
  g.tj = static_cast<const int*>(tj);
  g.n1 = static_cast<const int*>(n1);
  g.korder = static_cast<const int*>(korder);
  g.knreal = static_cast<const int*>(knreal);
  g.L = Lb + Lk;
  g.H = nherm(g.L);
  g.S1 = nherm(Lb);
  g.S2 = nherm(Lk);
  g.steps = static_cast<const int*>(plan);
  g.gather = g.steps + g.H;
  g.odd = g.gather + g.S1 * g.S2;
  g.out = static_cast<double*>(out);
  g.a = a;
  g.c = c;
  g.A = A;
  g.T1 = T1;
  g.T2 = T2;
  g.nsc = (g.S2 + kSC - 1) / kSC;
  g.nch = (A + kAC - 1) / kAC * g.nsc;
  g.total = static_cast<long long>(ntiles) * g.nch * T1 * c * T2;
  const long long blocks = (g.total + kThreads - 1) / kThreads;
  eri_bra_tiles_highl_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

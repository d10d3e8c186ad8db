// Kernel 1: bra-contracted ERI tiles for one class pair, in FP64.
//
// Replaces the three Pallas kernels of qchem_rs_tpu/ops/eri_pallas.py
// (_kernel_fused_e1, _kernel_fused, _kernel_htab), which computed the same
// chain in (hi, lo)-f32 arithmetic and split it three ways around VMEM and
// Mosaic's unroll limits.
//
// For tile k (bra pairs ti[k]..ti[k]+T1-1, ket pairs tj[k]..tj[k]+T2-1):
//
//   out[k, alpha, ic*S2+s2, t1, t2] =
//       sum_{ia < n1[row], s1} E1[row, ia, alpha, s1] * sign[s2] * pref * R[idx(s1,s2)]
//
// for ket primitive pairs ic < n2[col] of pair col = tj[k]+t2, and 0.0 for
// the others (their E2 is zero, and the ket contraction after this kernel
// must not meet garbage). R is the Hermite Coulomb table R_tuv(alpha, P - Q)
// of the primitive quartet, built from Boys F_0..F_L by the downward
// recursion of mcmurchie._r_plan; pref = 2 pi^{5/2} / (p q sqrt(p + q)).
//
// What bounds it on the H100: the write of its output (every class pair
// writes (nt, A, c*S2, T1, T2) doubles, 2.9 GB for one benzene/cc-pVDZ
// build), once the arithmetic is only that of real primitive quartets.
// The design:
//
// - Real primitives only. The caller orders each pair's primitive pairs so
//   that those with nonzero E come first and passes their counts (n1 per
//   bra pair; per ket tile block, the list of its real (t2, ic) points
//   first, then the rest). The bra loop stops at n1[row]; a thread whose
//   ket point is not real only writes zeros.
// - One thread owns one (tile, alpha chunk, t1, ket point). Threads of a
//   warp share t1, so the bra loop bound and every bra load (E1, p1, P1)
//   are uniform across the warp; consecutive threads take consecutive ket
//   points (ic-major, then t2), so the final stores coalesce.
// - Sums on chip, one store. The AC*S2 sums of an alpha chunk live in
//   registers over the whole bra loop and are stored once. AC is chosen
//   per class so that they fit (at most 24 doubles, or S2 when S2 is
//   larger); classes with more Cartesian components take several chunks
//   and recompute R per chunk.
// - R on chip, plan at compile time. The kernel is a template on (LB, LK):
//   the recursion and the (s1, s2) gather unroll through integer sequences
//   into constant indices, so R sits in registers (L <= 4) or, for L >= 5,
//   in the thread's own column of shared memory, and no plan is read from
//   device memory.
// - Boys without division in any loop (csrc/boys.cuh, shared with the
//   high-L part).
//
// The 25 instantiations (LB, LK <= 4, every pair class up to (d, d)) are
// built as 25 translation units (KERNEL_PART) by concurrent nvcc processes;
// compiled without KERNEL_PART the file is one whole library. Pair classes
// with LB or LK of 5 or 6 (f-shell pairs) take the runtime-L kernel of
// csrc/eri_tile_highl.cu, with the same contract and output layout.
//
// C interface (bound with ctypes): eri_bra_tiles(...) and eri_boys(...)
// launch on `stream` and return the cudaError_t of the launch; eri_boys
// runs the device Boys function alone, to order 12.

#include <cuda_runtime.h>

#include <utility>

#include "boys.cuh"
#include "eri_plan.cuh"

#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif

namespace qchem_eri {

constexpr int kMaxSide = 4;     // LB, LK <= 4: pair classes up to (d, d)
constexpr int kAccBudget = 24;  // doubles of sums a thread keeps in registers

template <int LB, int LK, int AC, int... S2V>
__device__ __forceinline__ void store_row(double* o, size_t stride, const double (&acc)[nherm(LK)],
                                          std::integer_sequence<int, S2V...>) {
  ((o[S2V * stride] = OddSign<LK, S2V>::v ? -acc[S2V] : acc[S2V]), ...);
}

// ------------------------------------------------------------- the kernel

template <int LB_, int LK_>
struct Cfg {
  static_assert(LB_ <= kMaxSide && LK_ <= kMaxSide, "pair classes up to (d, d)");
  static constexpr int LB = LB_, LK = LK_;
  static constexpr int L = LB + LK;
  static constexpr int H = nherm(L);
  static constexpr bool kSmemR = L >= 5;
  static constexpr int kThreads = kSmemR ? 64 : 128;
  static constexpr int AC = imin(max_pair_comps(LB), imax(1, kAccBudget / nherm(LK)));
  static constexpr size_t kSmem = kSmemR ? sizeof(double) * H * kThreads : 0;
};

struct Args {
  const double* E1;      // (N1, a, A, S1)
  const double* p1;      // (N1, a)
  const double* P1;      // (N1, a, 3)
  const double* p2;      // (N2, c)
  const double* P2;      // (N2, c, 3)
  const int* ti;         // (nt,) bra tile offsets
  const int* tj;         // (nt,) ket tile offsets
  const int* n1;         // (N1,) real bra primitive pairs
  const int* korder;     // (N2 / T2, c*T2) ket points ic*T2 + t2, real first
  const int* knreal;     // (N2 / T2,) real ket points per tile block
  double* out;           // (nt, A, c*S2, T1, T2)
  int a, c, A, T1, T2, nch;
  long long total;       // nt * nch * T1 * c * T2 threads
};

template <class C>
__global__ void __launch_bounds__(C::kThreads) eri_bra_tiles_kernel(const Args g) {
  constexpr int LB = C::LB, LK = C::LK;
  constexpr int L = C::L, S1 = nherm(LB), S2 = nherm(LK), AC = C::AC;
  extern __shared__ double smem[];

  const long long gid = static_cast<long long>(blockIdx.x) * C::kThreads + threadIdx.x;
  if (gid >= g.total) return;
  const int KP = g.c * g.T2;
  const int kp = static_cast<int>(gid % KP);
  long long rest = gid / KP;
  const int t1 = static_cast<int>(rest % g.T1);
  rest /= g.T1;
  const int ch = static_cast<int>(rest % g.nch);
  const long long tile = rest / g.nch;

  const int kb = g.tj[tile] / g.T2;
  const int code = g.korder[static_cast<size_t>(kb) * KP + kp];
  const int t2 = code % g.T2;
  const int ic = code / g.T2;
  const int row = g.ti[tile] + t1;
  const int col = g.tj[tile] + t2;
  const int nb = kp < g.knreal[kb] ? g.n1[row] : 0;
  const int alpha0 = ch * AC;

  double acc[AC][S2];
#pragma unroll
  for (int j = 0; j < AC; ++j)
#pragma unroll
    for (int s = 0; s < S2; ++s) acc[j][s] = 0.0;

  if (nb > 0) {
    const size_t kq = static_cast<size_t>(col) * g.c + ic;
    const double q = g.p2[kq];
    const double Qx = g.P2[kq * 3], Qy = g.P2[kq * 3 + 1], Qz = g.P2[kq * 3 + 2];
    RTab<C::H, C::kSmemR, C::kThreads> R(smem + threadIdx.x);
    for (int ia = 0; ia < nb; ++ia) {
      const size_t bp = static_cast<size_t>(row) * g.a + ia;
      quartet_r<L>(R, __ldg(g.p1 + bp), __ldg(g.P1 + bp * 3), __ldg(g.P1 + bp * 3 + 1),
                    __ldg(g.P1 + bp * 3 + 2), q, Qx, Qy, Qz);
      contract<LB, LK, AC>(acc, g.E1 + bp * g.A * S1, alpha0, g.A, R,
                           std::make_integer_sequence<int, S1>{});
    }
  }

  const size_t plane = static_cast<size_t>(g.T1) * g.T2;
  const size_t cS2 = static_cast<size_t>(g.c) * S2;
  double* o = g.out + (static_cast<size_t>(tile) * g.A * cS2 + static_cast<size_t>(ic) * S2) * plane +
              static_cast<size_t>(t1) * g.T2 + t2;
#pragma unroll
  for (int j = 0; j < AC; ++j) {
    if (alpha0 + j < g.A)
      store_row<LB, LK, AC>(o + static_cast<size_t>(alpha0 + j) * cS2 * plane, plane, acc[j],
                            std::make_integer_sequence<int, S2>{});
  }
}

template <int LB, int LK>
int launch(const Args& g, cudaStream_t stream) {
  using C = Cfg<LB, LK>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(eri_bra_tiles_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (g.total + C::kThreads - 1) / C::kThreads;
  eri_bra_tiles_kernel<C><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- Boys probe kernel

template <int M>
__global__ void boys_probe_kernel(int n, const double* __restrict__ T, double* __restrict__ F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double f[M + 1];
  boys<M>(T[i], f);
#pragma unroll
  for (int m = 0; m <= M; ++m) F[static_cast<size_t>(m) * n + i] = f[m];
}

template <int M>
int launch_boys(int n, const double* T, double* F, cudaStream_t stream) {
  boys_probe_kernel<M><<<(n + 127) / 128, 128, 0, stream>>>(n, T, F);
  return static_cast<int>(cudaGetLastError());
}

// Every (LB, LK) with LB, LK <= kMaxSide. Built in parts, translation unit
// KERNEL_PART = 5 LB + LK instantiates class (LB, LK) alone, and part 0
// also holds the C interface; without KERNEL_PART the one unit holds all.
#define QCHEM_ERI_CLASSES(X)                                                  \
  X(0, 0) X(0, 1) X(0, 2) X(0, 3) X(0, 4) X(1, 0) X(1, 1) X(1, 2) X(1, 3)     \
  X(1, 4) X(2, 0) X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(3, 0) X(3, 1) X(3, 2)     \
  X(3, 3) X(3, 4) X(4, 0) X(4, 1) X(4, 2) X(4, 3) X(4, 4)

#if KERNEL_PART >= 0
#define QCHEM_ERI_EXTERN(lb, lk) extern template int launch<lb, lk>(const Args&, cudaStream_t);
QCHEM_ERI_CLASSES(QCHEM_ERI_EXTERN)
template int launch<KERNEL_PART / 5, KERNEL_PART % 5>(const Args&, cudaStream_t);
#endif

#if KERNEL_PART <= 0
using LaunchFn = int (*)(const Args&, cudaStream_t);
#define QCHEM_ERI_ENTRY(lb, lk) {lb, lk, Cfg<lb, lk>::AC, &launch<lb, lk>},
struct Entry {
  int lb, lk, width;  // width: the alpha-chunk AC of the class
  LaunchFn launch;
};
const Entry kEntries[] = {QCHEM_ERI_CLASSES(QCHEM_ERI_ENTRY)};

const Entry* find(int lb, int lk) {
  for (const Entry& e : kEntries)
    if (e.lb == lb && e.lk == lk) return &e;
  return nullptr;
}

using BoysFn = int (*)(int, const double*, double*, cudaStream_t);
const BoysFn kBoys[kMaxBoys + 1] = {
    &launch_boys<0>, &launch_boys<1>, &launch_boys<2>,  &launch_boys<3>, &launch_boys<4>,
    &launch_boys<5>, &launch_boys<6>, &launch_boys<7>,  &launch_boys<8>, &launch_boys<9>,
    &launch_boys<10>, &launch_boys<11>, &launch_boys<12>};
#endif

}  // namespace qchem_eri

#if KERNEL_PART <= 0
extern "C" int eri_bra_tiles(int Lb, int Lk, int a, int c, int A, int T1, int T2, int ntiles,
                             const void* E1, const void* p1, const void* P1, const void* p2,
                             const void* P2, const void* ti, const void* tj, const void* n1,
                             const void* korder, const void* knreal, void* out, void* stream) {
  const qchem_eri::Entry* e = qchem_eri::find(Lb, Lk);
  if (e == nullptr || a <= 0 || c <= 0 || A <= 0 || T1 <= 0 || T2 <= 0 || ntiles <= 0 ||
      n1 == nullptr || korder == nullptr || knreal == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  qchem_eri::Args g;
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
  g.out = static_cast<double*>(out);
  g.a = a;
  g.c = c;
  g.A = A;
  g.T1 = T1;
  g.T2 = T2;
  g.nch = (A + e->width - 1) / e->width;
  g.total = static_cast<long long>(ntiles) * g.nch * T1 * c * T2;
  return e->launch(g, static_cast<cudaStream_t>(stream));
}

// F_0..F_M at n points T with the kernel's own Boys function: F is (M+1, n).
extern "C" int eri_boys(int M, int n, const void* T, void* F, void* stream) {
  if (M < 0 || M > qchem_eri::kMaxBoys || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return qchem_eri::kBoys[M](n, static_cast<const double*>(T), static_cast<double*>(F),
                             static_cast<cudaStream_t>(stream));
}
#endif

// Kernel 3, high-L part: finished ERI tile values of the integral-direct
// Fock pass, in FP64, for the class pairs that csrc/eri_tile_values.cu is
// not instantiated for: a side LB or LK of 5 or 6 (f-shell pairs such as
// (fd| and (ff|), L = LB + LK <= 12.
//
// Replaces, for these class pairs, tile_vals_pallas
// (qchem_rs_tpu/ops/eri_pallas.py:430) on the JAX direct pass
// (qchem_rs_tpu/ops/fock_stream.py:104-113): the Pallas kernels
// _kernel_fused (:175) and _kernel_htab (:191) with both contractions in
// XLA where L <= 8, and the XLA f64 path (_tile_vals) past L = 8.
//
// Its function, arguments and output are kernel 3's: for tile k (bra pairs
// ti[k]..ti[k]+T1-1, ket pairs tj[k]..tj[k]+T2-1)
//
//   out[k, t1*A + alpha, t2*C + gamma] =
//       sum_{ic < n2[col], s2} sign[s2] E2[col, ic, s2, gamma]
//         * sum_{ia < n1[row], s1} E1[row, ia, alpha, s1] * pref * R[idx(s1, s2)]
//
// with row = ti[k]+t1, col = tj[k]+t2, over the real primitive quartets
// only; a pair with no real primitive pair gives zeros. Boys and the
// prefactor are kernel 3's (reciprocal square roots, boys<M, true>), so a
// direct pass is rounded one way throughout.
//
// Design. L is given at run time (unrolled instantiations past (4, 4) took
// ptxas minutes each and spilled), as in kernel 1's high-L part
// (csrc/eri_tile_highl.cu), whose R build this kernel shares:
// - A block owns one bra pair (tile, t1), a group of G ket pairs of the
//   tile and a chunk of Ah of its alphas, and every real ket point (t2, ic)
//   of those ket pairs: each output is summed by its own block alone, so
//   there is no second pass and no atomic, and a ket pair's values are
//   added over its ket points in ascending ic. The group's ket points are
//   listed ic-major (per-ic masks of the pairs that have one, and offsets).
// - The block walks its ket points in chunks of W. For a chunk it walks the
//   bra primitives in batches; for a batch it holds one R table per (ket
//   point, bra primitive) item in shared memory: one thread per item
//   evaluates Boys, then the whole block builds every item's R level by
//   level (level n reads only level n + 1; two ping-pong buffers). Each R
//   table feeds the bra contraction of every alpha: thread slices of
//   (ket point, s2, 4 alphas) add E1 . R into the chunk's sums W (Ah, S2)
//   per ket point, kept in shared memory over the batches.
// - After the chunk's last bra primitive, the ket contraction: a thread
//   owns 4 alphas x 2 gammas of one ket pair's values in registers and
//   adds sign W . E2 of the chunk's ket points of that pair (a per-pair
//   list in ascending ic), s2 by s2: the 4 W values come as two double2
//   shared-memory loads that a warp's threads share, the 2 E2 values from
//   the ket class's E with its components last, so that the threads of a
//   warp read consecutive addresses. The block's (Ah, G*C) values stay in
//   shared memory over the chunks and are written once, as whole rows.
// - Sides (trans): a class pair may be computed from its ket side and
//   written transposed, as kernel 3 does (ops/eri_kernel.py::swap_sides).
// - Fixed order: every output is summed over ic, then s2, of the sums over
//   ia, then s1, in ascending order whatever the launch shape; two launches
//   on the same inputs give the same bits.
// The launch shape (Ah, G, W, the item capacity NI, the staged bra
// primitives KB, the threads NT) is chosen by
// ops/eri_kernel.py::values_highl_schedule within shared-memory budgets;
// the caller passes the block's shared memory
// (ops/eri_kernel.py::values_highl_smem_bytes), and the launcher refuses a
// count that differs from its own layout's (carve(), smem_bytes()) or
// passes the card's opt-in limit.
//
// What bounds it on the H100: FP64 operations. Its output, the finished
// blocks, is about a twentieth of the bra-contracted tiles that kernel 1's
// high-L part writes for the same class pairs and ket_contract reads back
// (0.567 GB a ferrocene/6-31G* pass); this kernel writes no partial sum to
// device memory. Where the lighter side is the bra (the f-shell pairs are
// the last classes, so the ket side of most class pairs), most operations
// are the ket contraction, A * S2 * C a (bra pair, ket point), on CUDA
// cores at 8 FMAs for three loads; the L + 3 barriers of each batch and
// the level-by-level R build hold it back further.
//
// C interface (bound with ctypes): eri_tile_values_highl(...) launches on
// `stream` and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "boys.cuh"
#include "eri_plan.cuh"

namespace qchem_values_highl {

using qchem_eri::boys;
using qchem_eri::kHalfSqrtPi;
using qchem_eri::kPi;
using qchem_eri::max_pair_comps;
using qchem_eri::nherm;
using qchem_eri::nth_set_bit;

constexpr int kMaxSide = 6;  // LB, LK <= 6: class pairs up to (ff|ff)
constexpr int kMaxL = 2 * kMaxSide;
constexpr int kMaxThreads = 256;
constexpr int kMaxGroup = 32;  // ket pairs of a block at most: a ket point mask is 32 bits
constexpr int kA = 4;          // alphas of one thread's slice of bra sums, and of its values
constexpr int kG = 2;          // gammas of one thread's values

static_assert(kA == 4, "the bra contraction loads a slice's alphas as two double2");
static_assert(kMaxL <= qchem_eri::kMaxBoys, "the Boys function must reach order L");

struct Args {
  const double* E1;  // (N1, a, A, S1)
  const double* p1;  // (N1, a)
  const double* P1;  // (N1, a, 3)
  const double* E2;  // (N2, c, S2, C): the ket class's E, components last
  const double* p2;  // (N2, c)
  const double* P2;  // (N2, c, 3)
  const int* ti;     // (nt,) bra tile offsets
  const int* tj;     // (nt,) ket tile offsets
  const int* n1;     // (N1,) real bra primitive pairs
  const int* n2;     // (N2,) real ket primitive pairs
  const int* plan;   // highl_plan: L+1 level sizes, H steps, S1*S2 gather, S2 odd flags
  double* out;       // (nt, T1*A, T2*C), or with trans (nt, T2*C, T1*A)
  int L, H, H1, S1, S2, a, c, A, C, T1, T2;
  int Ah, nah;      // alphas of a block, and blocks per bra pair along them
  int G, ngroups;   // ket pairs of a block, and blocks per bra pair along them
  int W, NI, KB;    // ket points of a chunk, R items, staged bra primitives
  int trans;
};

// Shared memory of one block, in doubles then ints then shorts (counted
// again, from the same layout, by ops/eri_kernel.py::values_highl_smem_bytes).
struct Smem {
  double *E1s, *R0, *R1, *F, *PC, *acc, *O;
  int *lev, *steps, *odd, *n2s, *off, *jt, *jic, *jnext, *head;
  unsigned* mask;
  short* gat;
};

// alpha rows of the staged E1, padded to whole slices
__host__ __device__ inline int padded_a(int A) { return (A + kA - 1) / kA * kA; }

__host__ __device__ inline long long smem_doubles(const Args& g) {
  return static_cast<long long>(g.KB) * g.S1 * padded_a(g.Ah) +
         static_cast<long long>(padded_a(g.Ah)) * g.S2 * g.W +
         static_cast<long long>(g.H + g.H1 + g.L + 1 + 3) * g.NI +
         static_cast<long long>(g.Ah) * g.G * g.C;
}

__host__ __device__ inline long long smem_bytes(const Args& g) {
  const long long ints = g.L + 1 + g.H + g.S2 + 2 * g.G + 2 * (g.c + 1) + 3 * g.W;
  const long long bytes = 8 * smem_doubles(g) + 4 * ints + 2LL * g.S1 * g.S2;
  return (bytes + 15) / 16 * 16;
}

__device__ inline Smem carve(const Args& g, unsigned char* base) {
  Smem s;
  // first the two arrays read as double2: 16-byte aligned rows
  s.E1s = reinterpret_cast<double*>(base);
  s.acc = s.E1s + static_cast<size_t>(g.KB) * g.S1 * padded_a(g.Ah);
  s.R0 = s.acc + static_cast<size_t>(padded_a(g.Ah)) * g.S2 * g.W;
  s.R1 = s.R0 + static_cast<size_t>(g.H) * g.NI;
  s.F = s.R1 + static_cast<size_t>(g.H1) * g.NI;
  s.PC = s.F + static_cast<size_t>(g.L + 1) * g.NI;
  s.O = s.PC + 3 * static_cast<size_t>(g.NI);
  s.lev = reinterpret_cast<int*>(s.O + static_cast<size_t>(g.Ah) * g.G * g.C);
  s.steps = s.lev + g.L + 1;
  s.odd = s.steps + g.H;
  s.n2s = s.odd + g.S2;
  s.head = s.n2s + g.G;
  s.mask = reinterpret_cast<unsigned*>(s.head + g.G);
  s.off = reinterpret_cast<int*>(s.mask + g.c + 1);
  s.jt = s.off + g.c + 1;
  s.jic = s.jt + g.W;
  s.jnext = s.jic + g.W;
  s.gat = reinterpret_cast<short*>(s.jnext + g.W);
  return s;
}

// F_0..F_L(T) for L in 5..12 (the only orders of this part), kernel 3's form
__device__ __forceinline__ void boys_l(int L, double T, double* F) {
  switch (L) {
    case 5: boys<5, true>(T, F); break;
    case 6: boys<6, true>(T, F); break;
    case 7: boys<7, true>(T, F); break;
    case 8: boys<8, true>(T, F); break;
    case 9: boys<9, true>(T, F); break;
    case 10: boys<10, true>(T, F); break;
    case 11: boys<11, true>(T, F); break;
    case 12: boys<12, true>(T, F); break;
  }
}

// the place in out of value (r, c) of tile `tile`, r = t1*A + alpha and c =
// t2*C + gamma: (nt, T1*A, T2*C), or with trans the caller's (nt, T2*C,
// T1*A), whose bra and ket classes are this launch's ket and bra
__device__ __forceinline__ size_t out_index(const Args& g, long long tile, int r, int c) {
  const size_t rows = static_cast<size_t>(g.T1) * g.A, cols = static_cast<size_t>(g.T2) * g.C;
  return static_cast<size_t>(tile) * rows * cols + (g.trans ? c * rows + r : r * cols + c);
}

__global__ void __launch_bounds__(kMaxThreads) eri_tile_values_highl_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char vh_smem[];
  const Smem s = carve(g, vh_smem);
  const int tid = threadIdx.x, NT = blockDim.x;
  long long b = blockIdx.x;
  const int h = static_cast<int>(b % g.nah);
  b /= g.nah;
  const int grp = static_cast<int>(b % g.ngroups);
  b /= g.ngroups;
  const int t1 = static_cast<int>(b % g.T1);
  const long long tile = b / g.T1;
  const int L = g.L, NI = g.NI, S1 = g.S1, S2 = g.S2, C = g.C, A4 = padded_a(g.Ah);
  const int alpha0 = h * g.Ah;
  const int nal = min(g.Ah, g.A - alpha0);  // alphas of this block
  const int g0 = grp * g.G;
  const int gv = min(g.G, g.T2 - g0);  // ket pairs of this block
  const int OW = gv * C;               // a row of the block's values
  const int row = g.ti[tile] + t1;
  const int colbase = g.tj[tile] + g0;
  const int nb = g.n1[row];

  // the plan, the group's counts, zeroed values
  const int* gsrc = g.plan + L + 1 + g.H;
  for (int i = tid; i < L + 1 + g.H; i += NT) s.lev[i] = __ldg(g.plan + i);  // lev, then steps
  for (int i = tid; i < S1 * S2; i += NT) s.gat[i] = static_cast<short>(__ldg(gsrc + i));
  for (int i = tid; i < S2; i += NT) s.odd[i] = __ldg(gsrc + S1 * S2 + i);
  for (int t = tid; t < gv; t += NT) s.n2s[t] = nb > 0 ? __ldg(g.n2 + colbase + t) : 0;
  for (int o = tid; o < nal * OW; o += NT) s.O[o] = 0.0;
  __syncthreads();
  // ket point k of the group, ic-major: ket primitive ic, the r-th pair of
  // mask[ic] (those with more than ic real primitive pairs), k = off[ic] + r
  int nk = 0;
  for (int t = 0; t < gv; ++t) nk = max(nk, s.n2s[t]);
  for (int ic = tid; ic <= nk; ic += NT) {
    unsigned m = 0;
    int o = 0;
    for (int t = 0; t < gv; ++t) {
      m |= static_cast<unsigned>(s.n2s[t] > ic) << t;
      o += min(s.n2s[t], ic);
    }
    s.mask[ic] = m;
    s.off[ic] = o;
  }
  __syncthreads();
  const int total = s.off[nk];  // real ket points of the group (0 when nb == 0)

  for (int k0 = 0; k0 < total; k0 += g.W) {
    const int nreal = min(g.W, total - k0);
    for (int t = tid; t < gv; t += NT) s.head[t] = -1;
    for (int j = tid; j < nreal; j += NT) {
      const int k = k0 + j;
      int ic = 0;
      while (s.off[ic + 1] <= k) ++ic;
      s.jt[j] = nth_set_bit(s.mask[ic], k - s.off[ic]);
      s.jic[j] = ic;
    }
    // the chunk's bra sums W, (s2, j, alpha), alphas padded to slices
    for (int o = tid; o < S2 * nreal * A4; o += NT) s.acc[o] = 0.0;
    __syncthreads();
    // per ket pair, its ket points in the chunk in ascending ic: head, next
    for (int j = tid; j < nreal; j += NT) {
      const int t = s.jt[j];
      int nx = -1;
      for (int j2 = j + 1; j2 < nreal && nx < 0; ++j2)
        if (s.jt[j2] == t) nx = j2;
      s.jnext[j] = nx;
      bool first = true;
      for (int j2 = 0; j2 < j && first; ++j2) first = s.jt[j2] != t;
      if (first) s.head[t] = j;
    }

    const int kbd = max(1, min(g.KB, NI / nreal));
    for (int ia0 = 0; ia0 < nb; ia0 += kbd) {
      const int nbat = min(kbd, nb - ia0);
      const int items = nbat * nreal;  // item i = ia * nreal + j
      const size_t bp0 = static_cast<size_t>(row) * g.a + ia0;
      const double* esrc = g.E1 + bp0 * g.A * S1;
      // E1s[(ia * S1 + s1) * A4 + alpha]: a slice's kA alphas side by side
      for (int i = tid; i < nbat * S1 * A4; i += NT) {
        const int al = i % A4, r = i / A4;
        const int s1 = r % S1, ia = r / S1;
        s.E1s[i] = al < nal
                       ? __ldg(esrc + (static_cast<size_t>(ia) * g.A + alpha0 + al) * S1 + s1)
                       : 0.0;
      }
      for (int i = tid; i < items; i += NT) {
        const int ia = i / nreal, j = i - ia * nreal;
        const size_t bp = bp0 + ia;
        const size_t kq = static_cast<size_t>(colbase + s.jt[j]) * g.c + s.jic[j];
        const double p = __ldg(g.p1 + bp), q = __ldg(g.p2 + kq);
        const double ps = p + q, pq = p * q;
        const double rq = rsqrt(pq * ps);  // (pq (p + q))^{-1/2}
        const double al = pq * pq * (rq * rq);  // pq / (p + q)
        const double px = __ldg(g.P1 + bp * 3) - __ldg(g.P2 + kq * 3);
        const double py = __ldg(g.P1 + bp * 3 + 1) - __ldg(g.P2 + kq * 3 + 1);
        const double pz = __ldg(g.P1 + bp * 3 + 2) - __ldg(g.P2 + kq * 3 + 2);
        double F[kMaxL + 1];
        boys_l(L, al * (px * px + py * py + pz * pz), F);
        // base[n] = pref (-2 alpha)^n F_n; R is linear in them, so pref rides along
        double w = 4.0 * kPi * kPi * kHalfSqrtPi * rq * rsqrt(pq);
#pragma unroll
        for (int n = 0; n <= kMaxL; ++n) {
          if (n <= L) s.F[n * NI + i] = F[n] * w;
          w *= -2.0 * al;
        }
        s.PC[i] = px;
        s.PC[NI + i] = py;
        s.PC[2 * NI + i] = pz;
      }
      __syncthreads();
      double* top = (L & 1) ? s.R1 : s.R0;
      for (int i = tid; i < items; i += NT) top[i] = s.F[L * NI + i];
      __syncthreads();
      for (int n = L - 1; n >= 0; --n) {
        double* dst = (n & 1) ? s.R1 : s.R0;
        const double* src = (n & 1) ? s.R0 : s.R1;
        // entry w = qd * items + i of the level, w = tid, tid + NT, ...
        const int cnt = s.lev[n], dq = NT / items, di = NT - dq * items;
        int qd = tid / items, i = tid - qd * items;
        while (qd < cnt) {
          if (qd == 0) {
            dst[i] = s.F[n * NI + i];
          } else {
            const int st = s.steps[qd];
            const double pc = s.PC[(st & 3) * NI + i];
            const double cf = static_cast<double>((st >> 2) & 15);
            dst[qd * NI + i] =
                fma(pc, src[((st >> 6) & 511) * NI + i], cf * src[((st >> 15) & 511) * NI + i]);
          }
          qd += dq;
          i += di;
          if (i >= items) {
            i -= items;
            ++qd;
          }
        }
        __syncthreads();
      }
      // bra contraction, slices (ket point, s2, kA alphas), ket points
      // fastest: one R load feeds kA sums
      const int nslice = nreal * S2 * (A4 / kA);
      for (int sl = tid; sl < nslice; sl += NT) {
        const int j = sl % nreal, r = sl / nreal;
        const int s2 = r % S2, a0 = r / S2 * kA;
        double* acc = s.acc + (s2 * nreal + j) * A4 + a0;
        double sum[kA];
#pragma unroll
        for (int u = 0; u < kA; ++u) sum[u] = acc[u];
        for (int ia = 0; ia < nbat; ++ia) {
          const double* e = s.E1s + static_cast<size_t>(ia) * S1 * A4 + a0;
          const double* Ri = s.R0 + ia * nreal + j;
#pragma unroll 4
          for (int s1 = 0; s1 < S1; ++s1) {
            const double rv = Ri[s.gat[s1 * S2 + s2] * NI];
            const double2 e01 = *reinterpret_cast<const double2*>(e + s1 * A4);
            const double2 e23 = *reinterpret_cast<const double2*>(e + s1 * A4 + 2);
            sum[0] = fma(e01.x, rv, sum[0]);
            sum[1] = fma(e01.y, rv, sum[1]);
            sum[2] = fma(e23.x, rv, sum[2]);
            sum[3] = fma(e23.y, rv, sum[3]);
          }
        }
#pragma unroll
        for (int u = 0; u < kA; ++u) acc[u] = sum[u];
      }
      __syncthreads();
    }
    // sign W, exactly
    for (int o = tid; o < S2 * nreal * A4; o += NT)
      if (s.odd[o / (nreal * A4)]) s.acc[o] = -s.acc[o];
    __syncthreads();

    // ket contraction: a thread owns the kA x kG values (alphas a0.., t2,
    // gammas g0..), adds sign W . E2 over the chunk's ket points of t2 in
    // ascending ic, s2 by s2: kA W values (two double2, the same for the
    // threads of a warp), kG E2 values (consecutive for its threads)
    const int ngp = (C + kG - 1) / kG;
    for (int w = tid; w < (A4 / kA) * gv * ngp; w += NT) {
      const int gp = w % ngp, r = w / ngp;
      const int t = r % gv, a0 = r / gv * kA, g0 = gp * kG;
      int j = s.head[t];
      if (j < 0) continue;
      double v[kA][kG];
#pragma unroll
      for (int u = 0; u < kA; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k)
          v[u][k] = a0 + u < nal && g0 + k < C ? s.O[(a0 + u) * OW + t * C + g0 + k] : 0.0;
      const size_t col = static_cast<size_t>(colbase + t);
      do {
        const double* e2 = g.E2 + (col * g.c + s.jic[j]) * S2 * C + g0;
        const double* wj = s.acc + j * A4 + a0;
        for (int s2 = 0; s2 < S2; ++s2) {
          const double2 x01 = *reinterpret_cast<const double2*>(wj + s2 * nreal * A4);
          const double2 x23 = *reinterpret_cast<const double2*>(wj + s2 * nreal * A4 + 2);
          const double x[kA] = {x01.x, x01.y, x23.x, x23.y};
          double e[kG];
#pragma unroll
          for (int k = 0; k < kG; ++k) e[k] = g0 + k < C ? __ldg(e2 + s2 * C + k) : 0.0;
#pragma unroll
          for (int u = 0; u < kA; ++u)
#pragma unroll
            for (int k = 0; k < kG; ++k) v[u][k] = fma(x[u], e[k], v[u][k]);
        }
        j = s.jnext[j];
      } while (j >= 0);
#pragma unroll
      for (int u = 0; u < kA; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k)
          if (a0 + u < nal && g0 + k < C) s.O[(a0 + u) * OW + t * C + g0 + k] = v[u][k];
    }
    __syncthreads();  // the next chunk overwrites the sums and the lists
  }

  // the block's (nal, gv*C) values as whole rows
  for (int o = tid; o < nal * OW; o += NT) {
    const int al = o / OW;
    g.out[out_index(g, tile, t1 * g.A + alpha0 + al, g0 * C + o - al * OW)] = s.O[o];
  }
}

}  // namespace qchem_values_highl

// plan: the int32 table of ops/eri_kernel.py::highl_plan(Lb, Lk); Ah, G, W,
// NI, KB, NT: the launch shape of ops/eri_kernel.py::values_highl_schedule;
// smem: its block's shared memory, ops/eri_kernel.py::values_highl_smem_bytes.
extern "C" int eri_tile_values_highl(int Lb, int Lk, int a, int c, int A, int C, int T1, int T2,
                                     int ntiles, int trans, int Ah, int G, int W, int NI, int KB,
                                     int NT, int smem, const void* E1, const void* p1,
                                     const void* P1, const void* E2, const void* p2,
                                     const void* P2, const void* ti, const void* tj,
                                     const void* n1, const void* n2, const void* plan, void* out,
                                     void* stream) {
  using namespace qchem_values_highl;
  if (Lb < 0 || Lk < 0 || Lb > kMaxSide || Lk > kMaxSide || (Lb <= 4 && Lk <= 4) || a <= 0 ||
      c <= 0 || A <= 0 || C <= 0 || A > max_pair_comps(Lb) || C > max_pair_comps(Lk) ||
      T1 <= 0 || T2 <= 0 || ntiles <= 0 || Ah <= 0 || Ah > A || G <= 0 || G > T2 ||
      G > kMaxGroup || W <= 0 || NI < W || KB <= 0 || NT <= 0 || NT > kMaxThreads || NT % 32 ||
      E1 == nullptr || E2 == nullptr || n1 == nullptr || n2 == nullptr || plan == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.E1 = static_cast<const double*>(E1);
  g.p1 = static_cast<const double*>(p1);
  g.P1 = static_cast<const double*>(P1);
  g.E2 = static_cast<const double*>(E2);
  g.p2 = static_cast<const double*>(p2);
  g.P2 = static_cast<const double*>(P2);
  g.ti = static_cast<const int*>(ti);
  g.tj = static_cast<const int*>(tj);
  g.n1 = static_cast<const int*>(n1);
  g.n2 = static_cast<const int*>(n2);
  g.plan = static_cast<const int*>(plan);
  g.out = static_cast<double*>(out);
  g.L = Lb + Lk;
  g.H = nherm(g.L);
  g.H1 = nherm(g.L - 1);
  g.S1 = nherm(Lb);
  g.S2 = nherm(Lk);
  g.a = a;
  g.c = c;
  g.A = A;
  g.C = C;
  g.T1 = T1;
  g.T2 = T2;
  g.Ah = Ah;
  g.nah = (A + Ah - 1) / Ah;
  g.G = G;
  g.ngroups = (T2 + G - 1) / G;
  g.W = W;
  g.NI = NI;
  g.KB = KB;
  g.trans = trans != 0;
  // the caller's count of the block's shared memory must be the layout's,
  // and fit the card's per-block limit
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(ntiles) * T1 * g.ngroups * g.nah;
  if (smem != smem_bytes(g) || smem > max_smem || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(eri_tile_values_highl_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  eri_tile_values_highl_kernel<<<static_cast<unsigned>(blocks), NT, static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

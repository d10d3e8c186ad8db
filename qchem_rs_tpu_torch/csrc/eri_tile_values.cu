// Kernel 3: finished ERI tile values of the integral-direct Fock pass, in FP64.
//
// Replaces tile_vals_pallas (qchem_rs_tpu/ops/eri_pallas.py:430), the
// function that the JAX direct builder calls per tile
// (qchem_rs_tpu/ops/fock_stream.py:157-170): the Pallas kernels
// _kernel_fused (:175) and _kernel_htab (:191) build the fused R2m table,
// and both Hermite->Cartesian contractions follow in XLA, only because
// Mosaic has no f64. Here the whole chain is one kernel.
//
// For tile k (bra pairs ti[k]..ti[k]+T1-1, ket pairs tj[k]..tj[k]+T2-1):
//
//   out[k, t1*A + alpha, t2*C + gamma] =
//       sum_{ic < n2[col], s2} sign[s2] E2[col, ic, gamma, s2]
//         * sum_{ia < n1[row], s1} E1[row, ia, alpha, s1] * pref * R[idx(s1, s2)]
//
// with row = ti[k]+t1, col = tj[k]+t2 and R the Hermite Coulomb table of
// the primitive quartet (ia, ic) (csrc/eri_plan.cuh::quartet_r). Only the
// real primitive pairs (compacted first, counted by n1 and n2) enter.
// The result is ops/eri_tiled.ket_contract of kernel 1's output, written
// once in the digestion's (nt, T1*A, T2*C) layout.
//
// What bounds it on the H100: FP64 instructions, most of them in Boys and
// the quartet's prefactor for the s- and p-shell class pairs, which hold
// most of the primitive quartets, then the bra contraction; its output,
// the finished blocks, is about a tenth of kernel 1's. Each real primitive
// quartet's R is built once, both contractions run on chip, and no partial
// sum reaches device memory. Two kernels share that contract:
//
// - The row kernel, for class pairs whose alphas all fit one thread (kRow;
//   every R is then used by one thread only): a block owns one bra pair
//   (tile, t1), its threads the real ket points (t2, ic) of the tile's ket
//   block, listed densely in korder (real first, as kernel 1's threads
//   take them), so every thread loops over the same bra primitives with the
//   same bra loads. A thread builds R in registers, adds E1 . R into W (A,
//   S2) and then W . E2 into its ket point's (A, C) values; the block adds
//   each ket pair's values over its ket points in ascending ic (kpos gives
//   their places), in shared memory, and writes whole rows.
// - The shared kernel, for the rest: a block owns (tile, t1) and a group of
//   G2 ket pairs; thread (g, t2) owns the sums of ket pair t2 and alphas
//   g*AC.. (every gamma) in registers. The block's primitive quartets,
//   (ic, ia, current ket pair) in that order, are numbered densely; each
//   round builds NI of them, one per thread, into a (H, NI) table in shared
//   memory (R built in registers for L <= 4, in the thread's column above),
//   and every owner adds the quartets of its ket pair (the bra contraction),
//   then after the last bra primitive of an ic the ket contraction sign W .
//   E2 into its sums. E2 comes pair axis last, so a warp's threads, which
//   take consecutive ket pairs, read it together; the block stages its (A,
//   G2*C) block in shared memory and writes whole rows.
// - Sides (ops/eri_kernel.py::swap_sides): a class pair with d-d ket pairs
//   under a lighter bra is computed from its ket side, the transposed
//   blocks written in place (trans), so the large E rows are the block's
//   bra rows, loaded once, and not each thread's ket rows.
// - Fixed order: every output is summed over ic, then ia, then s1 and s2
//   in ascending order, whatever the launch shape; no atomics, so two
//   launches on the same inputs give the same bits.
// - Compile-time plan. A template on (LB, LK), LB, LK <= 4; AC and kRow are
//   chosen per class so that W, the sums and R (L <= 4) fit the register
//   budget. The 25 instantiations are 25 translation units (KERNEL_PART),
//   built by concurrent nvcc processes.
//
// C interface (bound with ctypes): eri_tile_values(...) launches on
// `stream` and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <utility>

#include "boys.cuh"
#include "eri_plan.cuh"

#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif

namespace qchem_eri_values {

using qchem_eri::contract;
using qchem_eri::imax;
using qchem_eri::imin;
using qchem_eri::max_pair_comps;
using qchem_eri::nherm;
using qchem_eri::nth_set_bit;
using qchem_eri::OddSign;
using qchem_eri::quartet_r;
using qchem_eri::RTab;

constexpr int kMaxSide = 4;      // LB, LK <= 4: pair classes up to (d, d)
constexpr int kThreads = 128;    // threads of a block at most
constexpr int kMaxGroup = 32;    // ket pairs of a block at most (the largest tile edge)
constexpr int kRegBudget = 64;   // doubles a thread keeps: W, its sums and R (L <= 4)
constexpr int kRowBudget = 110;  // the same for the row kernel, every alpha
constexpr int kRBytes = 48 * 1024;  // shared memory for the R tables of a round

template <int LB_, int LK_>
struct Cfg {
  static_assert(LB_ <= kMaxSide && LK_ <= kMaxSide, "pair classes up to (d, d)");
  static constexpr int LB = LB_, LK = LK_;
  static constexpr int L = LB + LK;
  static constexpr int H = nherm(L);
  static constexpr int S1 = nherm(LB), S2 = nherm(LK);
  static constexpr int AMAX = max_pair_comps(LB), CMAX = max_pair_comps(LK);
  static constexpr bool kRegR = L <= 4;  // R of an item in registers while it is used
  // alphas per thread
  static constexpr int AC = imax(1, imin(AMAX, (kRegBudget - (kRegR ? H : 0)) / (CMAX + S2)));
  // R tables per round: a multiple of 32, at least the largest group
  static constexpr int NI = imin(kThreads, imax(kMaxGroup, kRBytes / (8 * H) / 32 * 32));
  // every alpha of a ket point in one thread, R in registers: the row kernel
  static constexpr bool kRow = kRegR && AMAX * (CMAX + S2) + H <= kRowBudget;
};

struct Args {
  const double* E1;   // (N1, a, A, S1)
  const double* p1;   // (N1, a)
  const double* P1;   // (N1, a, 3)
  const double* E2t;  // (c, C, S2, N2): the ket class's E, pair axis last
  const double* p2;   // (N2, c)
  const double* P2;   // (N2, c, 3)
  const int* ti;      // (nt,) bra tile offsets
  const int* tj;      // (nt,) ket tile offsets
  const int* n1;      // (N1,) real bra primitive pairs
  const int* n2;      // (N2,) real ket primitive pairs
  const int* korder;  // (N2/T2, c*T2): per ket tile block its ket points ic*T2 + t2, real first
  const int* knreal;  // (N2/T2,) real ket points per ket tile block
  const int* kpos;    // (N2/T2, c*T2): the place of ket point ic*T2 + t2 in korder
  double* out;        // (nt, T1*A, T2*C)
  int a, c, A, C, T1, T2, N2, ntiles;
  int G2;             // ket pairs of a block
  int ngroups;        // blocks per (tile, t1): ceil(T2 / G2)
  int nch;            // alpha chunks: ceil(A / AC)
  int dbl;            // doubles of dynamic shared memory before the int arrays
  int trans;          // write the transposed blocks (nt, T2*C, T1*A)
};

// the place in out of value (r, c) of tile `tile`, r = t1*A + alpha and c =
// t2*C + gamma: (nt, T1*A, T2*C), or with trans the caller's (nt, T2*C,
// T1*A), whose bra and ket classes are this launch's ket and bra
__device__ __forceinline__ size_t out_index(const Args& g, long long tile, int r, int c) {
  const size_t rows = static_cast<size_t>(g.T1) * g.A, cols = static_cast<size_t>(g.T2) * g.C;
  return static_cast<size_t>(tile) * rows * cols + (g.trans ? c * rows + r : r * cols + c);
}

// W[j][s2] *= sign[s2]
template <int LK, int AC, int... S2V>
__device__ __forceinline__ void apply_sign(double (&W)[AC][nherm(LK)],
                                           std::integer_sequence<int, S2V...>) {
#pragma unroll
  for (int j = 0; j < AC; ++j) ((W[j][S2V] = OddSign<LK, S2V>::v ? -W[j][S2V] : W[j][S2V]), ...);
}

// the ket contraction of one ket primitive: O += sign W . E2[col, ic], with
// e2 = E2t + ic*C*S2*N2 + col
template <int LK, int AC, int CMAX>
__device__ __forceinline__ void ket_add(double (&O)[AC][CMAX], double (&W)[AC][nherm(LK)],
                                        const double* e2, int C, int N2) {
  constexpr int S2 = nherm(LK);
  apply_sign<LK, AC>(W, std::make_integer_sequence<int, S2>{});
#pragma unroll
  for (int s = 0; s < S2; ++s) {
#pragma unroll
    for (int k = 0; k < CMAX; ++k) {
      if (k < C) {
        const double e = __ldg(e2 + static_cast<size_t>(k * S2 + s) * N2);
#pragma unroll
        for (int j = 0; j < AC; ++j) O[j][k] = fma(W[j][s], e, O[j][k]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < AC; ++j)
#pragma unroll
    for (int s = 0; s < S2; ++s) W[j][s] = 0.0;
}

// The shared kernel (notes at the top): R of a round of primitive quartets
// in shared memory, read by every owner of their ket pair.
template <class Cf>
__global__ void __launch_bounds__(kThreads) eri_tile_values_shared_kernel(const Args g) {
  constexpr int LB = Cf::LB, LK = Cf::LK, L = Cf::L, H = Cf::H;
  constexpr int S1 = Cf::S1, S2 = Cf::S2, AC = Cf::AC, CMAX = Cf::CMAX, NI = Cf::NI;
  // R tables (H, NI) (later the (A, G2*C) block), then per ket primitive ic
  // <= c the mask of the current ket pairs and the first item
  extern __shared__ double smem[];
  __shared__ int s_n2[kMaxGroup];  // real ket primitive pairs of the group's pairs

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nround = imin(NI, nthreads);  // items of a round
  const int group = static_cast<int>(blockIdx.x % g.ngroups);
  const long long rest = blockIdx.x / g.ngroups;
  const int t1 = static_cast<int>(rest % g.T1);
  const long long tile = rest / g.T1;
  const int row = g.ti[tile] + t1;
  const int t2base = group * g.G2;
  const int gv = imin(g.G2, g.T2 - t2base);  // ket pairs of this group
  const int colbase = g.tj[tile] + t2base;
  const int nb = g.n1[row];
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + g.dbl);
  int* s_off = reinterpret_cast<int*>(s_mask + g.c + 1);

  if (tid < kMaxGroup) s_n2[tid] = tid < gv && nb > 0 ? g.n2[colbase + tid] : 0;
  __syncthreads();
  int nk = 0;
  for (int t = 0; t < gv; ++t) nk = imax(nk, s_n2[t]);
  // items i = s_off[ic] + ia * ncur(ic) + r: ket primitive ic, bra primitive
  // ia, r-th current ket pair of ic (those with more than ic real primitive
  // pairs, the set bits of s_mask[ic]); s_off[ic] = nb sum_t2 min(n2, ic)
  for (int ic = tid; ic <= nk; ic += nthreads) {
    unsigned m = 0;
    int o = 0;
    for (int t = 0; t < gv; ++t) {
      m |= static_cast<unsigned>(s_n2[t] > ic) << t;
      o += imin(s_n2[t], ic);
    }
    s_mask[ic] = m;
    s_off[ic] = nb * o;
  }
  __syncthreads();
  const int total = s_off[nk];

  // the sums this thread owns: ket pair t2l of the group, alphas alpha0..
  const int t2l = tid % g.G2;
  const int alpha0 = (tid / g.G2) * AC;
  const bool owner = tid / g.G2 < g.nch && t2l < gv;
  const int mine_n2 = owner ? s_n2[t2l] : 0;
  const unsigned below = (1u << t2l) - 1u;
  const double* E1row = g.E1 + static_cast<size_t>(row) * g.a * g.A * S1;
  const double* e2col = g.E2t + colbase + t2l;

  double O[AC][CMAX];
#pragma unroll
  for (int j = 0; j < AC; ++j)
#pragma unroll
    for (int k = 0; k < CMAX; ++k) O[j][k] = 0.0;
  double W[AC][S2];
#pragma unroll
  for (int j = 0; j < AC; ++j)
#pragma unroll
    for (int s = 0; s < S2; ++s) W[j][s] = 0.0;

  // this thread's next item as an owner: (icc, iac) at index idx
  int icc = 0, iac = 0, ncc = 0;
  int idx = 0x7fffffff;
  if (mine_n2 > 0) {
    ncc = __popc(s_mask[0]);
    idx = __popc(s_mask[0] & below);
  }
  int icr = 0;  // the ket primitive of this thread's item in the R phase
  for (int i0 = 0; i0 < total; i0 += nround) {
    const int n = imin(nround, total - i0);
    if (tid < n) {  // R of item i0 + tid, once
      const int i = i0 + tid;
      while (s_off[icr + 1] <= i) ++icr;
      const unsigned m = s_mask[icr];
      const int ncur = __popc(m);
      const int ia = (i - s_off[icr]) / ncur;
      const int r = i - s_off[icr] - ia * ncur;
      const size_t bp = static_cast<size_t>(row) * g.a + ia;
      const size_t kq = static_cast<size_t>(colbase + nth_set_bit(m, r)) * g.c + icr;
      const double p = __ldg(g.p1 + bp), q = __ldg(g.p2 + kq);
      const double Px = __ldg(g.P1 + bp * 3), Py = __ldg(g.P1 + bp * 3 + 1),
                   Pz = __ldg(g.P1 + bp * 3 + 2);
      const double Qx = __ldg(g.P2 + kq * 3), Qy = __ldg(g.P2 + kq * 3 + 1),
                   Qz = __ldg(g.P2 + kq * 3 + 2);
      if constexpr (Cf::kRegR) {
        RTab<H, false, NI> R(nullptr);
        quartet_r<L, true>(R, p, Px, Py, Pz, q, Qx, Qy, Qz);
#pragma unroll
        for (int s = 0; s < H; ++s) smem[s * NI + tid] = R.v[s];
      } else {
        RTab<H, true, NI> R(smem + tid);
        quartet_r<L, true>(R, p, Px, Py, Pz, q, Qx, Qy, Qz);
      }
    }
    __syncthreads();
    // the owner's items of the round, in order: the bra contraction into W,
    // and after the last bra primitive of an ic the ket contraction into O
    while (idx < i0 + n) {
      const int slot = idx - i0;
      const double* eb = E1row + static_cast<size_t>(iac) * g.A * S1;
      if constexpr (Cf::kRegR) {
        RTab<H, false, NI> R(nullptr);
#pragma unroll
        for (int s = 0; s < H; ++s) R.v[s] = smem[s * NI + slot];
        contract<LB, LK, AC>(W, eb, alpha0, g.A, R, std::make_integer_sequence<int, S1>{});
      } else {
        RTab<H, true, NI> R(smem + slot);
        contract<LB, LK, AC>(W, eb, alpha0, g.A, R, std::make_integer_sequence<int, S1>{});
      }
      if (++iac < nb) {
        idx += ncc;
      } else {
        ket_add<LK, AC, CMAX>(O, W, e2col + static_cast<size_t>(icc) * g.C * S2 * g.N2, g.C,
                              g.N2);
        iac = 0;
        if (++icc < mine_n2) {
          ncc = __popc(s_mask[icc]);
          idx = s_off[icc] + __popc(s_mask[icc] & below);
        } else {
          idx = 0x7fffffff;
        }
      }
    }
    __syncthreads();  // the next round overwrites the R tables
  }

  // stage the (A, gv*C) block, then write it as whole rows
  __syncthreads();
  const int rowlen = gv * g.C;
  if (owner) {
#pragma unroll
    for (int j = 0; j < AC; ++j) {
      if (alpha0 + j < g.A) {
        double* so = smem + static_cast<size_t>(alpha0 + j) * rowlen + t2l * g.C;
#pragma unroll
        for (int k = 0; k < CMAX; ++k)
          if (k < g.C) so[k] = O[j][k];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g.A * rowlen; i += nthreads) {
    const int alpha = i / rowlen;
    g.out[out_index(g, tile, t1 * g.A + alpha, t2base * g.C + i - alpha * rowlen)] = smem[i];
  }
}

// The row kernel (notes at the top), for a class pair whose alphas all fit
// one thread with R in registers (kRow). Its threads take the real ket
// points of the block's bra pair a block's worth at a time; thread (t2, e)
// then adds value e of ket pair t2 over the chunk's ket points of t2.
template <class Cf>
__global__ void __launch_bounds__(kThreads) eri_tile_values_row_kernel(const Args g) {
  constexpr int LB = Cf::LB, LK = Cf::LK, L = Cf::L, H = Cf::H;
  constexpr int S1 = Cf::S1, S2 = Cf::S2, AR = Cf::AMAX, CMAX = Cf::CMAX;
  extern __shared__ double smem[];  // ket points' values (NK, A*C), then the sums (T2, A*C)
  __shared__ int s_lo[kMaxGroup], s_hi[kMaxGroup];  // each ket pair's ic in the chunk

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t1 = static_cast<int>(blockIdx.x % g.T1);
  const long long tile = blockIdx.x / g.T1;
  const int row = g.ti[tile] + t1;
  const int tj = g.tj[tile];
  const int kb = tj / g.T2;
  const int KP = g.c * g.T2;
  const int nb = g.n1[row];
  const int nreal = nb > 0 ? g.knreal[kb] : 0;
  const int AC = g.A * g.C;  // values of one pair quartet
  const int* korder = g.korder + static_cast<size_t>(kb) * KP;
  const int* kpos = g.kpos + static_cast<size_t>(kb) * KP;
  double* part = smem;
  double* sums = smem + static_cast<size_t>(nthreads) * AC;
  for (int i = tid; i < g.T2 * AC; i += nthreads) sums[i] = 0.0;
  const double* E1row = g.E1 + static_cast<size_t>(row) * g.a * g.A * S1;
  __syncthreads();

  for (int k0 = 0; k0 < nreal; k0 += nthreads) {
    const int k1 = imin(k0 + nthreads, nreal);
    if (tid < g.T2) s_lo[tid] = s_hi[tid] = 0;
    __syncthreads();
    const int kp = k0 + tid;
    if (kp < k1) {
      const int code = korder[kp];
      const int ic = code / g.T2, t2 = code - ic * g.T2;
      const int col = tj + t2;
      // this chunk's first and last ket point of ket pair t2
      if (ic == 0 || kpos[code - g.T2] < k0) s_lo[t2] = ic;
      if (ic + 1 == g.n2[col] || kpos[code + g.T2] >= k1) s_hi[t2] = ic + 1;
      const size_t kq = static_cast<size_t>(col) * g.c + ic;
      const double q = __ldg(g.p2 + kq);
      const double Qx = __ldg(g.P2 + kq * 3), Qy = __ldg(g.P2 + kq * 3 + 1),
                   Qz = __ldg(g.P2 + kq * 3 + 2);
      double W[AR][S2];
#pragma unroll
      for (int j = 0; j < AR; ++j)
#pragma unroll
        for (int s = 0; s < S2; ++s) W[j][s] = 0.0;
      for (int ia = 0; ia < nb; ++ia) {
        const size_t bp = static_cast<size_t>(row) * g.a + ia;
        RTab<H, false, 1> R(nullptr);
        quartet_r<L, true>(R, __ldg(g.p1 + bp), __ldg(g.P1 + bp * 3), __ldg(g.P1 + bp * 3 + 1),
                     __ldg(g.P1 + bp * 3 + 2), q, Qx, Qy, Qz);
        contract<LB, LK, AR>(W, E1row + static_cast<size_t>(ia) * g.A * S1, 0, g.A, R,
                             std::make_integer_sequence<int, S1>{});
      }
      double O[AR][CMAX];
#pragma unroll
      for (int j = 0; j < AR; ++j)
#pragma unroll
        for (int k = 0; k < CMAX; ++k) O[j][k] = 0.0;
      ket_add<LK, AR, CMAX>(O, W, g.E2t + static_cast<size_t>(ic) * g.C * S2 * g.N2 + col, g.C,
                            g.N2);
      double* mine = part + static_cast<size_t>(tid) * AC;
#pragma unroll
      for (int j = 0; j < AR; ++j) {
        if (j < g.A) {
#pragma unroll
          for (int k = 0; k < CMAX; ++k)
            if (k < g.C) mine[j * g.C + k] = O[j][k];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < g.T2 * AC; i += nthreads) {
      const int t2 = i / AC, e = i - t2 * AC;
      double x = sums[i];
      for (int ic = s_lo[t2]; ic < s_hi[t2]; ++ic) x += part[(kpos[ic * g.T2 + t2] - k0) * AC + e];
      sums[i] = x;
    }
    __syncthreads();
  }

  const int width = g.T2 * g.C;
  for (int i = tid; i < g.A * width; i += nthreads) {
    const int alpha = i / width;
    const int rem = i - alpha * width;
    const int t2 = rem / g.C, k = rem - t2 * g.C;
    g.out[out_index(g, tile, t1 * g.A + alpha, rem)] = sums[t2 * AC + alpha * g.C + k];
  }
}

template <int LB, int LK>
int launch(Args g, int ntiles, cudaStream_t stream) {
  using Cf = Cfg<LB, LK>;
  g.nch = (g.A + Cf::AC - 1) / Cf::AC;
  g.ntiles = ntiles;
  if constexpr (Cf::kRow) {
    const size_t smem = sizeof(double) * static_cast<size_t>(g.A) * g.C * (kThreads + g.T2);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(eri_tile_values_row_kernel<Cf>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    eri_tile_values_row_kernel<Cf><<<static_cast<unsigned>(static_cast<long long>(ntiles) * g.T1),
                                     kThreads, smem, stream>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  int G2 = 1;
  while (2 * G2 <= g.T2 && 2 * G2 <= kMaxGroup && 2 * G2 * g.nch <= kThreads) G2 *= 2;
  g.G2 = G2;
  g.ngroups = (g.T2 + G2 - 1) / G2;
  g.dbl = imax(Cf::NI * Cf::H, g.A * G2 * g.C);
  const size_t smem = sizeof(double) * g.dbl + 2 * sizeof(int) * (g.c + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(eri_tile_values_shared_kernel<Cf>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(ntiles) * g.T1 * g.ngroups;
  const int threads = (G2 * g.nch + 31) / 32 * 32;  // the owners, in whole warps
  eri_tile_values_shared_kernel<Cf><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Every (LB, LK) with LB, LK <= kMaxSide. Built in parts, translation unit
// KERNEL_PART = 5 LB + LK instantiates class (LB, LK) alone, and part 0
// also holds the C interface; without KERNEL_PART the one unit holds all.
#define QCHEM_VALUES_CLASSES(X)                                               \
  X(0, 0) X(0, 1) X(0, 2) X(0, 3) X(0, 4) X(1, 0) X(1, 1) X(1, 2) X(1, 3)     \
  X(1, 4) X(2, 0) X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(3, 0) X(3, 1) X(3, 2)     \
  X(3, 3) X(3, 4) X(4, 0) X(4, 1) X(4, 2) X(4, 3) X(4, 4)

#if KERNEL_PART >= 0
#define QCHEM_VALUES_EXTERN(lb, lk) extern template int launch<lb, lk>(Args, int, cudaStream_t);
QCHEM_VALUES_CLASSES(QCHEM_VALUES_EXTERN)
template int launch<KERNEL_PART / 5, KERNEL_PART % 5>(Args, int, cudaStream_t);
#endif

#if KERNEL_PART <= 0
using LaunchFn = int (*)(Args, int, cudaStream_t);
#define QCHEM_VALUES_ENTRY(lb, lk) {lb, lk, &launch<lb, lk>},
struct Entry {
  int lb, lk;
  LaunchFn launch;
};
const Entry kEntries[] = {QCHEM_VALUES_CLASSES(QCHEM_VALUES_ENTRY)};
#endif

}  // namespace qchem_eri_values

#if KERNEL_PART <= 0
extern "C" int eri_tile_values(int Lb, int Lk, int a, int c, int A, int C, int T1, int T2,
                               int ntiles, int N2, int trans, const void* E1, const void* p1, const void* P1,
                               const void* E2t, const void* p2, const void* P2, const void* ti,
                               const void* tj, const void* n1, const void* n2, const void* korder,
                               const void* knreal, const void* kpos, void* out, void* stream) {
  const qchem_eri_values::Entry* e = nullptr;
  for (const auto& x : qchem_eri_values::kEntries)
    if (x.lb == Lb && x.lk == Lk) e = &x;
  if (e == nullptr || a <= 0 || c <= 0 || A <= 0 || C <= 0 || T1 <= 0 || T2 <= 0 ||
      ntiles <= 0 || N2 <= 0 || n1 == nullptr || n2 == nullptr || korder == nullptr ||
      knreal == nullptr || kpos == nullptr ||
      A > qchem_eri::max_pair_comps(Lb) || C > qchem_eri::max_pair_comps(Lk))
    return static_cast<int>(cudaErrorInvalidValue);
  qchem_eri_values::Args g;
  g.E1 = static_cast<const double*>(E1);
  g.p1 = static_cast<const double*>(p1);
  g.P1 = static_cast<const double*>(P1);
  g.E2t = static_cast<const double*>(E2t);
  g.p2 = static_cast<const double*>(p2);
  g.P2 = static_cast<const double*>(P2);
  g.ti = static_cast<const int*>(ti);
  g.tj = static_cast<const int*>(tj);
  g.n1 = static_cast<const int*>(n1);
  g.n2 = static_cast<const int*>(n2);
  g.korder = static_cast<const int*>(korder);
  g.knreal = static_cast<const int*>(knreal);
  g.kpos = static_cast<const int*>(kpos);
  g.out = static_cast<double*>(out);
  g.a = a;
  g.c = c;
  g.A = A;
  g.C = C;
  g.T1 = T1;
  g.T2 = T2;
  g.N2 = N2;
  g.trans = trans != 0;
  return e->launch(g, ntiles, static_cast<cudaStream_t>(stream));
}
#endif

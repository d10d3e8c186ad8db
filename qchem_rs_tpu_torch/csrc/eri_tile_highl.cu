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
// Design. L is given at run time (fully unrolled instantiations per
// (LB, LK) past (4, 4) took ptxas and NVVM minutes each and spilled), and
// the work is laid out so that no thread runs a long serial chain:
// - A first kernel writes zeros over the whole output (two doubles a
//   store): the entries of ket points that are not real keep them.
// - A block of the main kernel owns one (tile, t1) and a group of W real
//   ket points ("columns"; korder lists them first) of that bra row, so
//   every column shares the row's bra primitives and E1; a group with no
//   real ket point exits at once. The block stages the class pair's plan
//   (ops/eri_kernel.py::highl_plan) in shared memory: the level sizes, the
//   recursion steps with R stored in level order (entries of order <= k
//   first), and the (s1, s2) gather in level-order positions with its signs.
// - The block walks its bra primitives in batches. For a batch it holds one
//   R table per (column, bra primitive) item in shared memory: one thread
//   per item evaluates Boys once, then the whole block builds every item's
//   R level by level (level n reads only level n + 1, so two ping-pong
//   buffers; one __syncthreads per level): L + 1 dependent steps of a few
//   entries per thread, where one thread per quartet took L * H.
// - Each R table serves every output of its column. Thread t owns the
//   slices t, t + NT, ... of (column, s2, kA alphas): one R load feeds kA
//   sums, the slice's E1 values come as two double2 loads from the staged
//   E1 (transposed to [ia][s1][alpha], rows padded to whole slices). The
//   sums stay in shared memory over the batches and are stored once, with
//   the sign, columns fastest.
// - Classes with few blocks (few ket points, T2 = 1) split a column
//   group's bra primitives over nsplit blocks; each writes its partial sums
//   to a buffer of its own and a third kernel adds them in split order. No
//   atomics: two launches on the same inputs give the same bits.
// The schedule (W, the item capacity NI, the staged bra primitives KB, the
// threads NT, nsplit and the primitives per split) is chosen by
// ops/eri_kernel.py::highl_schedule within its shared-memory budgets and
// the card's SM count; the caller passes the block's shared memory
// (highl_smem_bytes), and the launcher refuses a count that differs from
// its own layout's (carve(), smem_bytes()) or passes the card's limit.
//
// What bounds it on the H100: the write of its output (the zeros of ket
// points that are not real are most of it) sets the bound; the kernel is
// held back by the L + 3 barriers of each batch and the latency of the
// level-by-level R build and of the contraction's shared-memory loads, at
// 2-4 blocks per SM; FP64 arithmetic is a small share.
//
// C interface (bound with ctypes): eri_bra_tiles_highl(...) launches on
// `stream` and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <algorithm>

#include "boys.cuh"

namespace qchem_eri_highl {

using qchem_eri::boys;
using qchem_eri::kPi;

constexpr int kMaxSide = 6;  // LB, LK <= 6: pair classes up to (f, f)
constexpr int kMaxL = 2 * kMaxSide;
constexpr int kMaxThreads = 256;
constexpr int kA = 4;  // Cartesian components alpha of one thread's slice of sums

static_assert(kA == 4, "the contraction loads a slice's alphas as two double2");
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
  const int* plan;    // highl_plan: L+1 level sizes, H steps, S1*S2 gather, S2 odd flags
  double* out;        // (nsplit, nt, A, c*S2, T1, T2): out itself when nsplit == 1
  int L, H, H1, S1, S2, a, c, A, T1, T2, KP;
  int W, groups, NI, KB, nsplit, ps;
  long long split_size;  // doubles of one split's output
};

// Shared memory of one block, in doubles then ints then shorts (counted
// again, from the same layout, by ops/eri_kernel.py::highl_smem_parts).
struct Smem {
  double *E1s, *R0, *R1, *F, *PC, *acc;
  int *lev, *steps, *colo, *colq, *odd;
  short* gat;
};

// alpha rows of the staged E1, padded to whole slices
__host__ __device__ inline int padded_a(int A) { return (A + kA - 1) / kA * kA; }

__host__ __device__ inline long long smem_doubles(const Args& g) {
  return static_cast<long long>(g.KB) * g.S1 * padded_a(g.A) +
         static_cast<long long>(g.H + g.H1 + g.L + 1 + 3) * g.NI +
         static_cast<long long>(g.W) * g.A * g.S2;
}

__host__ __device__ inline long long smem_bytes(const Args& g) {
  const long long ints = g.L + 1 + g.H + 2 * g.W + g.S2;
  const long long bytes = 8 * smem_doubles(g) + 4 * ints + 2LL * g.S1 * g.S2;
  return (bytes + 15) / 16 * 16;
}

__device__ inline Smem carve(const Args& g, unsigned char* base) {
  Smem s;
  s.E1s = reinterpret_cast<double*>(base);  // first: 16-byte aligned rows for double2 loads
  s.R0 = s.E1s + static_cast<size_t>(g.KB) * g.S1 * padded_a(g.A);
  s.R1 = s.R0 + static_cast<size_t>(g.H) * g.NI;
  s.F = s.R1 + static_cast<size_t>(g.H1) * g.NI;
  s.PC = s.F + static_cast<size_t>(g.L + 1) * g.NI;
  s.acc = s.PC + 3 * static_cast<size_t>(g.NI);
  s.lev = reinterpret_cast<int*>(s.acc + static_cast<size_t>(g.W) * g.A * g.S2);
  s.steps = s.lev + g.L + 1;
  s.colo = s.steps + g.H;
  s.colq = s.colo + g.W;
  s.odd = s.colq + g.W;
  s.gat = reinterpret_cast<short*>(s.odd + g.S2);
  return s;
}

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

__global__ void __launch_bounds__(kMaxThreads) eri_bra_tiles_highl_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char highl_smem[];
  const Smem s = carve(g, highl_smem);
  const int tid = threadIdx.x, NT = blockDim.x;
  long long b = blockIdx.x;
  const int split = static_cast<int>(b % g.nsplit);
  b /= g.nsplit;
  const int grp = static_cast<int>(b % g.groups);
  b /= g.groups;
  const int t1 = static_cast<int>(b % g.T1);
  const long long tile = b / g.T1;
  const int L = g.L, NI = g.NI, S1 = g.S1, S2 = g.S2, A = g.A, A4 = padded_a(A), W = g.W;
  const int kb = g.tj[tile] / g.T2;
  const int knr = g.knreal[kb];  // real ket points: the first knr of korder's row
  const size_t plane = static_cast<size_t>(g.T1) * g.T2;
  const size_t astride = static_cast<size_t>(g.c) * S2 * plane;
  double* ob = g.out + static_cast<size_t>(split) * g.split_size +
               static_cast<size_t>(tile) * A * g.c * S2 * plane + static_cast<size_t>(t1) * g.T2;

  // a group of W ket points; a group with none real has nothing to do (its
  // zeros are written)
  const int j0 = grp * W;
  const int nreal = max(0, min(min(W, g.KP - j0), knr - j0));
  if (nreal == 0) return;

  // the plan, once per block
  const int* gsrc = g.plan + L + 1 + g.H;
  for (int i = tid; i < L + 1 + g.H; i += NT) s.lev[i] = __ldg(g.plan + i);  // lev, then steps
  for (int i = tid; i < S1 * S2; i += NT) s.gat[i] = static_cast<short>(__ldg(gsrc + i));
  for (int i = tid; i < S2; i += NT) s.odd[i] = __ldg(gsrc + S1 * S2 + i);
  for (int j = tid; j < nreal; j += NT) {
    const int code = __ldg(g.korder + static_cast<size_t>(kb) * g.KP + j0 + j);
    const int t2 = code % g.T2, ic = code / g.T2;
    s.colo[j] = static_cast<int>(static_cast<size_t>(ic) * S2 * plane + t2);
    s.colq[j] = (g.tj[tile] + t2) * g.c + ic;
  }
  const int O = nreal * A * S2;  // sums of the real ket points, (alpha, s2, j), j fastest
  for (int o = tid; o < O; o += NT) s.acc[o] = 0.0;
  __syncthreads();

  const int row = g.ti[tile] + t1;
  const int ia_end = min(g.n1[row], (split + 1) * g.ps);
  const int kbd = max(1, min(g.KB, NI / nreal));
  for (int ia0 = split * g.ps; ia0 < ia_end; ia0 += kbd) {
    const int nbat = min(kbd, ia_end - ia0);
    const int items = nbat * nreal;  // item i = ia * nreal + j
    const size_t bp0 = static_cast<size_t>(row) * g.a + ia0;
    const double* esrc = g.E1 + bp0 * A * S1;
    // E1s[(ia * S1 + s1) * A4 + alpha]: a slice's kA alphas side by side
    for (int i = tid; i < nbat * S1 * A4; i += NT) {
      const int alpha = i % A4, r = i / A4;
      const int s1 = r % S1, ia = r / S1;
      s.E1s[i] = alpha < A ? __ldg(esrc + (static_cast<size_t>(ia) * A + alpha) * S1 + s1) : 0.0;
    }
    for (int i = tid; i < items; i += NT) {
      const int ia = i / nreal, j = i - ia * nreal;
      const size_t bp = bp0 + ia, kq = s.colq[j];
      const double p = __ldg(g.p1 + bp), q = __ldg(g.p2 + kq);
      const double ps = p + q, pq = p * q;
      const double inv = 1.0 / (pq * ps);
      const double al = pq * pq * inv;  // pq / (p + q)
      const double px = __ldg(g.P1 + bp * 3) - __ldg(g.P2 + kq * 3);
      const double py = __ldg(g.P1 + bp * 3 + 1) - __ldg(g.P2 + kq * 3 + 1);
      const double pz = __ldg(g.P1 + bp * 3 + 2) - __ldg(g.P2 + kq * 3 + 2);
      double F[kMaxL + 1];
      boys_l(L, al * (px * px + py * py + pz * pz), F);
      // base[n] = pref (-2 alpha)^n F_n; R is linear in them, so pref rides along
      double w = 2.0 * kPi * kPi * sqrt(kPi) * (ps * inv) * sqrt(pq * inv);
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
          dst[qd * NI + i] = fma(pc, src[((st >> 6) & 511) * NI + i], cf * src[((st >> 15) & 511) * NI + i]);
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
    // slices (column, s2, kA alphas), columns fastest: one R load feeds kA sums
    const int nslice = nreal * S2 * (A4 / kA);
    for (int sl = tid; sl < nslice; sl += NT) {
      const int j = sl % nreal, r = sl / nreal;
      const int s2 = r % S2, a0 = r / S2 * kA;
      const int o0 = (a0 * S2 + s2) * nreal + j, ostep = S2 * nreal;
      double sum[kA];
#pragma unroll
      for (int u = 0; u < kA; ++u) sum[u] = a0 + u < A ? s.acc[o0 + u * ostep] : 0.0;
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
      for (int u = 0; u < kA; ++u)
        if (a0 + u < A) s.acc[o0 + u * ostep] = sum[u];
    }
    __syncthreads();
  }

  // the sums of the real ket points, with their signs, ket points fastest
  for (int o = tid; o < O; o += NT) {
    const int j = o % nreal, r = o / nreal;
    const int s2 = r % S2, alpha = r / S2;
    const double v = s.acc[o];
    ob[alpha * astride + s.colo[j] + s2 * plane] = s.odd[s2] ? -v : v;
  }
}

// out[0..n) = 0.0, two doubles a store (out is 16-byte aligned)
__global__ void highl_zero_kernel(double* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const double2 z = make_double2(0.0, 0.0);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n / 2; i += stride)
    reinterpret_cast<double2*>(out)[i] = z;
  if (blockIdx.x == 0 && threadIdx.x == 0 && (n & 1)) out[n - 1] = 0.0;
}

// out[i] = part[0][i] + part[1][i] + ... in split order
__global__ void highl_reduce_kernel(const double* part, double* out, long long n, int nsplit) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double v = part[i];
  for (int k = 1; k < nsplit; ++k) v += part[k * n + i];
  out[i] = v;
}

}  // namespace qchem_eri_highl

// plan: the int32 table of ops/eri_kernel.py::highl_plan(Lb, Lk); W, NI,
// KB, NT, nsplit, ps: the schedule of ops/eri_kernel.py::highl_schedule;
// smem: its block's shared memory, ops/eri_kernel.py::highl_smem_bytes;
// partials: nsplit * the output's size in doubles when nsplit > 1 (else
// unused).
extern "C" int eri_bra_tiles_highl(int Lb, int Lk, int a, int c, int A, int T1, int T2,
                                   int ntiles, int W, int NI, int KB, int NT, int nsplit, int ps,
                                   int smem,
                                   const void* E1, const void* p1, const void* P1,
                                   const void* p2, const void* P2, const void* ti, const void* tj,
                                   const void* n1, const void* korder, const void* knreal,
                                   const void* plan, void* partials, void* out, void* stream) {
  using namespace qchem_eri_highl;
  if (Lb < 0 || Lk < 0 || Lb > kMaxSide || Lk > kMaxSide || (Lb <= 4 && Lk <= 4) || a <= 0 ||
      c <= 0 || A <= 0 || T1 <= 0 || T2 <= 0 || ntiles <= 0 || W <= 0 || NI < W || KB <= 0 ||
      NT <= 0 || NT > kMaxThreads || NT % 32 || nsplit <= 0 || ps <= 0 ||
      static_cast<long long>(nsplit) * ps < a || (nsplit > 1 && partials == nullptr) ||
      n1 == nullptr || korder == nullptr || knreal == nullptr || plan == nullptr)
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
  g.plan = static_cast<const int*>(plan);
  g.L = Lb + Lk;
  g.H = nherm(g.L);
  g.H1 = nherm(g.L - 1);
  g.S1 = nherm(Lb);
  g.S2 = nherm(Lk);
  g.a = a;
  g.c = c;
  g.A = A;
  g.T1 = T1;
  g.T2 = T2;
  g.W = W;
  g.KP = c * T2;
  g.groups = (g.KP + W - 1) / W;
  g.NI = NI;
  g.KB = KB;
  g.nsplit = nsplit;
  g.ps = ps;
  g.split_size = static_cast<long long>(ntiles) * A * c * g.S2 * T1 * T2;
  g.out = static_cast<double*>(nsplit > 1 ? partials : out);
  // the caller's count of the block's shared memory must be the layout's,
  // and fit the card's per-block limit
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(ntiles) * T1 * g.groups * nsplit;
  if (smem != smem_bytes(g) || smem > max_smem || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(eri_bra_tiles_highl_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // zeros first (every ket point that is not real keeps them), then the sums
  const long long nout = g.split_size * nsplit;
  highl_zero_kernel<<<static_cast<unsigned>(std::min(nout / 2 / 256 + 1, 8192LL)), 256, 0, st>>>(g.out, nout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  eri_bra_tiles_highl_kernel<<<static_cast<unsigned>(blocks), NT, static_cast<size_t>(smem), st>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const long long n = g.split_size;
  highl_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      g.out, static_cast<double*>(out), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2: G = terms @ d for the in-core RHF Fock build, in FP64, reading
// only the block upper triangle of the symmetric terms matrix.
//
// Replaces qchem_rs_tpu/ops/fock_matvec.py::_kernel, the TPU's (hi, lo)-f32
// double-float matvec, which streamed the whole (split) matrix.
//
// What bounds it on the H100: device-memory bandwidth. terms is (m, m)
// f64 (1.66 GB at benzene/cc-pVDZ, m = 14400) for 2 FLOPs per element, and
// a full read cannot beat cuBLAS's GEMV, which is already near the bound.
// terms is symmetric, so the kernel reads each pair of mirrored 64 x 64
// blocks once: an off-diagonal block B at (I, J), J > I, gives
// G_I += B d_J and G_J += B^T d_I; a diagonal block gives G_I += B d_I.
// That halves the bytes (0.83 GB at m = 14400). For a symmetric terms the
// result is terms @ d; in general it is the product with the block upper
// triangle mirrored.
//
// The design:
// - A persistent grid sized from the SM count and the kernel's occupancy.
//   Each warp owns a contiguous share of the row-major list of upper
//   blocks.
// - A warp owns a block whole: lane l holds columns 2l and 2l+1 of every
//   row and reads the block in 4 passes of 16 rows, each pass 32
//   independent 8-byte loads a lane (256 bytes in flight) with
//   ld.global.nc.L1::no_allocate, so the stream of terms does not evict d
//   from L1. 8-byte loads serve every m, odd or even: on the H100 a
//   16-byte-load variant needed more registers, fitted fewer warps on an
//   SM and ran slower.
// - No shared memory and no block barrier in the main kernel: the d slices
//   a warp needs are read through the read-only cache (d_I uniform across
//   the warp, d_J two values a lane), the column sums B^T d_I stay in each
//   lane's registers, and the 16 row sums of a pass are reduced across the
//   warp by a reduce-scatter of shuffles (lane l ends with rows l and
//   32 + l of the block).
// - No atomics. Every block writes its partial sums into slots of its own
//   in a scratch matrix P (nb x m, nb = ceil(m / 64); 26 MB at m = 14400):
//   block (I, J), J > I, writes B^T d_I at P[I, J's columns] and B d_J at
//   P[J, I's columns], the mirrored slot; a diagonal block writes B d_I at
//   P[I, I's columns]. Each slot is written exactly once, so
//   G = sum over K of P[K]. A second kernel adds the nb rows in a fixed
//   order: thread (c, s) of a 32 x 8 block sums rows s, s + 8, s + 16, ...
//   of column c in turn, then slice 0 adds the 8 slices in the order
//   0..7. The order of every add is set by the code and not by the
//   scheduling of blocks, so G repeats bit for bit from run to run. The
//   scratch costs writing and reading 2 nb m doubles (52 MB at m = 14400)
//   beside the 0.83 GB of terms.
//
// C interface (bound with ctypes): fock_matvec(m, terms, d, part, g,
// stream), with part a (ceil(m / 64), m) f64 scratch, launches both
// kernels on `stream` and returns the cudaError_t of the launches.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;       // block edge
constexpr int kPass = 16;    // rows per pass: independent loads a lane keeps in flight
constexpr int kWarps = 4;    // warps per thread block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRedCols = 32;    // columns of a reduce block
constexpr int kRedSlices = 8;   // row slices of a reduce block

__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

// one step of the reduce-scatter of 16 row partials over lane bits 3..0:
// the lane keeps the W partials of its side and adds its partner's
template <int W>
__device__ __forceinline__ void reduce_step(double (&p)[kPass], int lane) {
  const bool up = (lane & W) != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const double send = up ? p[j] : p[j + W];
    const double keep = up ? p[j + W] : p[j];
    p[j] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// pass S over rows I*kB + kPass*S .. + kPass - 1 of block (I, J): column
// sums into cx, cy; the pass's row sums end in rowsum[S / 2] of lanes
// 16 (S % 2) .. 16 (S % 2) + 15, so lane l holds rows l and 32 + l
template <int S>
__device__ __forceinline__ void block_pass(int m, int I, int c0, int lane,
                                           const double* __restrict__ terms,
                                           const double* __restrict__ d, double dJx, double dJy,
                                           double& cx, double& cy, double (&rowsum)[2]) {
  const int r0 = I * kB + S * kPass;
  double2 v[kPass];
#pragma unroll
  for (int k = 0; k < kPass; ++k) {
    const int r = r0 + k;
    const double* src = terms + static_cast<size_t>(r) * m + c0;
    v[k] = make_double2(0.0, 0.0);
    if (r < m && c0 < m) {
      v[k].x = ld_stream(src);
      if (c0 + 1 < m) v[k].y = ld_stream(src + 1);
    }
  }
  double p[kPass];
#pragma unroll
  for (int k = 0; k < kPass; ++k) {
    p[k] = fma(v[k].x, dJx, v[k].y * dJy);
    const int r = r0 + k;
    const double dI = r < m ? __ldg(d + r) : 0.0;
    cx = fma(v[k].x, dI, cx);
    cy = fma(v[k].y, dI, cy);
  }
  // lane l ends with the sum over its half-warp for row k = l & 15, then
  // over the whole warp
  reduce_step<8>(p, lane);
  reduce_step<4>(p, lane);
  reduce_step<2>(p, lane);
  reduce_step<1>(p, lane);
  const double row = p[0] + __shfl_xor_sync(kFull, p[0], 16);
  if ((lane >> 4) == (S & 1)) rowsum[S / 2] = row;
}

__global__ void __launch_bounds__(kWarps * 32)
fock_matvec_kernel(int m, int nb, long long nblocks, const double* __restrict__ terms,
                   const double* __restrict__ d, double* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  long long t = nblocks * warp / nwarps;
  const long long tend = nblocks * (warp + 1) / nwarps;
  if (t >= tend) return;
  // decode t into (I, J) of the row-major upper list: row I holds nb - I blocks
  int I = 0;
  long long rem = t;
  while (rem >= nb - I) {
    rem -= nb - I;
    ++I;
  }
  int J = I + static_cast<int>(rem);

  for (; t < tend; ++t) {
    const int c0 = J * kB + 2 * lane;
    const double dJx = c0 < m ? __ldg(d + c0) : 0.0;
    const double dJy = c0 + 1 < m ? __ldg(d + c0 + 1) : 0.0;
    double cx = 0.0, cy = 0.0;     // (B^T d_I) at columns c0, c0 + 1
    double rowsum[2] = {0.0, 0.0};  // (B d_J) at rows I*kB + lane, I*kB + 32 + lane
    block_pass<0>(m, I, c0, lane, terms, d, dJx, dJy, cx, cy, rowsum);
    block_pass<1>(m, I, c0, lane, terms, d, dJx, dJy, cx, cy, rowsum);
    block_pass<2>(m, I, c0, lane, terms, d, dJx, dJy, cx, cy, rowsum);
    block_pass<3>(m, I, c0, lane, terms, d, dJx, dJy, cx, cy, rowsum);
    if (J != I) {  // G_J += B^T d_I, into row I of P
      double* col = part + static_cast<size_t>(I) * m;
      if (c0 < m) col[c0] = cx;
      if (c0 + 1 < m) col[c0 + 1] = cy;
    }
    double* row = part + static_cast<size_t>(J) * m;  // G_I += B d_J, into row J of P
    const int r = I * kB + lane;
    if (r < m) row[r] = rowsum[0];
    if (r + 32 < m) row[r + 32] = rowsum[1];
    if (++J == nb) {
      ++I;
      J = I;
    }
  }
}

// g[c] = sum over K of part[K, c], K in a fixed order
__global__ void __launch_bounds__(kRedCols * kRedSlices)
fock_matvec_reduce(int m, int nb, const double* __restrict__ part, double* __restrict__ g) {
  __shared__ double slice[kRedSlices][kRedCols];
  const int c = blockIdx.x * kRedCols + threadIdx.x;
  const int s = threadIdx.y;
  double v = 0.0;
  if (c < m) {
#pragma unroll 4
    for (int K = s; K < nb; K += kRedSlices) v += part[static_cast<size_t>(K) * m + c];
  }
  slice[s][threadIdx.x] = v;
  __syncthreads();
  if (s == 0 && c < m) {
    double sum = slice[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kRedSlices; ++k) sum += slice[k][threadIdx.x];
    g[c] = sum;
  }
}

}  // namespace

extern "C" int fock_matvec(int m, const void* terms, const void* d, void* part, void* g,
                           void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int grid = 0;  // persistent grid: resident blocks per SM times SMs
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fock_matvec_kernel,
                                                        kWarps * 32, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int nb = (m + kB - 1) / kB;
  const long long nblocks = static_cast<long long>(nb) * (nb + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fock_matvec_kernel<<<grid, kWarps * 32, 0, s>>>(
      m, nb, nblocks, static_cast<const double*>(terms), static_cast<const double*>(d),
      static_cast<double*>(part));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fock_matvec_reduce<<<(m + kRedCols - 1) / kRedCols, dim3(kRedCols, kRedSlices), 0, s>>>(
      m, nb, static_cast<const double*>(part), static_cast<double*>(g));
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2: G = terms @ d for the in-core RHF Fock build, in FP64.
//
// Replaces qchem_rs_tpu/ops/fock_matvec.py::_kernel, the TPU's (hi, lo)-f32
// double-float matvec. Bound by device-memory bandwidth: every SCF pass
// streams the whole (m, m) terms matrix once (1.66 GB at benzene/cc-pVDZ,
// m = 14400) for 2 FLOPs per 8 bytes. One warp owns one output row and reads
// it front to back with 16-byte loads (8-byte loads when m is odd, so rows
// are not 16-byte aligned), each lane keeping a partial sum; a warp-shuffle
// reduction finishes the row. d is small and stays in cache for all warps.
//
// C interface (bound with ctypes): fock_matvec(m, terms, d, g, stream)
// launches on `stream` and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fock_matvec_kernel(int m, const double* __restrict__ terms,
                   const double* __restrict__ d, double* __restrict__ g) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const double* r = terms + static_cast<size_t>(row) * m;
  double acc = 0.0;
  if ((m & 1) == 0) {
    const double2* r2 = reinterpret_cast<const double2*>(r);
    const double2* d2 = reinterpret_cast<const double2*>(d);
    const int half = m >> 1;
    for (int j = lane; j < half; j += 32) {
      const double2 t = __ldg(r2 + j);
      const double2 x = __ldg(d2 + j);
      acc = fma(t.x, x.x, acc);
      acc = fma(t.y, x.y, acc);
    }
  } else {
    for (int j = lane; j < m; j += 32) acc = fma(__ldg(r + j), __ldg(d + j), acc);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) g[row] = acc;
}

}  // namespace

extern "C" int fock_matvec(int m, const void* terms, const void* d, void* g, void* stream) {
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fock_matvec_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const double*>(terms), static_cast<const double*>(d),
      static_cast<double*>(g));
  return static_cast<int>(cudaGetLastError());
}

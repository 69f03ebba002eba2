// Fused dual projected Gauss-Seidel QP solve for Hopper (sm_90a), one thread
// per lane. Replaces redmax_tpu/pallas_qp.py::_build_kernel; the lane
// arithmetic is in dual_pgs_lane.cuh. Built with nvcc into a shared library
// with a plain C interface and loaded with ctypes (qp_kernel.py): as it
// stands (the shapes the paths run), or with -DPGS_N=n -DPGS_M=m, a unit of
// that one shape, made at its first launch.
#include <cuda_runtime.h>

#include "dual_pgs_lane.cuh"

namespace {

constexpr int kThreads = 32;  // small blocks spread B = 1024 lanes over 32 SMs

template <int N, int M>
__global__ void __launch_bounds__(kThreads)
dual_pgs_kernel(int B, const float* __restrict__ H, const float* __restrict__ f,
                const float* __restrict__ A, const float* __restrict__ b,
                const float* __restrict__ lo, const float* __restrict__ hi, int iters, float reg,
                float* __restrict__ x_out, float* __restrict__ lam_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  qp::dual_pgs_lane<N, M>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
}

template <int N, int M>
cudaError_t launch(int B, const float* H, const float* f, const float* A, const float* b,
                   const float* lo, const float* hi, int iters, float reg, float* x_out,
                   float* lam_out, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  dual_pgs_kernel<N, M><<<blocks, kThreads, 0, stream>>>(B, H, f, A, b, lo, hi, iters, reg,
                                                         x_out, lam_out);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched), or -1 for an (n, m) without an
// instantiation. Every pointer is device memory, struct-of-arrays [P, B].
extern "C" int dual_pgs_launch(int n, int m, int B, const float* H, const float* f,
                               const float* A, const float* b, const float* lo, const float* hi,
                               int iters, float reg, float* x_out, float* lam_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
#if defined(PGS_N) && defined(PGS_M)
  if (n == PGS_N && m == PGS_M)
    return launch<PGS_N, PGS_M>(B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out, s);
#else
  if (n == 6 && m == 12) return launch<6, 12>(B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out, s);
  if (n == 6 && m == 8) return launch<6, 8>(B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out, s);
#endif
  return -1;
}

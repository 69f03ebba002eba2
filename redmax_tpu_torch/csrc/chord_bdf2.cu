// Fused BDF2 chord-Newton solve for Hopper (sm_90a), one thread per lane.
// Replaces redmax_tpu/pallas_step.py::_build_kernel (its K1a and K1c
// branches: constant-S joints, penalty ground contact); the lane arithmetic
// is in chord_bdf2_lane.cuh. Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes (chord_kernel.py).
#include <cuda_runtime.h>

#include "chord_bdf2_lane.cuh"

namespace {

constexpr int kThreads = 32;  // small blocks spread B = 1024 lanes over 32 SMs

template <int N, int NR, bool CONTACTS>
__global__ void __launch_bounds__(kThreads)
chord_bdf2_kernel(int B, const float* __restrict__ x0, const float* __restrict__ q0,
                  const float* __restrict__ qd0, const float* __restrict__ q1,
                  const float* __restrict__ qd1, const float* __restrict__ tau,
                  const int* __restrict__ topo_i, const float* __restrict__ stat_f,
                  chord::ChordConfig cfg, float* __restrict__ x_out,
                  float* __restrict__ hinv_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  chord::chord_bdf2_lane<N, NR, CONTACTS>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                x_out, hinv_out);
}

template <int N, int NR, bool CONTACTS>
cudaError_t launch_kernel(int B, const float* x0, const float* q0, const float* qd0,
                          const float* q1,
                          const float* qd1, const float* tau, const int* topo_i,
                          const float* stat_f, chord::ChordConfig cfg, float* x_out,
                          float* hinv_out, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  chord_bdf2_kernel<N, NR, CONTACTS><<<blocks, kThreads, 0, stream>>>(
      B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, x_out, hinv_out);
  return cudaGetLastError();
}

template <int N, int NR>
cudaError_t launch(bool contacts, int B, const float* x0, const float* q0, const float* qd0,
                   const float* q1, const float* qd1, const float* tau, const int* topo_i,
                   const float* stat_f, chord::ChordConfig cfg, float* x_out, float* hinv_out,
                   cudaStream_t s) {
  if (contacts)
    return launch_kernel<N, NR, true>(B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, x_out,
                                      hinv_out, s);
  return launch_kernel<N, NR, false>(B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, x_out,
                                     hinv_out, s);
}

}  // namespace

// Returns a cudaError_t (0 = launched), or -1 for an (N, NR) without an
// instantiation. ncontacts is the C that topo_i holds (0 selects the build
// without the contact code). Every pointer is device memory; the state
// buffers are struct-of-arrays [NR, B]; topo_i and stat_f end with the ground
// contacts (layouts in chord_bdf2_lane.cuh).
extern "C" int chord_bdf2_launch(int N, int NR, int ncontacts, int B, const float* x0,
                                 const float* q0, const float* qd0, const float* q1,
                                 const float* qd1, const float* tau, const int* topo_i,
                                 const float* stat_f, int fixed_iters, float growth_reject,
                                 float tol_reject, float dx_clamp, float* x_out, float* hinv_out,
                                 void* stream) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (N == 12 && NR == 12)
    return launch<12, 12>(ncontacts > 0, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, x_out,
                          hinv_out, s);
  if (N == 4 && NR == 4)
    return launch<4, 4>(ncontacts > 0, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, x_out,
                        hinv_out, s);
  return -1;
}

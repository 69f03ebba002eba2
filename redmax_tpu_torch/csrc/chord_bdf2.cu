// Fused BDF2 chord-Newton solve for Hopper (sm_90a), one thread per lane.
// Replaces redmax_tpu/pallas_step.py::_build_kernel (its K1a, K1b, K1c, K1d,
// K1e, K1f and K1g branches: constant-S and q-dependent joints; penalty ground
// contact, two-point springs and cables; lane-shared or per-lane physical
// params; the robust solve modes); the lane arithmetic is in
// chord_bdf2_lane.cuh. Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (chord_kernel.py): once as it stands (the
// builds without the q-dependent joints, per-lane params and robust modes),
// once with -DCHORD_QDEP_UNIT (the builds with the q-dependent joints), once
// with -DCHORD_PERLANE_UNIT (the builds with per-lane params) and once with
// -DCHORD_ROBUST_UNIT (the builds with the robust modes), four translation
// units that compile side by side; and, for any other scene, once with
// -DCHORD_ONE -DCHORD_N=n -DCHORD_NR=nr -DCHORD_FEAT=kinds (and, where the
// kinds have them, -DCHORD_MAX_RECORD and -DCHORD_MAX_CABLE_POINTS sized
// from the scene): a unit of that one build, made at its first launch. The
// robust modes branch per thread (one lane each), so a guarded lane's
// trials cost no other lane anything.
#include <cuda_runtime.h>

#include "chord_bdf2_lane.cuh"

namespace {

constexpr int kThreads = 32;  // small blocks spread B = 1024 lanes over 32 SMs

template <int N, int NR, int FEAT>
__global__ void __launch_bounds__(kThreads)
chord_bdf2_kernel(int B, const float* __restrict__ x0, const float* __restrict__ q0,
                  const float* __restrict__ qd0, const float* __restrict__ q1,
                  const float* __restrict__ qd1, const float* __restrict__ tau,
                  const int* __restrict__ topo_i, const float* __restrict__ stat_f,
                  chord::ChordConfig cfg, float* __restrict__ x_out,
                  float* __restrict__ hinv_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  chord::chord_bdf2_lane<N, NR, FEAT>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                      x_out, hinv_out);
}

// The kPerlane builds: the same, with each lane's physical params read from
// its record in lane_f ([P, B], lane-major, so neighbouring threads read
// neighbouring floats).
template <int N, int NR, int FEAT>
__global__ void __launch_bounds__(kThreads)
chord_bdf2_perlane_kernel(int B, const float* __restrict__ x0, const float* __restrict__ q0,
                          const float* __restrict__ qd0, const float* __restrict__ q1,
                          const float* __restrict__ qd1, const float* __restrict__ tau,
                          const int* __restrict__ topo_i, const float* __restrict__ stat_f,
                          const float* __restrict__ lane_f, chord::ChordConfig cfg,
                          float* __restrict__ x_out, float* __restrict__ hinv_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  chord::chord_bdf2_lane<N, NR, FEAT>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                      x_out, hinv_out, lane_f);
}

// The kRobust builds: the same, in the solve mode rc names (guarded,
// guard_last, chord=False), each branch taken per thread.
template <int N, int NR, int FEAT>
__global__ void __launch_bounds__(kThreads)
chord_bdf2_robust_kernel(int B, const float* __restrict__ x0, const float* __restrict__ q0,
                         const float* __restrict__ qd0, const float* __restrict__ q1,
                         const float* __restrict__ qd1, const float* __restrict__ tau,
                         const int* __restrict__ topo_i, const float* __restrict__ stat_f,
                         chord::ChordConfig cfg, chord::RobustConfig rc,
                         float* __restrict__ x_out, float* __restrict__ hinv_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  chord::chord_bdf2_lane_robust<N, NR, FEAT>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f,
                                             cfg, rc, x_out, hinv_out);
}

// The builds with both: the robust modes on each lane's record in lane_f.
template <int N, int NR, int FEAT>
__global__ void __launch_bounds__(kThreads)
chord_bdf2_robust_perlane_kernel(int B, const float* __restrict__ x0,
                                 const float* __restrict__ q0, const float* __restrict__ qd0,
                                 const float* __restrict__ q1, const float* __restrict__ qd1,
                                 const float* __restrict__ tau, const int* __restrict__ topo_i,
                                 const float* __restrict__ stat_f,
                                 const float* __restrict__ lane_f, chord::ChordConfig cfg,
                                 chord::RobustConfig rc, float* __restrict__ x_out,
                                 float* __restrict__ hinv_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  chord::chord_bdf2_lane_robust<N, NR, FEAT>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f,
                                             cfg, rc, x_out, hinv_out, lane_f);
}

template <int N, int NR, int FEAT>
cudaError_t launch_kernel(int B, const float* x0, const float* q0, const float* qd0,
                          const float* q1, const float* qd1, const float* tau, const int* topo_i,
                          const float* stat_f, const float* lane_f, chord::ChordConfig cfg,
                          chord::RobustConfig rc, float* x_out, float* hinv_out,
                          cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if constexpr ((FEAT & chord::kPerlane) != 0 && (FEAT & chord::kRobust) != 0)
    chord_bdf2_robust_perlane_kernel<N, NR, FEAT><<<blocks, kThreads, 0, stream>>>(
        B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, rc, x_out, hinv_out);
  else if constexpr ((FEAT & chord::kPerlane) != 0)
    chord_bdf2_perlane_kernel<N, NR, FEAT><<<blocks, kThreads, 0, stream>>>(
        B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, x_out, hinv_out);
  else if constexpr ((FEAT & chord::kRobust) != 0)
    chord_bdf2_robust_kernel<N, NR, FEAT><<<blocks, kThreads, 0, stream>>>(
        B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, rc, x_out, hinv_out);
  else
    chord_bdf2_kernel<N, NR, FEAT><<<blocks, kThreads, 0, stream>>>(
        B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg, x_out, hinv_out);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched), -1 for an (N, NR, kinds) without an
// instantiation in this unit, -2 for a per-lane record longer than
// kMaxLaneRecord, or -3 for a robust solve mode (guarded, guard_last or
// chord == 0) in a fixed unit without kRobust (a CHORD_ONE unit answers -1
// to kinds other than its own). The counts are those topo_i holds;
// the kinds present (a contact, a spring, a cable, a q-dependent joint:
// qdep != 0, per-lane params: perlane != 0, a robust mode) pick the build, so
// a scene without closures runs the build compiled without any closure code. Every pointer is device memory; the state
// buffers are struct-of-arrays [NR, B]; topo_i and stat_f end with the
// closures, and lane_f (read only where perlane != 0) holds the per-lane
// records (layouts in chord_bdf2_lane.cuh).
extern "C" int chord_bdf2_launch(int N, int NR, int qdep, int perlane, int ncontacts,
                                 int nsprings, int ncables, int ncable_points, int B,
                                 const float* x0, const float* q0, const float* qd0,
                                 const float* q1, const float* qd1, const float* tau,
                                 const int* topo_i, const float* stat_f, const float* lane_f,
                                 int fixed_iters, float growth_reject, float tol_reject,
                                 float dx_clamp, int guarded, int guard_last, int chord_mode,
                                 float* x_out, float* hinv_out, void* stream) {
  using chord::kCables;
  using chord::kContacts;
  using chord::kPerlane;
  using chord::kQdep;
  using chord::kRobust;
  using chord::kSprings;
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const chord::RobustConfig rc{guarded, guard_last, chord_mode};
  const bool robust = guarded != 0 || guard_last != 0 || chord_mode == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
#if !defined(CHORD_ROBUST_UNIT) && !defined(CHORD_ONE)
  if (robust) return -3;
#endif
  if (perlane != 0 && 7 * N + 4 + 13 * ncontacts + 9 * nsprings + 3 * ncable_points +
                              3 * ncables > chord::kMaxLaneRecord)
    return -2;
  const int feat = (ncontacts > 0 ? kContacts : 0) | (nsprings > 0 ? kSprings : 0) |
                   (ncables > 0 ? kCables : 0) | (qdep != 0 ? kQdep : 0) |
                   (perlane != 0 ? kPerlane : 0) | (robust ? kRobust : 0);
#define CHORD_LAUNCH(n, nr, f)                                                                 \
  if (N == n && NR == nr && feat == (f))                                                       \
    return launch_kernel<n, nr, f>(B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, \
                                   rc, x_out, hinv_out, s);
#if defined(CHORD_ONE)
  CHORD_LAUNCH(CHORD_N, CHORD_NR, CHORD_FEAT)
#elif defined(CHORD_QDEP_UNIT)
  CHORD_LAUNCH(6, 12, kQdep)
  CHORD_LAUNCH(4, 12, kQdep)
  CHORD_LAUNCH(1, 6, kQdep)
#elif defined(CHORD_ROBUST_UNIT)
  CHORD_LAUNCH(12, 12, kRobust)
  CHORD_LAUNCH(12, 12, kContacts | kRobust)
#elif defined(CHORD_PERLANE_UNIT)
  CHORD_LAUNCH(12, 12, kContacts | kPerlane)
  CHORD_LAUNCH(12, 12, kSprings | kPerlane)
  CHORD_LAUNCH(4, 3, kCables | kPerlane)
#else
  CHORD_LAUNCH(12, 12, 0)
  CHORD_LAUNCH(12, 12, kContacts)
  CHORD_LAUNCH(4, 4, 0)
  CHORD_LAUNCH(4, 4, kContacts)
  CHORD_LAUNCH(12, 12, kSprings)
  CHORD_LAUNCH(4, 3, kCables)
#endif
#undef CHORD_LAUNCH
  return -1;
}

// Fused BDF2 chord-Newton solve for Hopper (sm_90a), one warp per lane: the
// cooperative design of redmax_tpu/pallas_step.py::_build_kernel's K1a
// (constant-S joints, no closures), K1c (penalty ground contact) and K1d
// (two-point springs) branches, in the unguarded chord mode with lane-shared
// params at the (N, NR) the paths run, (12, 12) and (4, 4) with and without
// contacts, (12, 12) with springs, (4, 3) with a cable (K1e); with per-lane
// params (K1f) at (12, 12) with contacts and with springs and at (4, 3) with
// a cable; and in the robust modes (K1g) at (12, 12) with and without
// contacts. The phases and what bounds the kernel are in
// chord_bdf2_coop.cuh. Built with -DCHORD_ONE -DCHORD_N=n -DCHORD_NR=nr
// -DCHORD_FEAT=kinds -DCOOP_LANES=l (and -DCHORD_MAX_RECORD with per-lane
// params, -DCHORD_MAX_SPRINGS with springs, -DCHORD_MAX_CABLES and
// -DCHORD_MAX_CABLE_POINTS with cables, each sized from the scene), the
// unit holds that one build, with l lanes a block: any other shape and kind
// mix, made at its first launch (the q-dependent joints, K1b, mixed
// closures, a q-dependent joint with closures, per-lane params in a robust
// mode, more springs or cables than the fixed library's records hold).
// The thread-per-lane kernel (chord_bdf2.cu) keeps N or NR above 32 and a
// record that fits no block.
//
// Layout: kLanes lanes a block, lane b on warp b % kLanes of block
// b / kLanes, each warp's record in the block's dynamic shared memory
// (25,792 bytes a lane at (12, 12), so 206,336 a block: above the 48 KB
// that needs no opt-in, under the 227 KB a block may have; a robust build's
// record holds its trials too, a per-lane build's the lane's params, 222,720
// bytes a block with contacts; a spring build's its springs' states and pair
// blocks, 226,176 bytes a block, 229,888 with per-lane params; a spring
// build's G J_s share the storage of the K/D blocks, which no phase reads
// by then, where they fit it, else have a store of their own; a cable
// build's record holds its points, segments and pair blocks with their
// G J_s; a build of several kinds holds the fields of each). A record
// too large for 8 lanes a block runs 4, 2 or 1 (COOP_LANES). At B = 1024 that is 128 blocks of 256 threads on the card's 132
// SMs, one block and 8 warps an SM (1024 lanes need 8 an SM whatever the
// layout). A warp whose lane is past B returns at once; no
// phase waits on another warp (no block-wide barrier). Built with nvcc into
// a shared library with a plain C interface and loaded with ctypes
// (chord_kernel.py); built again with -DCHORD_COOP_PROBE, it also counts
// each phase's cycles (chip_smoke.py's probe phase).
#include <cuda_runtime.h>

#include "chord_bdf2_coop.cuh"

namespace {

#ifdef COOP_LANES
constexpr int kLanes = COOP_LANES;  // lanes (warps) a block
#else
constexpr int kLanes = 8;
#endif
constexpr int kThreads = kLanes * chord::coop::kWarp;

// A phase on one thread of the lane's warp, then the warp's barrier (which
// also orders its shared-memory writes before the next phase's reads).
// (__host__ __device__ like the phases it runs; it runs on the card only.)
// The probe build (-DCHORD_COOP_PROBE) also adds the clock64() cycles from
// the end of the phase before to the end of this one to the phase's sum
// (registers: each call site's phase is a constant).
struct WarpRun {
  int t;
  long long* sums = nullptr;   // [kPhases] cycle sums (probe build)
  long long* since = nullptr;  // the clock at the end of the phase before
  template <class F>
  __host__ __device__ __forceinline__ void operator()(int phase, F&& f) const {
    f(t);
#ifdef __CUDA_ARCH__
    __syncwarp();
#ifdef CHORD_COOP_PROBE
    const long long now = clock64();
    sums[phase] += now - *since;
    *since = now;
#else
    (void)phase;
#endif
#endif
  }
};

template <int N, int NR, int FEAT>
constexpr size_t smem_bytes() {
  return sizeof(chord::coop::LaneOf<N, NR, FEAT>) * kLanes;
}

template <int N, int NR, int FEAT>
__global__ void __launch_bounds__(kThreads, 1)
chord_bdf2_coop_kernel(int B, const float* __restrict__ x0, const float* __restrict__ q0,
                       const float* __restrict__ qd0, const float* __restrict__ q1,
                       const float* __restrict__ qd1, const float* __restrict__ tau,
                       const int* __restrict__ topo_i, const float* __restrict__ stat_f,
                       const float* __restrict__ lane_f, chord::ChordConfig cfg,
                       chord::RobustConfig rc, float* __restrict__ x_out,
                       float* __restrict__ hinv_out, long long* __restrict__ probe) {
  extern __shared__ __align__(16) unsigned char coop_smem[];
  using Lane = chord::coop::LaneOf<N, NR, FEAT>;
  const int warp = threadIdx.x / chord::coop::kWarp;
  const int lane = blockIdx.x * kLanes + warp;
  if (lane >= B) return;
  Lane& L = reinterpret_cast<Lane*>(coop_smem)[warp];
  const int t = static_cast<int>(threadIdx.x) % chord::coop::kWarp;
#ifdef CHORD_COOP_PROBE
  long long sums[chord::coop::kPhases] = {}, since = clock64();
  const WarpRun run{t, sums, &since};
#else
  (void)probe;
  const WarpRun run{t};
#endif
  chord::coop::solve<N, NR, FEAT>(run, L, lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                  x_out, hinv_out, lane_f, rc);
#ifdef CHORD_COOP_PROBE
  if (t == 0)
    for (int k = 0; k < chord::coop::kPhases; ++k)
      probe[static_cast<long long>(lane) * chord::coop::kPhases + k] = sums[k];
#endif
}

template <int N, int NR, int FEAT>
cudaError_t launch_kernel(int B, const float* x0, const float* q0, const float* qd0,
                          const float* q1, const float* qd1, const float* tau, const int* topo_i,
                          const float* stat_f, const float* lane_f, chord::ChordConfig cfg,
                          chord::RobustConfig rc, float* x_out, float* hinv_out,
                          long long* probe, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N, NR, FEAT>();
  const cudaError_t err = cudaFuncSetAttribute(chord_bdf2_coop_kernel<N, NR, FEAT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (B + kLanes - 1) / kLanes;
  chord_bdf2_coop_kernel<N, NR, FEAT><<<blocks, kThreads, smem, stream>>>(
      B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, rc, x_out, hinv_out, probe);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched), -1 for an (N, NR, kinds) without
// an instantiation here, -2 for a per-lane record (7N + 4 + 13 ncontacts +
// 9 nsprings + 3 ncable_points + 3 ncables floats) longer than the build's
// (coop_record_floats), -3 for a robust solve mode (guarded, guard_last or
// chord_mode == 0) in a build without kRobust, -4 for fixed_iters < 1, -5
// for more springs than a kSprings build's record holds (kCoopSprings, the
// build's -DCHORD_MAX_SPRINGS), or -6 for more cables or cable points than
// a kCables build's record holds (kCoopCables, kCoopCablePoints).
// kinds is the build's FEAT bitmask as the wrapper routed it
// (chord_kernel.kinds_of); the counts are those topo_i holds. A kPerlane
// build reads the lane's params from lane_f ([P, B]); a kRobust build runs
// the mode (guarded, guard_last, chord_mode). Every pointer is device
// memory; the state buffers are struct-of-arrays [NR, B], topo_i, stat_f
// and lane_f as chord_bdf2_launch reads them (chord_bdf2_lane.cuh). probe
// ([B, kPhases] int64: each lane's cycles by phase) is written by the probe
// build only; the wrapper's build takes null.
extern "C" int chord_bdf2_coop_launch(int N, int NR, int kinds, int ncontacts, int nsprings,
                                      int ncables, int ncable_points, int B, const float* x0,
                                      const float* q0, const float* qd0,
                                      const float* q1, const float* qd1, const float* tau,
                                      const int* topo_i, const float* stat_f,
                                      const float* lane_f, int fixed_iters,
                                      float growth_reject, float tol_reject, float dx_clamp,
                                      int guarded, int guard_last, int chord_mode, float* x_out,
                                      float* hinv_out, long long* probe, void* stream) {
  using chord::kCables;
  using chord::kContacts;
  using chord::kPerlane;
  using chord::kRobust;
  using chord::kSprings;
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const chord::RobustConfig rc{guarded, guard_last, chord_mode};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int record = 7 * N + 4 + 13 * ncontacts + 9 * nsprings + 3 * ncable_points + 3 * ncables;
  if (B <= 0) return 0;
  if (fixed_iters < 1) return -4;
  if ((kinds & kRobust) == 0 && (guarded != 0 || guard_last != 0 || chord_mode == 0)) return -3;
#define COOP_LAUNCH(n, nr, f)                                                                 \
  if (N == n && NR == nr && kinds == (f)) {                                                   \
    if (((f) & kSprings) != 0 && nsprings > chord::coop::kCoopSprings) return -5;             \
    if (((f) & kCables) != 0 && (ncables > chord::coop::kCoopCables ||                        \
                                 ncable_points > chord::coop::kCoopCablePoints))              \
      return -6;                                                                              \
    if (((f) & kPerlane) != 0 && record > chord::coop::coop_record_floats<n, f>()) return -2; \
    return launch_kernel<n, nr, f>(B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, \
                                   rc, x_out, hinv_out, probe, s);                            \
  }
#if defined(CHORD_ONE)
  COOP_LAUNCH(CHORD_N, CHORD_NR, CHORD_FEAT)
#else
  COOP_LAUNCH(12, 12, 0)
  COOP_LAUNCH(12, 12, kContacts)
  COOP_LAUNCH(4, 4, 0)
  COOP_LAUNCH(4, 4, kContacts)
  COOP_LAUNCH(12, 12, kRobust)
  COOP_LAUNCH(12, 12, kContacts | kRobust)
  COOP_LAUNCH(12, 12, kContacts | kPerlane)
  COOP_LAUNCH(12, 12, kSprings)
  COOP_LAUNCH(12, 12, kSprings | kPerlane)
  COOP_LAUNCH(4, 3, kCables)
  COOP_LAUNCH(4, 3, kCables | kPerlane)
#endif
#undef COOP_LAUNCH
  return -1;
}

// The phases of the probe's slots.
extern "C" int chord_bdf2_coop_phases() { return chord::coop::kPhases; }

extern "C" const char* chord_bdf2_coop_phase_name(int phase) {
  return phase >= 0 && phase < chord::coop::kPhases ? chord::coop::kPhaseNames[phase] : "";
}

// A block's dynamic shared memory at (N, NR) with the kinds feat
// (chord_kernel's bitmask) in bytes, and its lanes a block, of this unit's
// build of them (-1 for a build without an instantiation here).
extern "C" long chord_bdf2_coop_smem_bytes(int N, int NR, int feat) {
  using chord::kCables;
  using chord::kContacts;
  using chord::kPerlane;
  using chord::kRobust;
  using chord::kSprings;
#define COOP_SMEM(n, nr, f) \
  if (N == n && NR == nr && feat == (f)) return static_cast<long>(smem_bytes<n, nr, f>());
#if defined(CHORD_ONE)
  COOP_SMEM(CHORD_N, CHORD_NR, CHORD_FEAT)
#else
  COOP_SMEM(12, 12, 0)
  COOP_SMEM(12, 12, kContacts)
  COOP_SMEM(4, 4, 0)
  COOP_SMEM(4, 4, kContacts)
  COOP_SMEM(12, 12, kRobust)
  COOP_SMEM(12, 12, kContacts | kRobust)
  COOP_SMEM(12, 12, kContacts | kPerlane)
  COOP_SMEM(12, 12, kSprings)
  COOP_SMEM(12, 12, kSprings | kPerlane)
  COOP_SMEM(4, 3, kCables)
  COOP_SMEM(4, 3, kCables | kPerlane)
#endif
#undef COOP_SMEM
  return -1;
}

extern "C" int chord_bdf2_coop_lanes_per_block(int N, int NR, int feat) {
  return chord_bdf2_coop_smem_bytes(N, NR, feat) < 0 ? -1 : kLanes;
}

// Residual VJP of the chord route's adjoint backward for Hopper (sm_90a), one
// warp per lane (the body and what bounds it: residual_vjp.cuh). Replaces no
// TPU kernel: the JAX package's jax.vjp of the op-level residual at
// redmax_tpu/integrators.py:867. One build a shape: -DVJP_N=n -DVJP_NR=nr
// -DVJP_FEAT=kinds (0, or 1 with ground contacts), made at its first launch
// (residual_vjp.py). Layout: kLanes lanes a block (8 where the records fit:
// 27,424 bytes a lane at (12, 12), 219,392 a block; 1 at (32, 32), 147,344
// bytes), lane b on warp b % kLanes of block b / kLanes, each warp's record
// in the block's dynamic shared memory; a warp whose lane is past B returns
// at once, and no phase waits on another warp. Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes.
#include <cuda_runtime.h>

#include "residual_vjp.cuh"

namespace {

constexpr int kN = VJP_N, kNR = VJP_NR, kFeat = VJP_FEAT;
using Lane = chord::vjp::VjpLane<kN, kNR, kFeat>;
constexpr int kLanes = chord::vjp::lanes_per_block<kN, kNR, kFeat>();
static_assert(kLanes > 0, "one lane's record does not fit a block's shared memory");
constexpr int kThreads = kLanes * chord::coop::kWarp;
constexpr size_t kSmem = sizeof(Lane) * kLanes;

// A phase on one thread of the lane's warp, then the warp's barrier (which
// also orders its shared-memory writes before the next phase's reads).
struct WarpRun {
  int t;
  template <class F>
  __host__ __device__ __forceinline__ void operator()(int, F&& f) const {
    f(t);
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

__global__ void __launch_bounds__(kThreads, 1)
residual_vjp_kernel(int B, chord::vjp::Inputs x, const int* __restrict__ topo_i,
                    const float* __restrict__ stat_f, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char vjp_smem[];
  const int warp = threadIdx.x / chord::coop::kWarp;
  const long long lane = static_cast<long long>(blockIdx.x) * kLanes + warp;
  if (lane >= B) return;
  Lane& L = reinterpret_cast<Lane*>(vjp_smem)[warp];
  const WarpRun run{static_cast<int>(threadIdx.x) % chord::coop::kWarp};
  chord::vjp::residual_vjp<kN, kNR, kFeat>(run, L, lane, B, x, topo_i, stat_f, out);
}

}  // namespace

// Returns a cudaError_t (0 = launched), -1 for an (N, NR, kinds) other than
// this build's, -2 for ground contacts (ncontacts, as topo_i holds them) in a
// build without them. Every pointer is device memory but strides: q0, qd0,
// q1, qd1, q2 and xbar [B, NR], element (b, r) of input k at
// ptr[b * strides[2k] + r * strides[2k + 1]] (in floats; a host array of
// 12), hinv (the forward's H^-1, element (b, s, r) at hinv[b * strides[12] +
// s * strides[13] + r * strides[14]]) or null, in which case xbar holds z =
// H^-T xbar already; topo_i and stat_f as chord_bdf2_coop_launch reads them
// (chord_bdf2_lane.cuh); out [5, B, NR], contiguous: the cotangents of tau,
// q0, qd0, q1 and qd1.
extern "C" int residual_vjp_launch(int N, int NR, int kinds, int ncontacts, int B,
                                   const float* q0, const float* qd0, const float* q1,
                                   const float* qd1, const float* q2, const float* xbar,
                                   const float* hinv, const long long* strides,
                                   const int* topo_i, const float* stat_f, float* out,
                                   void* stream) {
  if (N != kN || NR != kNR || kinds != kFeat) return -1;
  if ((kFeat & chord::kContacts) == 0 && ncontacts > 0) return -2;
  if (B <= 0) return 0;
  const float* p[6] = {q2, q0, qd0, q1, qd1, xbar};
  const int order[6] = {4, 0, 1, 2, 3, 5};  // the strides' input of each of p
  chord::vjp::Inputs x{};
  for (int k = 0; k < 6; ++k) {
    x.p[k] = p[k];
    x.sl[k] = strides[2 * order[k]];
    x.sc[k] = strides[2 * order[k] + 1];
  }
  x.hinv = hinv;
  x.hl = strides[12];
  x.hs = strides[13];
  x.hc = strides[14];
  const cudaError_t err = cudaFuncSetAttribute(
      residual_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const int blocks = (B + kLanes - 1) / kLanes;
  residual_vjp_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      B, x, topo_i, stat_f, out);
  return cudaGetLastError();
}

// Fused dual projected Gauss-Seidel QP solve for Hopper (sm_90a), a group
// of threads per lane: the cooperative design of
// redmax_tpu/pallas_qp.py::_build_kernel, at the shapes the paths run,
// (6, 12) and (6, 8), or, with -DPGS_N=n -DPGS_M=m, a unit of that one shape
// (n, m <= 32), made at its first launch. The phases and what bounds the
// kernel are in dual_pgs_coop.cuh. Built with nvcc into a shared library
// with a plain C interface and loaded with ctypes (qp_kernel.py).
//
// Layout: G threads a lane (group_threads: 16 at (6, 12)), lanes_per_block
// lanes a block (8, or 32 / G where that is more, so that a block is whole
// warps; fewer where the records do not fit a block's shared memory), lane
// b on group b % lanes of block b / lanes, each group's record in the
// block's dynamic shared memory. At B = 1024 and (6, 12) that is 128 blocks
// of 128 threads, 512 warps on the card's 132 SMs. Every thread of a warp
// runs every phase: a group whose lane is past B solves lane B - 1 again and
// writes nothing, so that the barriers and shuffles take the whole warp, a
// mask the compiler knows (a mask of the group alone costs each shuffle a
// MATCH and a REDUX on the sweeps' chain).
// The inputs are read as the callers hold them, [B, P] row-major, so the
// wrapper makes no copy; x and lambda are written [B, n] and [B, m].
#include <cuda_runtime.h>

#include "dual_pgs_coop.cuh"

namespace {

constexpr long kSmemPerBlock = 232448;  // dynamic shared memory a block may have on sm_90

// Lanes a block: 8, or 32 / G where that is more (a block is whole warps),
// halved while the records do not fit a block and more than a warp remains.
template <int N, int M>
__host__ __device__ constexpr int lanes_per_block() {
  constexpr long size = sizeof(qp::coop::LaneQP<N, M>);
  constexpr int G = qp::coop::group_threads<N, M>();
  int lanes = G >= 4 ? 8 : 32 / G;
  while (lanes * G > 32 && lanes * size > kSmemPerBlock) lanes /= 2;
  return lanes;
}

template <int N, int M>
constexpr size_t smem_bytes() {
  return sizeof(qp::coop::LaneQP<N, M>) * lanes_per_block<N, M>();
}

// A phase on one thread of the lane's group of G, then the warp's barrier
// (which also orders its shared-memory writes before the next phase's
// reads); local: the phase alone, for a phase on registers; bcast: thread
// src's candidate, by a shuffle within each group of the warp. (__host__
// __device__ like the phases it runs; it runs on the card only.)
template <int G>
struct GroupRun {
  int t;
  template <class F>
  __host__ __device__ __forceinline__ void operator()(int, F&& f) const {
    f(t);
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  template <class F>
  __host__ __device__ __forceinline__ void local(int, F&& f) const {
    f(t);
  }
  template <class R>
  __host__ __device__ __forceinline__ float bcast(const R* regs, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, regs[0].cand, src, G);
#else
    return regs[src].cand;
#endif
  }
  __host__ __device__ __forceinline__ int slot(int) const { return 0; }
};

template <int N, int M>
__global__ void __launch_bounds__(lanes_per_block<N, M>() * qp::coop::group_threads<N, M>())
dual_pgs_coop_kernel(int B, const float* __restrict__ H, const float* __restrict__ f,
                     const float* __restrict__ A, const float* __restrict__ b,
                     const float* __restrict__ lo, const float* __restrict__ hi, int iters,
                     float reg, float* __restrict__ x_out, float* __restrict__ lam_out) {
  constexpr int G = qp::coop::group_threads<N, M>();
  extern __shared__ __align__(16) unsigned char qp_smem[];
  const int group = threadIdx.x / G;
  const int lane = blockIdx.x * lanes_per_block<N, M>() + group;
  const bool live = lane < B;
  auto& L = reinterpret_cast<qp::coop::LaneQP<N, M>*>(qp_smem)[group];
  const GroupRun<G> run{static_cast<int>(threadIdx.x) % G};
  qp::coop::SweepRegs<M> regs;
  qp::coop::solve<N, M>(run, L, &regs, live ? lane : B - 1, H, f, A, b, lo, hi, iters, reg, x_out,
                        lam_out, live);
}

template <int N, int M>
cudaError_t launch(int B, const float* H, const float* f, const float* A, const float* b,
                   const float* lo, const float* hi, int iters, float reg, float* x_out,
                   float* lam_out, cudaStream_t stream) {
  static_assert(N <= 32 && M <= 32, "a lane's group is at most a warp");
  constexpr size_t smem = smem_bytes<N, M>();
  constexpr int lanes = lanes_per_block<N, M>();
  const cudaError_t err = cudaFuncSetAttribute(
      dual_pgs_coop_kernel<N, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (B + lanes - 1) / lanes;
  dual_pgs_coop_kernel<N, M><<<blocks, lanes * qp::coop::group_threads<N, M>(), smem, stream>>>(
      B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

}  // namespace

// Returns a cudaError_t (0 = launched), -1 for an (n, m) without an
// instantiation here, or -6 for an input or output not 16-byte aligned.
// Every pointer is device memory, [B, P] row-major as the callers hold the
// arrays: H [B, n, n], f [B, n], A [B, m, n], b, lo, hi [B, m]; x_out
// [B, n], lam_out [B, m].
extern "C" int dual_pgs_coop_launch(int n, int m, int B, const float* H, const float* f,
                                    const float* A, const float* b, const float* lo,
                                    const float* hi, int iters, float reg, float* x_out,
                                    float* lam_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const void* ptrs[] = {H, f, A, b, lo, hi, x_out, lam_out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return -6;
#if defined(PGS_N) && defined(PGS_M)
  if (n == PGS_N && m == PGS_M)
    return launch<PGS_N, PGS_M>(B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out, s);
#else
  if (n == 6 && m == 12) return launch<6, 12>(B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out, s);
  if (n == 6 && m == 8) return launch<6, 8>(B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out, s);
#endif
  return -1;
}

// The layout of this unit's build of (n, m): threads a lane, lanes a block
// and dynamic shared memory a block in bytes (-1 without an instantiation).
extern "C" long dual_pgs_coop_layout(int n, int m, int what) {
#define QP_LAYOUT(N_, M_)                                                                   \
  if (n == N_ && m == M_)                                                                   \
    return what == 0 ? qp::coop::group_threads<N_, M_>()                                    \
                     : (what == 1 ? lanes_per_block<N_, M_>() : static_cast<long>(smem_bytes<N_, M_>()));
#if defined(PGS_N) && defined(PGS_M)
  QP_LAYOUT(PGS_N, PGS_M)
#else
  QP_LAYOUT(6, 12)
  QP_LAYOUT(6, 8)
#endif
#undef QP_LAYOUT
  return -1;
}

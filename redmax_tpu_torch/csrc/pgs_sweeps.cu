// K3: batched projected Gauss-Seidel sweeps on a given dual (D, r, lo, hi)
// for Hopper (sm_90a), in float and double.
//
// It replaces no Pallas kernel. The JAX package runs these sweeps as
// op-level lax.scan loops: the friction pass of the staggered-projections
// step (redmax_tpu/friction.py:633-642) and qp_pgs's sweeps
// (redmax_tpu/qp.py:77-86), 3000 sweeps each in float64. The port's
// friction step (friction.py) runs them here; the lane arithmetic is in
// pgs_sweeps_lane.cuh. Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (pgs_kernel.py).
//
// What bounds it: inside a lane the iters * m row updates form one
// dependent chain, so the latency of one row update, not the card's rate or
// its memory, sets the time once every lane runs in one wave. Three designs,
// one signature (pgs_kernel.design_of picks between the first two):
// - thread_kernel (design 0): one thread a lane, m = M a template constant
//   (1 up to PGS_THREAD_UP_TO_F32 in float, PGS_THREAD_UP_TO_F64 in double:
//   the widths pgs_kernel.design_of routes to it), 32 lanes a block, the
//   block's D in shared memory with the diagonal set to 0; a row's chain has
//   no shuffle and no branch.
// - warp_kernel (design 1): a warp a lane, K = ceil(m / 32) rows a thread,
//   the K slots of 32 rows unrolled (the owner's register and lane are
//   constants, its step a select), one shuffle a row; the wrapper
//   (pgs_kernel.warp_store) names D's store in shared memory: transposed,
//   or, for a D it finds symmetric (the friction pass's Hf) where that
//   saves a wave, its lower triangle (26,944 bytes a lane at m = 80 in
//   double instead of 52,224, eight lanes an SM, B = 1024 in one wave).
// - div_kernel (design 2): the earlier warp-a-lane design (a division and
//   a branch on the owner a row, the row loop bounded at run time, D
//   transposed in shared memory where it fits, else read from device
//   memory), launched as it was (no carveout set). The wrapper takes it
//   only where warp_kernel holds no store that fits a block or runs out of
//   registers (pgs_kernel.warp_store: double m >= 170 for an unsymmetric
//   D, m > 192 for any), reading D from device memory there; else it is the
//   same-run yardstick (pgs_kernel.launch(..., design="warp_div")).
// This library holds the thread design up to its widths and the warp
// designs for K = 1..4 (m <= 128); a wider m is built at its first launch
// with -DPGS_K=K (pgs_kernel.build_for), which holds the warp designs of
// that K only.
//
// Layouts (row-major, batch-first, as the callers hold them): D [B, m, m],
// r, lo, hi [B, m], active [B] bytes (0 = frozen; null = every lane), lam
// [B, m] out. A frozen lane is not swept and comes out 0.
#include <cuda_runtime.h>

#include <type_traits>

#include "pgs_sweeps_lane.cuh"

#if !defined(PGS_K) && !(defined(PGS_THREAD_UP_TO_F32) && defined(PGS_THREAD_UP_TO_F64))
#error "build with -DPGS_THREAD_UP_TO_F32= and -DPGS_THREAD_UP_TO_F64= (pgs_kernel.BUILD)"
#endif

namespace {

using pgs::kWarp;
constexpr int kThreadLanes = 32;   // lanes (threads) a block of the thread design
constexpr int kDesignThread = 0, kDesignWarp = 1, kDesignDiv = 2;
// the warp design's store of D in shared memory: transposed, or the lower
// triangle of a symmetric D
constexpr int kFullStore = 0, kTriStore = 1;

template <typename T, int M>
__global__ void __launch_bounds__(kThreadLanes)
thread_kernel(int m, int B, const T* __restrict__ D, const T* __restrict__ r,
              const T* __restrict__ lo, const T* __restrict__ hi,
              const unsigned char* __restrict__ active, int iters, T reg, T* __restrict__ lam) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ds = reinterpret_cast<T*>(smem_raw);
  const int lane0 = blockIdx.x * kThreadLanes;
  const int n = B - lane0 < kThreadLanes ? B - lane0 : kThreadLanes;
  const int l = threadIdx.x;
  pgs::thread_load<T, M>(l, kThreadLanes, n, D + static_cast<long>(lane0) * M * M, Ds);
  __syncthreads();
  if (l >= n) return;
  const long off = static_cast<long>(lane0 + l) * M;
  if (active != nullptr && !active[lane0 + l]) {
#pragma unroll
    for (int i = 0; i < M; ++i) lam[off + i] = T(0);
    return;
  }
  pgs::thread_sweeps<T, M>(pgs::BlockStore<T, M>{Ds, kThreadLanes, l}, D + off * M, r + off,
                           lo + off, hi + off, iters, reg, lam + off);
}

// The warp as warp_sweeps's team: this thread's rows, a shuffle from the
// owner, __syncwarp between phases that share memory.
template <typename T, int K>
struct DeviceTeam {
  pgs::WarpRows<T, K> w;
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(static_cast<int>(threadIdx.x), w);
  }
  __device__ __forceinline__ T from(int s) const { return __shfl_sync(0xffffffffu, w.d, s); }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

template <typename T, int K, bool kTri>
__global__ void __launch_bounds__(kWarp)
warp_kernel(int m, int B, const T* __restrict__ D, const T* __restrict__ r,
            const T* __restrict__ lo, const T* __restrict__ hi,
            const unsigned char* __restrict__ active, int iters, T reg, T* __restrict__ lam) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.x;
  const long off = static_cast<long>(lane) * m;
  if (active != nullptr && !active[lane]) {
    for (int i = threadIdx.x; i < m; i += kWarp) lam[off + i] = T(0);
    return;
  }
  T* lam_s = reinterpret_cast<T*>(smem_raw);   // [32 K]
  T* Ds = lam_s + kWarp * K;                   // [store_elems(m, kTri)]
  DeviceTeam<T, K> team;
  pgs::warp_sweeps<T, K, kTri>(team, m, D + off * m, r + off, lo + off, hi + off, iters, reg, Ds,
                               lam_s, lam + off);
}

template <typename T, int K, bool kSharedD>
__global__ void __launch_bounds__(kWarp)
div_kernel(int m, int B, const T* __restrict__ D, const T* __restrict__ r,
           const T* __restrict__ lo, const T* __restrict__ hi,
           const unsigned char* __restrict__ active, int iters, T reg, T* __restrict__ lam_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const long off = static_cast<long>(lane) * m;
  if (active != nullptr && !active[lane]) {
    for (int i = t; i < m; i += kWarp) lam_out[off + i] = T(0);
    return;
  }
  T* lam_s = reinterpret_cast<T*>(smem_raw);   // [m]: lambda, for the refresh
  const T* Dl = D + off * m;
  // Dc(j, c) = D_jc: the transpose in shared memory, or D in device memory
  const T* Dt = Dl;
  long sj = m, sc = 1;
  if (kSharedD) {
    T* Ds = lam_s + m;
    const long mm = static_cast<long>(m) * m;
    for (long k = t; k < mm; k += kWarp) Ds[(k % m) * m + k / m] = Dl[k];
    Dt = Ds;
    sj = 1;
    sc = m;
  }
  T rho[K], lam[K], rv[K], lov[K], hiv[K], dii[K], safe[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + kWarp * k;
    const bool in = j < m;
    lam[k] = T(0);
    rho[k] = T(0);
    rv[k] = in ? r[off + j] : T(0);
    lov[k] = in ? lo[off + j] : T(0);
    hiv[k] = in ? hi[off + j] : T(0);
    dii[k] = in ? Dl[static_cast<long>(j) * m + j] : T(0);
    safe[k] = pgs::safe_diag(dii[k], reg);
  }
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t + kWarp * k < m) lam_s[t + kWarp * k] = lam[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + kWarp * k;
      if (j < m) rho[k] = pgs::refresh_row(m, Dt + j * sj, static_cast<int>(sc), rv[k], lam_s);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int rows = m - kWarp * kk < kWarp ? m - kWarp * kk : kWarp;
      for (int s = 0; s < rows; ++s) {
        const int i = kWarp * kk + s;
        T delta = T(0);
        if (t == s) {
          const T lam_i = pgs::row_update(rho[kk], dii[kk], lam[kk], safe[kk], lov[kk], hiv[kk]);
          delta = lam_i - lam[kk];
          lam[kk] = lam_i;
        }
        delta = __shfl_sync(0xffffffffu, delta, s);
        // column i of D: D_ji for this thread's rows j
        const T* col = Dt + static_cast<long>(i) * sc;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = t + kWarp * k;
          if (j < m) rho[k] -= col[j * sj] * delta;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (t + kWarp * k < m) lam_out[off + t + kWarp * k] = lam[k];
}

// The opt-in shared memory a block may have on this device (227 KB on an
// H100), read once.
int max_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

long div_bytes(int m, int dsize, bool shared_d) {
  const long mm = shared_d ? static_cast<long>(m) * m : 0;
  return (m + mm) * dsize;
}

// A launch: the kernel, threads and lanes a block, dynamic shared memory a
// block, whether D sits in shared memory, whether the kernel asks for the
// largest shared-memory carveout (the earlier design is launched as it was,
// without).
struct Plan {
  const void* fn;
  int threads, lanes;
  long smem;
  bool shared_d, carveout;
};

template <typename T, int M>
bool plan_thread(int m, Plan& p) {
  if constexpr (M == 0) {
    return false;
  } else {
    if (m != M) return plan_thread<T, M - 1>(m, p);
    p = {reinterpret_cast<const void*>(&thread_kernel<T, M>), kThreadLanes, kThreadLanes,
         static_cast<long>(kThreadLanes) * M * M * static_cast<long>(sizeof(T)), true, true};
    return true;
  }
}

template <typename T, int K>
void plan_k(int design, int store, int m, Plan& p) {
  if (design == kDesignWarp) {
    const bool tri = store == kTriStore;
    p = {tri ? reinterpret_cast<const void*>(&warp_kernel<T, K, true>)
             : reinterpret_cast<const void*>(&warp_kernel<T, K, false>),
         kWarp, 1, (kWarp * K + pgs::store_elems(m, tri)) * static_cast<long>(sizeof(T)), true,
         true};
    return;
  }
  const bool shared_d = div_bytes(m, sizeof(T), true) <= max_shared_bytes();
  p = {shared_d ? reinterpret_cast<const void*>(&div_kernel<T, K, true>)
                : reinterpret_cast<const void*>(&div_kernel<T, K, false>),
       kWarp, 1, div_bytes(m, sizeof(T), shared_d), shared_d, false};
}

// The launch of design at m (store: the warp design's store of D, kFullStore
// or kTriStore; the others ignore it); false where this library holds none.
template <typename T>
bool plan(int design, int store, int m, Plan& p) {
  if (m < 1 || design < kDesignThread || design > kDesignDiv) return false;
  if (design == kDesignWarp && store != kFullStore && store != kTriStore) return false;
  if (design == kDesignThread) {
#if defined(PGS_K)
    return false;
#else
    return plan_thread<T, std::is_same<T, float>::value ? PGS_THREAD_UP_TO_F32
                                                        : PGS_THREAD_UP_TO_F64>(m, p);
#endif
  }
  const int K = (m + kWarp - 1) / kWarp;
#if defined(PGS_K)
  if (K != PGS_K) return false;
  plan_k<T, PGS_K>(design, store, m, p);
  return true;
#else
  switch (K) {
    case 1: plan_k<T, 1>(design, store, m, p); return true;
    case 2: plan_k<T, 2>(design, store, m, p); return true;
    case 3: plan_k<T, 3>(design, store, m, p); return true;
    case 4: plan_k<T, 4>(design, store, m, p); return true;
    default: return false;
  }
#endif
}

// Once a kernel: the largest shared-memory carveout where the plan asks for
// it (so that as many blocks fit an SM as their shared memory allows), and
// the opt-in above 48 KB as far as its launches need. A refusal (shared
// memory past the card's opt-in) is returned and cleared, so that it does
// not come back as the next launch's error.
cudaError_t prepare_once(const Plan& p) {
  struct Seen {
    const void* fn;
    long opted;
  };
  static Seen seen[128];
  static int n_seen = 0;
  int k = 0;
  while (k < n_seen && seen[k].fn != p.fn) ++k;
  if (k == n_seen) {
    if (n_seen == 128) return cudaErrorUnknown;
    if (p.carveout) {
      const cudaError_t err = cudaFuncSetAttribute(
          p.fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    seen[n_seen++] = {p.fn, 48 * 1024};
  }
  if (p.smem > seen[k].opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
    seen[k].opted = p.smem;
  }
  return cudaSuccess;
}

cudaError_t prepare(const Plan& p) {
  const cudaError_t err = prepare_once(p);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T>
int launch(int design, int store, int m, int B, const T* D, const T* r, const T* lo,
           const T* hi, const unsigned char* active, int iters, T reg, T* lam, void* stream) {
  Plan p;
  if (!plan<T>(design, store, m, p)) return -1;
  if (B <= 0) return 0;
  cudaError_t err = prepare(p);
  if (err != cudaSuccess) return err;
  void* args[] = {&m, &B, &D, &r, &lo, &hi, &active, &iters, &reg, &lam};
  err = cudaLaunchKernel(p.fn, dim3((B + p.lanes - 1) / p.lanes), dim3(p.threads), args, p.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 = launched), or -1 for a design and m this
// library holds no instantiation of. design: 0 one thread a lane, 1 a warp
// a lane, 2 the earlier warp-a-lane design; store (the warp design's; the
// others ignore it): 0 D transposed in shared memory, 1 the lower triangle
// of a D symmetric bit for bit in shared memory. Every pointer is device
// memory; active may be null.
extern "C" int pgs_sweeps_launch_f32(int design, int store, int m, int B, const float* D,
                                     const float* r, const float* lo, const float* hi,
                                     const unsigned char* active, int iters, float reg,
                                     float* lam, void* stream) {
  return launch<float>(design, store, m, B, D, r, lo, hi, active, iters, reg, lam, stream);
}

extern "C" int pgs_sweeps_launch_f64(int design, int store, int m, int B, const double* D,
                                     const double* r, const double* lo, const double* hi,
                                     const unsigned char* active, int iters, double reg,
                                     double* lam, void* stream) {
  return launch<double>(design, store, m, B, D, r, lo, hi, active, iters, reg, lam, stream);
}

// The layout of a launch of design at m with values of dsize bytes: which =
// 0 the dynamic shared memory a block in bytes, 1 lanes a block, 2 blocks
// an SM can hold (the occupancy calculator, after the kernel's attributes
// are set), 3 whether D is in shared memory, 4 the device's SMs, 5 the
// shared memory a block may opt in to; -1 where this library holds no such
// launch, or the query failed (the launch's shared memory past 5 among
// them).
extern "C" long pgs_sweeps_layout(int design, int store, int m, int dsize, int which) {
  Plan p;
  const bool ok = dsize == 4 ? plan<float>(design, store, m, p)
                             : plan<double>(design, store, m, p);
  if (!ok) return -1;
  switch (which) {
    case 0: return p.smem;
    case 1: return p.lanes;
    case 2: {
      int blocks = 0;
      if (prepare(p) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, p.threads, p.smem) !=
              cudaSuccess)
        return -1;
      return blocks;
    }
    case 3: return p.shared_d ? 1 : 0;
    case 4: {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
      return sms;
    }
    case 5: return max_shared_bytes();
    default: return -1;
  }
}

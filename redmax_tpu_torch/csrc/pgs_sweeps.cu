// K3: batched projected Gauss-Seidel sweeps on a given dual (D, r, lo, hi)
// for Hopper (sm_90a), in float and double, one warp a lane.
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
// its memory, sets the time. The design keeps that chain short: a warp a
// lane, thread t holding rho_j, lambda_j, r_j, lo_j, hi_j and the guarded
// diagonal of its rows j = t, t + 32, ... in registers (K = ceil(m / 32)
// of each); row i's owner computes its new lambda_i, one shuffle hands the
// change delta to the warp, and every thread updates its rho_j -= D_ji delta
// with one FMA a row it holds. At each sweep's start each thread refreshes
// its rho_j = r_j - sum_c D_jc lambda_c from lambda in shared memory. D sits
// in shared memory transposed (row i of the transpose is column i of D, so
// the warp's reads of a column and of a row it refreshes are both
// contiguous) where it fits a block (51,840 bytes at m = 80 in double),
// else it is read from device memory. This library is built for
// K = 1..4 (m <= 128); a wider m is built at its first launch with
// -DPGS_K=K (pgs_kernel.build_for).
//
// Layouts (row-major, batch-first, as the callers hold them): D [B, m, m],
// r, lo, hi [B, m], active [B] bytes (0 = frozen; null = every lane), lam
// [B, m] out. A frozen lane is not swept (its warp exits at once) and comes
// out 0.
#include <cuda_runtime.h>

#include "pgs_sweeps_lane.cuh"

namespace {

constexpr int kWarp = 32;

template <typename T, int K, bool kSharedD>
__global__ void __launch_bounds__(kWarp)
pgs_sweeps_kernel(int m, const T* __restrict__ D, const T* __restrict__ r,
                  const T* __restrict__ lo, const T* __restrict__ hi,
                  const unsigned char* __restrict__ active, int iters, T reg,
                  T* __restrict__ lam_out) {
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

long lane_bytes(int m, int dsize, bool shared_d) {
  const long mm = shared_d ? static_cast<long>(m) * m : 0;
  return (m + mm) * dsize;
}

bool takes_shared_d(int m, int dsize) { return lane_bytes(m, dsize, true) <= max_shared_bytes(); }

template <typename T, int K, bool kSharedD>
cudaError_t launch(int m, int B, const T* D, const T* r, const T* lo, const T* hi,
                   const unsigned char* active, int iters, T reg, T* lam, cudaStream_t s) {
  const long bytes = lane_bytes(m, sizeof(T), kSharedD);
  static long opted = 48 * 1024;  // the most this instantiation was opted in to
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        pgs_sweeps_kernel<T, K, kSharedD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted = bytes;
  }
  pgs_sweeps_kernel<T, K, kSharedD><<<B, kWarp, bytes, s>>>(m, D, r, lo, hi, active, iters,
                                                            reg, lam);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_k(int m, int B, const T* D, const T* r, const T* lo, const T* hi,
                     const unsigned char* active, int iters, T reg, T* lam, cudaStream_t s) {
  if (takes_shared_d(m, sizeof(T)))
    return launch<T, K, true>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
  return launch<T, K, false>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
}

template <typename T>
int dispatch(int m, int B, const T* D, const T* r, const T* lo, const T* hi,
             const unsigned char* active, int iters, T reg, T* lam, void* stream) {
  if (m < 1) return -1;
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (m + kWarp - 1) / kWarp;
#if defined(PGS_K)
  if (K == PGS_K) return launch_k<T, PGS_K>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
#else
  if (K == 1) return launch_k<T, 1>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
  if (K == 2) return launch_k<T, 2>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
  if (K == 3) return launch_k<T, 3>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
  if (K == 4) return launch_k<T, 4>(m, B, D, r, lo, hi, active, iters, reg, lam, s);
#endif
  return -1;
}

}  // namespace

// Each returns a cudaError_t (0 = launched), or -1 for an m this library
// holds no instantiation of (m < 1, or ceil(m / 32) not built). Every
// pointer is device memory; active may be null.
extern "C" int pgs_sweeps_launch_f32(int m, int B, const float* D, const float* r,
                                     const float* lo, const float* hi,
                                     const unsigned char* active, int iters, float reg,
                                     float* lam, void* stream) {
  return dispatch<float>(m, B, D, r, lo, hi, active, iters, reg, lam, stream);
}

extern "C" int pgs_sweeps_launch_f64(int m, int B, const double* D, const double* r,
                                     const double* lo, const double* hi,
                                     const unsigned char* active, int iters, double reg,
                                     double* lam, void* stream) {
  return dispatch<double>(m, B, D, r, lo, hi, active, iters, reg, lam, stream);
}

// The layout a launch at m takes for values of dsize bytes: which = 0 the
// dynamic shared memory a block (one lane) in bytes, 1 whether D is in it.
extern "C" long pgs_sweeps_layout(int m, int dsize, int which) {
  const bool shared_d = takes_shared_d(m, dsize);
  return which == 0 ? lane_bytes(m, dsize, shared_d) : static_cast<long>(shared_d);
}
